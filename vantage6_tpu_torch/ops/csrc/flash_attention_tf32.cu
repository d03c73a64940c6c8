// Flash-attention forward in f32 on the tensor cores of NVIDIA Hopper
// (sm_90a): mma.sync TF32, three passes per product.
//
// Replaces the Pallas TPU kernel vantage6_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_forward through pl.pallas_call) for f32 inputs at head
// dims 8, 16, 32, 64 and 128. It computes the same function: online-softmax
// attention over [B*H, T, D] with causal masking by global position
// (q_offset + row >= k_offset + col), padded keys masked against
// k_valid = Tk, masked scores giving p = 0 exactly (the TPU kernel's -1e30;
// -inf here), the running max floored at -1e20, m, l and acc in f32, p kept
// in f32 (v is f32, so the TPU kernel's cast of p to v's dtype rounds
// nothing), and the output acc / (l > 0 ? l : 1), so fully masked rows are
// exactly 0. The running max is kept in log2 units and
// p = exp2(s * scale * log2(e) - m) on the special-function unit: the same p
// as exp(s * scale - m) to a few f32 ulps, far inside the reference's 2e-5.
//
// Precision. A TF32 operand keeps 10 of f32's 23 mantissa bits; one pass
// misses the reference's 2e-5 by about 15x. So each operand x is split as
// it is loaded into big (x rounded to TF32) and small = x - big (exact), and
// every product is big*small + small*big + big*big, issued in that order
// into one f32 accumulator so the small terms are added first (CUTLASS's
// OpMultiplyAddFastF32). The tensor cores read only the top 19 bits of a
// TF32 operand, so the split takes no conversion instruction: big is x's
// bits plus half a TF32 ulp (rounds to nearest, ties away, as cvt.rna
// does), and small goes in as it is, truncated by the hardware to 2^-11 of
// itself. What is left out is below 2^-21 of each product. (cvt.rna.tf32
// compiles to several instructions; every warp splits every K and V value
// it reads, so with it the split was the largest cost after the products.)
//
// Bound at the slice's full width (B=16, H=8, T=1024, D=128, f32, causal):
// q, k, v and o move 268 MB, 80.1 us at 3.35 TB/s; the visible pairs need
// 4*D*BH*T*(T+1)/2 = 3.44e10 operations, 69.5 us at the 495 TFLOP/s TF32
// peak, 208 us with three passes. So the operations bound it: both products
// run on the tensor cores, the split costs two integer operations and a
// subtraction, fragments are read from shared memory 16 bytes at a time,
// and K/V copies overlap the products. mma.sync does not reach the TF32
// peak, which needs wgmma (K-major operands only for TF32: V would have to
// be transposed in shared memory).
//
// Design (FlashAttention-2's warp layout on warp-level mma.sync m16n8k8).
// - One block of WARPS warps per (b*h, BLOCK_Q-row query tile); each warp
//   owns 16 query rows and walks the key tiles on its own. The grid runs
//   the query tiles in reverse, so the heaviest causal tiles start first.
//   At D = 128 a block holds 72 KB of Q and two stages of K and V, 138 KB:
//   one block of 8 warps per SM (64-key tiles were faster than 32-key
//   tiles, and than 12 warps with 32-key tiles, in a sweep on the card).
// - Q is copied once per block; K/V tiles of BLOCK_K keys move through a
//   ring of two stages by 16-byte cp.async, the next tile in flight while
//   the current one is multiplied. Rows past Tq or Tk are zero-filled by
//   the copy, so the wrapper makes no padding copies. Tiles stay f32 in
//   shared memory, rows padded so that every fragment load below hits each
//   bank once per phase.
// - S = Q K^T: A is Q, B[k][n] = K[n][k] is K as it lies. The contraction
//   over D may run in any order that Q and K share: k-steps come in pairs,
//   and positions t and t + 4 of k-step 2c + h are d = 16c + 4t + 2h and
//   that plus 1, so one 16-byte load of a Q or K row holds a lane's values
//   for two k-steps (8 bytes and one k-step at D = 8).
// - O += P V: P comes from registers with no shuffles. Inside one 8-key
//   slice the k index is permuted (position t -> key 2t, t + 4 -> key
//   2t + 1), which makes S's accumulator fragment {c0, c1, c2, c3} P V's A
//   fragment {c0, c2, c1, c3}; V's B fragment reads rows 2t and 2t + 1.
//   Output columns are permuted too: column g of n-tile NV * c + i is
//   d = 8 * NV * c + NV * g + i, so one 16-byte load of a V row holds a
//   lane's values for NV = 4 n-tiles, and the output is stored 16 bytes at
//   a time.
// - The softmax runs in registers: a lane holds two rows (g and g + 8), and
//   row max and row sum are two xor shuffles over the quad.
// - Each key tile is classified per warp: fully visible (no mask work),
//   partly visible (per-element causal and k_valid mask) or invisible
//   (skipped: it would add exactly 0). Tiles past the causal horizon of the
//   whole block are never loaded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // warps a block, 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_Q = 16 * WARPS;   // query rows a block
constexpr int BLOCK_K = 64;           // keys a K/V tile
constexpr int SLICES = BLOCK_K / 8;   // 8-key slices: S n-tiles, P V k-steps
constexpr int STAGES = 2;             // K/V ring in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  // Q and K fragment loads: a phase of 8 lanes (16-byte loads) reads rows
  // g and g + 1, so their starts must be 16 banks apart; at D = 8 a phase
  // of 16 lanes (8-byte loads) reads rows g .. g + 3, 8 banks apart
  static constexpr int QK_STRIDE = D == 8 ? 8 : D + (48 - D % 32) % 32;
  // V fragment loads read rows 2t: their starts must be 8 banks apart
  static constexpr int V_STRIDE = D + 4;
  static constexpr int QK_VEC = D == 8 ? 2 : 4;  // floats a Q/K load
  static constexpr int NV = D >= 32 ? 4 : D / 8;  // n-tiles a V load
  static constexpr int Q_FLOATS = BLOCK_Q * QK_STRIDE;
  static constexpr int K_FLOATS = BLOCK_K * QK_STRIDE;
  static constexpr int V_FLOATS = BLOCK_K * V_STRIDE;
  static constexpr size_t SMEM_BYTES =
      sizeof(float) * (Q_FLOATS + STAGES * (K_FLOATS + V_FLOATS));
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes = 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + ROWS) of a row-major [t, D] f32 matrix into a
// tile with rows STRIDE floats apart. Rows at or past t are zero-filled.
template <int D, int ROWS, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int t, int tid) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks a row
  constexpr int N = ROWS * CHUNKS;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (N % THREADS == 0 || c < N) {
      const int row = c / CHUNKS;
      const int cc = c % CHUNKS;
      const bool in = row0 + row < t;
      const float* g =
          src + static_cast<size_t>(in ? row0 + row : 0) * D + cc * 4;
      cp_async16(base + 4 * (row * STRIDE + cc * 4), g, in ? 16 : 0);
    }
  }
}

// N consecutive floats from shared memory in one load (N = 1, 2 or 4)
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  } else {
    r[0] = *p;
  }
}

// x = big + small, to 2^-21 of x as the tensor cores read them
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;  // truncated by the hardware
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// c += a b, one m16n8k8 TF32 product with f32 accumulation. Fragments for
// lane l, g = l / 4, t = l % 4: a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, c = {C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its big and small parts
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

// c += a b in three TF32 passes, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split(b0, b0_big, b0_small);
  split(b1, b1_big, b1_small);
  mma_tf32(c, a.big, b0_small, b1_small);
  mma_tf32(c, a.small, b0_big, b1_big);
  mma_tf32(c, a.big, b0_big, b1_big);
}

// 2^x on the special-function unit (2 ulp; flushes denormals)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int t_q, int t_k, int q_offset, int k_offset,
                        int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int QKV = L::QK_VEC;
  constexpr int NV = L::NV;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + L::Q_FLOATS;             // STAGES K tiles
  float* v_s = k_s + STAGES * L::K_FLOATS;    // STAGES V tiles

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_Q;  // heaviest first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const float* qg = q + static_cast<size_t>(bh) * t_q * D;
  const float* kg = k + static_cast<size_t>(bh) * t_k * D;
  const float* vg = v + static_cast<size_t>(bh) * t_k * D;
  float* og = o + static_cast<size_t>(bh) * t_q * D;

  // keys any row of this block can see (k_valid = t_k; causal horizon)
  int k_end = t_k;
  if (causal) {
    const int last_q = q_offset + min(q0 + BLOCK_Q, t_q) - 1;
    k_end = min(t_k, last_q - k_offset + 1);
  }
  const int n_kt = k_end > 0 ? (k_end + BLOCK_K - 1) / BLOCK_K : 0;

  load_tile<D, BLOCK_Q, L::QK_STRIDE>(q_s, qg, q0, t_q, tid);
  if (n_kt > 0) {
    load_tile<D, BLOCK_K, L::QK_STRIDE>(k_s, kg, 0, t_k, tid);
    load_tile<D, BLOCK_K, L::V_STRIDE>(v_s, vg, 0, t_k, tid);
  }
  cp_async_commit();

  // this warp's query rows, and the global positions of the valid ones
  const int wq0 = q0 + 16 * warp;
  const int w_rows = min(16, t_q - wq0);  // <= 0: nothing to compute
  const int r_lo = q_offset + wq0;
  const int r_hi = r_lo + w_rows - 1;
  const int pos0 = r_lo + g;  // this lane's rows: g, and g + 8
  const float m_floor = M_FLOOR * LOG2E;
  // the lane's Q and K values of a k-step pair start at column QKV * t
  const float* q_w = q_s + (16 * warp + g) * L::QK_STRIDE + QKV * t;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // log2 units
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    if (kt + 1 < n_kt) {  // the next tile, in flight during this one
      const int next = (kt + 1) % STAGES;
      load_tile<D, BLOCK_K, L::QK_STRIDE>(k_s + next * L::K_FLOATS, kg,
                                          (kt + 1) * BLOCK_K, t_k, tid);
      load_tile<D, BLOCK_K, L::V_STRIDE>(v_s + next * L::V_FLOATS, vg,
                                         (kt + 1) * BLOCK_K, t_k, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kt has landed
    __syncthreads();

    const int k0 = kt * BLOCK_K;
    const int kv = min(BLOCK_K, t_k - k0);  // valid keys in the tile
    const int c_lo = k_offset + k0;
    const int c_hi = c_lo + kv - 1;
    // warp-uniform: every row precedes every key -> adds exactly 0
    const bool visible = w_rows > 0 && !(causal && r_hi < c_lo);
    if (visible) {
      const bool full = kv == BLOCK_K && (!causal || r_lo >= c_hi);
      const float* kt_s = k_s + stage * L::K_FLOATS + g * L::QK_STRIDE +
                          QKV * t;
      const float* vt_s = v_s + stage * L::V_FLOATS +
                          2 * t * L::V_STRIDE + NV * g;

      // S = Q K^T: slice j holds keys [8j, 8j + 8) of the tile; each load
      // of QKV columns serves QKV / 2 k-steps
      float s[SLICES][4];
#pragma unroll
      for (int j = 0; j < SLICES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int c = 0; c < D / (4 * QKV); ++c) {
        float qa[QKV], qb[QKV];  // rows g and g + 8
        lds(qa, q_w + 4 * QKV * c);
        lds(qb, q_w + 8 * L::QK_STRIDE + 4 * QKV * c);
        FragA a[QKV / 2];
#pragma unroll
        for (int h = 0; h < QKV / 2; ++h)
          a[h] = frag_a(qa[2 * h], qb[2 * h], qa[2 * h + 1], qb[2 * h + 1]);
#pragma unroll
        for (int j = 0; j < SLICES; ++j) {
          float kb[QKV];
          lds(kb, kt_s + 8 * j * L::QK_STRIDE + 4 * QKV * c);
#pragma unroll
          for (int h = 0; h < QKV / 2; ++h)
            mma_3xtf32(s[j], a[h], kb[2 * h], kb[2 * h + 1]);
        }
      }

      // scores in log2 units; masked scores -inf: p = exp2(-inf) = 0, as
      // exp(-1e30 - m) is
#pragma unroll
      for (int j = 0; j < SLICES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (!full) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int pos = pos0 + 8 * (e >> 1);
            const bool ok = col < t_k && (!causal || pos >= k_offset + col);
            x = ok ? x : -INFINITY;
          }
          s[j][e] = x;
        }

      // online softmax on the lane's rows i = 0 (g) and 1 (g + 8)
      float m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < SLICES; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[i] = fmaxf(fmaxf(m[i], mx), m_floor);
        const float corr = exp2_approx(m[i] - m_new[i]);
        l[i] *= corr;
        m[i] = m_new[i];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }

      // O += P V, one 8-key slice at a time; slice kk's S fragment, in the
      // order {c0, c2, c1, c3}, is its A fragment under the key permutation
#pragma unroll
      for (int kk = 0; kk < SLICES; ++kk) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = exp2_approx(s[kk][e] - m_new[e >> 1]);
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        const FragA a = frag_a(p[0], p[2], p[1], p[3]);
        const float* vb = vt_s + 8 * kk * L::V_STRIDE;
#pragma unroll
        for (int c = 0; c < D / (8 * NV); ++c) {
          float v0[NV], v1[NV];  // keys 2t and 2t + 1, NV n-tiles
          lds(v0, vb + 8 * NV * c);
          lds(v1, vb + L::V_STRIDE + 8 * NV * c);
#pragma unroll
          for (int i = 0; i < NV; ++i)
            mma_3xtf32(acc[NV * c + i], a, v0[i], v1[i]);
        }
      }
    }
    __syncthreads();  // the next iteration refills the other stage: this
                      // one is free for the tile after it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // acc[NV * c + i][2 * row + e] is column 8 * NV * c + NV * (2t + e) + i
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= w_rows) continue;
    const float inv = 1.f / (l[r] > 0.f ? l[r] : 1.f);
    float* dst = og + static_cast<size_t>(wq0 + row) * D;
#pragma unroll
    for (int c = 0; c < D / (8 * NV); ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float out[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) out[i] = acc[NV * c + i][2 * r + e] * inv;
        float* d = dst + 8 * NV * c + NV * (2 * t + e);
        if constexpr (NV == 4)
          *reinterpret_cast<float4*>(d) =
              make_float4(out[0], out[1], out[2], out[3]);
        else if constexpr (NV == 2)
          *reinterpret_cast<float2*>(d) = make_float2(out[0], out[1]);
        else
          *d = out[0];
      }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t_q, int t_k, int q_offset, int k_offset,
                   int causal, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::SMEM_BYTES;
  // above 48 KB a block's dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_tf32x3_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_q, t_k,
      q_offset, k_offset, causal, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, o: [bh, t_q, d]; k, v: [bh, t_k, d]; all contiguous float32 (dtype 0)
// with 16-byte aligned data. Launches on `stream` and returns the launch
// status (cudaGetLastError); it does not synchronise.
extern "C" int v6t_flash_attention_fwd_tf32x3(const void* q, const void* k,
                                              const void* v, void* o,
                                              int dtype, int bh, int t_q,
                                              int t_k, int d, int q_offset,
                                              int k_offset, int causal,
                                              float scale, void* stream) {
  if (dtype != 0 || bh <= 0 || t_q <= 0 || t_k < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset, causal,
                       scale, s);
    case 16:
      return launch<16>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset, causal,
                        scale, s);
    case 32:
      return launch<32>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset, causal,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset, causal,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset, causal,
                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* v6t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
