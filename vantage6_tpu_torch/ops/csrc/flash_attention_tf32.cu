// Flash-attention forward in f32 on the tensor cores of NVIDIA Hopper
// (sm_90a): mma.sync TF32, three passes per product.
//
// Replaces the Pallas TPU kernel vantage6_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_forward through pl.pallas_call) for f32 inputs at
// every head dim that is a multiple of 8 (the wrapper zero-pads any other D
// up to one). Up to 256 it is instantiated at widths W = 8, 16, 32, 64, 128
// and 256; a call at head dim d runs the narrowest W >= d,
// loads the true d columns of each row and zero-fills the shared-memory
// tile up to W, skips the k-steps and output n-tiles that lie wholly past d,
// and stores only the true d columns. It computes the same function:
// online-softmax
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
//   At W = 128 a block holds 72 KB of Q and two stages of K and V, 138 KB:
//   one block of 8 warps per SM (64-key tiles were faster than 32-key
//   tiles, and than 12 warps with 32-key tiles, in a sweep on the card).
//   At W = 256, 64-key tiles would need 272 KB, so the key tiles are 16
//   keys: 136 KB of Q and 66 KB of stages, 202 KB, one block of 8 warps
//   per SM; the O accumulator is 128 registers a thread. In a sweep on an
//   H100 (kernel_sweep.py tiles) at [8, 8, 1024, 256] causal, 8 warps over
//   16-key tiles took 0.74 ms, 6 warps over 24 keys 0.85, 6 over 16 0.92,
//   4 over 16 0.94 and 4 over 32 1.26.
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
//
// Head dims above 256 (flash_fwd_tf32x3_wide_kernel). At D = 512 the Q tile
// alone would take 256 KB. So O is cut into column slabs of at most
// SLAB = 256, one more grid dimension: each block owns one slab of O, with
// its own m and l. Every slab needs the whole S = Q K^T, so each warp
// accumulates its S fragment over depth chunks of DEPTH = 64 columns: chunk
// c of the Q tile and of the key tile's K move through the two-stage
// cp.async ring (50 KB a stage), the next chunk in flight while this one is
// multiplied, and the key tile's V slab comes in with its first chunk; after
// the last chunk S is whole and the softmax and O += P V run as above on
// the slab. Key tiles are 32 keys: the Q chunk, reloaded from L2 for every
// key tile as it no longer fits beside the stages, is then read once per
// 32 keys, and 165 KB of shared memory hold the ring. A depth chunk or slab
// that runs past d is zero-filled by the copy, its k-step pairs and n-tiles
// past d skipped (D = 300 pads to 304: chunks 64 x 4 and 48 of 64; slabs
// 256 and 48 of 64). The slabs compute the same S from the same operands
// in the same order, so m, l and p are bit-equal across slabs. Full slabs
// run at W = 256; a tail slab of at most 128 columns runs in a second
// launch at W = 64 or 128, a wider one as one more W = 256 slab.
// Cost: ceil(d / 256) passes of Q K^T (one per slab) where one would do,
// and as many exps. At [B=4, H=8, T=1024, D=512] causal, f32: q, k, v and o
// move 268 MB, 80.1 us; the visible pairs need 4*D*BH*T*(T+1)/2 = 3.44e10
// operations, 69.5 us at the TF32 peak, 208 us with three passes; the
// kernel issues two passes of Q K^T, 1.5 times that: 313 us.
#include <cuda_runtime.h>
#include <cmath>
#include <stdint.h>

namespace {

constexpr int STAGES = 2;             // K/V ring in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;

// Tiles and shared-memory layout of the instantiation at width W = D.
template <int D>
struct Layout {
  static constexpr int WARPS = 8;             // 16 query rows each
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BLOCK_Q = 16 * WARPS;  // query rows a block
  static constexpr int BLOCK_K = D == 256 ? 16 : 64;  // keys a K/V tile
  static constexpr int SLICES = BLOCK_K / 8;  // S n-tiles, P V k-steps
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

// Head dims above SLAB (the wide kernel): O in slabs of at most SLAB
// columns, S = Q K^T over depth chunks of DEPTH columns.
constexpr int SLAB = 256;
constexpr int DEPTH = 64;

// The wide kernel's tiles and shared memory at O slab width W: 8 warps of
// 16 query rows over 32-key tiles; STAGES stages of a [BLOCK_Q, DEPTH] Q
// chunk (40 KB) and a [BLOCK_K, DEPTH] K chunk (10 KB), rows padded as
// Layout<DEPTH>'s, then STAGES [BLOCK_K, W] V slab tiles (33 KB at
// W = 256): 165 KB at W = 256.
template <int W>
struct WideLayout {
  static constexpr int THREADS = Layout<DEPTH>::THREADS;
  static constexpr int BLOCK_Q = Layout<DEPTH>::BLOCK_Q;
  static constexpr int BLOCK_K = 32;
  static constexpr int QK_STRIDE = Layout<DEPTH>::QK_STRIDE;
  static constexpr int V_STRIDE = W + 4;
  static constexpr int Q_FLOATS = BLOCK_Q * QK_STRIDE;
  static constexpr int STAGE_FLOATS = Q_FLOATS + BLOCK_K * QK_STRIDE;
  static constexpr int V_FLOATS = BLOCK_K * V_STRIDE;
  static constexpr size_t SMEM_BYTES =
      sizeof(float) * STAGES * (STAGE_FLOATS + V_FLOATS);
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

// Copy rows [row0, row0 + ROWS) and columns [col0, col0 + D) of a
// row-major [t, d] f32 matrix (d and col0 multiples of 8) into a W = D tile
// with rows STRIDE floats apart. Rows at or past t and columns at or past d
// are zero-filled.
template <int D, int ROWS, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int t, int d, int tid,
                                          int col0 = 0) {
  constexpr int THREADS = Layout<D>::THREADS;
  constexpr int CHUNKS = D / 4;  // 16-byte chunks a row
  constexpr int N = ROWS * CHUNKS;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (N % THREADS == 0 || c < N) {
      const int row = c / CHUNKS;
      const int cc = c % CHUNKS;
      const bool in = row0 + row < t && col0 + cc * 4 < d;
      const float* g =
          src + (in ? static_cast<size_t>(row0 + row) * d + col0 + cc * 4
                    : 0);
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

// s += Q K^T over the first CHUNK columns of a staged Q tile and K tile
// whose rows are STRIDE floats apart: q_w points at this lane's row g,
// column QKV * t of Q, k_w at row g, column QKV * t of K (slice j holds
// keys [8j, 8j + 8)). Each load of QKV columns serves QKV / 2 k-steps;
// step pairs at or past `cols` (the true columns left) read zero-filled
// columns and add 0, so they are skipped.
template <int CHUNK, int STRIDE, int QKV, int SLICES>
__device__ __forceinline__ void scores(float (&s)[SLICES][4],
                                       const float* q_w, const float* k_w,
                                       int cols) {
#pragma unroll
  for (int c = 0; c < CHUNK / (4 * QKV); ++c) {
    if (4 * QKV * c >= cols) continue;
    float qa[QKV], qb[QKV];  // rows g and g + 8
    lds(qa, q_w + 4 * QKV * c);
    lds(qb, q_w + 8 * STRIDE + 4 * QKV * c);
    FragA a[QKV / 2];
#pragma unroll
    for (int h = 0; h < QKV / 2; ++h)
      a[h] = frag_a(qa[2 * h], qb[2 * h], qa[2 * h + 1], qb[2 * h + 1]);
#pragma unroll
    for (int j = 0; j < SLICES; ++j) {
      float kb[QKV];
      lds(kb, k_w + 8 * j * STRIDE + 4 * QKV * c);
#pragma unroll
      for (int h = 0; h < QKV / 2; ++h)
        mma_3xtf32(s[j], a[h], kb[2 * h], kb[2 * h + 1]);
    }
  }
}

// One key tile's online-softmax update and O += P V on the lane's rows
// g and g + 8. s holds the tile's scores q.k, unscaled; k0 is the tile's
// first key, pos0 the global position of row g; vt_s points at row 2t,
// column NV * g of the tile's V (W columns, rows V_STRIDE floats apart), of
// which the first `cols` are true columns.
template <int W, int SLICES, int NV, int V_STRIDE>
__device__ __forceinline__ void softmax_pv(float (&s)[SLICES][4],
                                           float (&acc)[W / 8][4],
                                           float (&m)[2], float (&l)[2],
                                           bool full, float scale_log2,
                                           int k0, int t_k, int pos0,
                                           int causal, int k_offset, int t,
                                           const float* vt_s, int cols) {
  const float m_floor = M_FLOOR * LOG2E;
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
    for (int n = 0; n < W / 8; ++n) {
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
    for (int e = 0; e < 4; ++e) p[e] = exp2_approx(s[kk][e] - m_new[e >> 1]);
    l[0] += p[0] + p[1];
    l[1] += p[2] + p[3];
    const FragA a = frag_a(p[0], p[2], p[1], p[3]);
    const float* vb = vt_s + 8 * kk * V_STRIDE;
#pragma unroll
    for (int c = 0; c < W / (8 * NV); ++c) {
      if (8 * NV * c >= cols) continue;  // output columns past d
      float v0[NV], v1[NV];  // keys 2t and 2t + 1, NV n-tiles
      lds(v0, vb + 8 * NV * c);
      lds(v1, vb + V_STRIDE + 8 * NV * c);
#pragma unroll
      for (int i = 0; i < NV; ++i) mma_3xtf32(acc[NV * c + i], a, v0[i], v1[i]);
    }
  }
}

// The lane's output rows g and g + 8 of the warp's rows from wq0, columns
// [col0, col0 + W) of o (row stride d): acc / l, with l summed over the
// quad first and l == 0 (a fully masked row) giving 0. acc[NV * c + i]
// [2 * row + e] is column col0 + 8 * NV * c + NV * (2t + e) + i; columns
// at or past d are not stored.
template <int W, int NV>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 8][4],
                                           float (&l)[2], float* og, int wq0,
                                           int g, int t, int w_rows, int d,
                                           int col0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= w_rows) continue;
    const float inv = 1.f / (l[r] > 0.f ? l[r] : 1.f);
    float* dst = og + static_cast<size_t>(wq0 + row) * d + col0;
#pragma unroll
    for (int c = 0; c < W / (8 * NV); ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // NV columns from a multiple of NV: all below d or all past it
        if (col0 + 8 * NV * c + NV * (2 * t + e) >= d) continue;
        float out[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) out[i] = acc[NV * c + i][2 * r + e] * inv;
        float* p = dst + 8 * NV * c + NV * (2 * t + e);
        if constexpr (NV == 4)
          *reinterpret_cast<float4*>(p) =
              make_float4(out[0], out[1], out[2], out[3]);
        else if constexpr (NV == 2)
          *reinterpret_cast<float2*>(p) = make_float2(out[0], out[1]);
        else
          *p = out[0];
      }
  }
}

// D is the instantiated width W; d (a multiple of 8, at most D) is the
// head dim of q, k, v and o, the row stride in device memory. PAD = false
// is the instantiation for d == D, where d is a constant.
template <int D, bool PAD>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int t_q, int t_k, int d_arg, int q_offset,
                        int k_offset, int causal, float scale_log2) {
  using L = Layout<D>;
  const int d = PAD ? d_arg : D;
  constexpr int QKV = L::QK_VEC;
  constexpr int NV = L::NV;
  constexpr int BLOCK_Q = L::BLOCK_Q;
  constexpr int BLOCK_K = L::BLOCK_K;
  constexpr int SLICES = L::SLICES;
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

  const float* qg = q + static_cast<size_t>(bh) * t_q * d;
  const float* kg = k + static_cast<size_t>(bh) * t_k * d;
  const float* vg = v + static_cast<size_t>(bh) * t_k * d;
  float* og = o + static_cast<size_t>(bh) * t_q * d;

  // keys any row of this block can see (k_valid = t_k; causal horizon)
  int k_end = t_k;
  if (causal) {
    const int last_q = q_offset + min(q0 + BLOCK_Q, t_q) - 1;
    k_end = min(t_k, last_q - k_offset + 1);
  }
  const int n_kt = k_end > 0 ? (k_end + BLOCK_K - 1) / BLOCK_K : 0;

  load_tile<D, BLOCK_Q, L::QK_STRIDE>(q_s, qg, q0, t_q, d, tid);
  if (n_kt > 0) {
    load_tile<D, BLOCK_K, L::QK_STRIDE>(k_s, kg, 0, t_k, d, tid);
    load_tile<D, BLOCK_K, L::V_STRIDE>(v_s, vg, 0, t_k, d, tid);
  }
  cp_async_commit();

  // this warp's query rows, and the global positions of the valid ones
  const int wq0 = q0 + 16 * warp;
  const int w_rows = min(16, t_q - wq0);  // <= 0: nothing to compute
  const int r_lo = q_offset + wq0;
  const int r_hi = r_lo + w_rows - 1;
  const int pos0 = r_lo + g;  // this lane's rows: g, and g + 8
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
                                          (kt + 1) * BLOCK_K, t_k, d, tid);
      load_tile<D, BLOCK_K, L::V_STRIDE>(v_s + next * L::V_FLOATS, vg,
                                         (kt + 1) * BLOCK_K, t_k, d, tid);
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
      float s[SLICES][4];
#pragma unroll
      for (int j = 0; j < SLICES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      scores<D, L::QK_STRIDE, QKV, SLICES>(
          s, q_w,
          k_s + stage * L::K_FLOATS + g * L::QK_STRIDE + QKV * t, d);
      softmax_pv<D, SLICES, NV, L::V_STRIDE>(
          s, acc, m, l, full, scale_log2, k0, t_k, pos0, causal, k_offset, t,
          v_s + stage * L::V_FLOATS + 2 * t * L::V_STRIDE + NV * g, d);
    }
    __syncthreads();  // the next iteration refills the other stage: this
                      // one is free for the tile after it
  }
  cp_async_wait<0>();
  store_rows<D, NV>(acc, l, og, wq0, g, t, w_rows, d, 0);
}

// Head dims above 256 (see "Head dims above 256" at the top). W is the
// width of the block's O slab, output columns [col0, col0 + W) with
// col0 = slab0 + W * blockIdx.z; d (a multiple of 8, above 256) is the head
// dim and row stride. The block walks steps j = kt * n_c + c: step j
// stages depth chunk c (DEPTH columns) of the Q tile and of key tile kt's
// K, and with c = 0 key tile kt's V slab, while step j - 1 is multiplied.
template <int W>
__global__ void __launch_bounds__(WideLayout<W>::THREADS, 1)
flash_fwd_tf32x3_wide_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, int t_q, int t_k, int d,
                             int slab0, int q_offset, int k_offset,
                             int causal, float scale_log2) {
  using WL = WideLayout<W>;
  constexpr int BLOCK_Q = WL::BLOCK_Q;
  constexpr int BLOCK_K = WL::BLOCK_K;
  constexpr int SLICES = BLOCK_K / 8;
  constexpr int QKV = 4;
  constexpr int NV = 4;
  constexpr int QK_STRIDE = WL::QK_STRIDE;
  extern __shared__ __align__(16) float smem[];
  float* v_base = smem + STAGES * WL::STAGE_FLOATS;  // STAGES V slabs

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_Q;  // heaviest first
  const int col0 = slab0 + blockIdx.z * W;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const float* qg = q + static_cast<size_t>(bh) * t_q * d;
  const float* kg = k + static_cast<size_t>(bh) * t_k * d;
  const float* vg = v + static_cast<size_t>(bh) * t_k * d;
  float* og = o + static_cast<size_t>(bh) * t_q * d;

  int k_end = t_k;
  if (causal) {
    const int last_q = q_offset + min(q0 + BLOCK_Q, t_q) - 1;
    k_end = min(t_k, last_q - k_offset + 1);
  }
  const int n_kt = k_end > 0 ? (k_end + BLOCK_K - 1) / BLOCK_K : 0;
  const int n_c = (d + DEPTH - 1) / DEPTH;  // depth chunks
  const int n_steps = n_kt * n_c;

  auto stage_in = [&](int j) {
    const int kt = j / n_c;
    const int c = j % n_c;
    float* st = smem + (j % STAGES) * WL::STAGE_FLOATS;
    load_tile<DEPTH, BLOCK_Q, QK_STRIDE>(st, qg, q0, t_q, d, tid, c * DEPTH);
    load_tile<DEPTH, BLOCK_K, QK_STRIDE>(st + WL::Q_FLOATS, kg, kt * BLOCK_K,
                                         t_k, d, tid, c * DEPTH);
    if (c == 0)
      load_tile<W, BLOCK_K, WL::V_STRIDE>(v_base + (kt % STAGES) *
                                                       WL::V_FLOATS,
                                          vg, kt * BLOCK_K, t_k, d, tid,
                                          col0);
  };
  if (n_steps > 0) stage_in(0);
  cp_async_commit();

  const int wq0 = q0 + 16 * warp;
  const int w_rows = min(16, t_q - wq0);
  const int r_lo = q_offset + wq0;
  const int r_hi = r_lo + w_rows - 1;
  const int pos0 = r_lo + g;
  const int q_lane = (16 * warp + g) * QK_STRIDE + QKV * t;
  const int k_lane = g * QK_STRIDE + QKV * t;

  float acc[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float s[SLICES][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    const int kv = min(BLOCK_K, t_k - k0);
    const int c_lo = k_offset + k0;
    const int c_hi = c_lo + kv - 1;
    const bool visible = w_rows > 0 && !(causal && r_hi < c_lo);
    const bool full = kv == BLOCK_K && (!causal || r_lo >= c_hi);
#pragma unroll
    for (int j = 0; j < SLICES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int c = 0; c < n_c; ++c) {
      const int j = kt * n_c + c;
      if (j + 1 < n_steps) stage_in(j + 1);  // in flight during this step
      cp_async_commit();
      cp_async_wait<1>();  // step j's chunks (and V slab) have landed
      __syncthreads();
      if (visible) {
        // S accumulates over the chunks; a tail chunk's pairs past d are
        // skipped
        const float* st = smem + (j % STAGES) * WL::STAGE_FLOATS;
        scores<DEPTH, QK_STRIDE, QKV, SLICES>(s, st + q_lane,
                                              st + WL::Q_FLOATS + k_lane,
                                              d - c * DEPTH);
        if (c == n_c - 1)  // S is whole: every slab sees the same S
          softmax_pv<W, SLICES, NV, WL::V_STRIDE>(
              s, acc, m, l, full, scale_log2, k0, t_k, pos0, causal,
              k_offset, t,
              v_base + (kt % STAGES) * WL::V_FLOATS + 2 * t * WL::V_STRIDE +
                  NV * g,
              d - col0);
      }
      __syncthreads();  // step j's stage is free for step j + 2
    }
  }
  cp_async_wait<0>();
  store_rows<W, NV>(acc, l, og, wq0, g, t, w_rows, d, col0);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t_q, int t_k, int d, int q_offset,
                   int k_offset, int causal, float scale,
                   cudaStream_t stream) {
  using L = Layout<D>;
  const size_t bytes = Layout<D>::SMEM_BYTES;
  // above 48 KB a block's dynamic shared memory has to be asked for
  auto kernel = d == D ? flash_fwd_tf32x3_kernel<D, false>
                       : flash_fwd_tf32x3_kernel<D, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + L::BLOCK_Q - 1) / L::BLOCK_Q);
  kernel<<<grid, L::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_q, t_k, d,
      q_offset, k_offset, causal, scale * LOG2E);
  return cudaGetLastError();
}

// n_slabs O slabs of width W from column slab0
template <int W>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int bh, int t_q, int t_k, int d, int slab0,
                        int n_slabs, int q_offset, int k_offset, int causal,
                        float scale, cudaStream_t stream) {
  using WL = WideLayout<W>;
  const size_t bytes = WL::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_wide_kernel<W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + WL::BLOCK_Q - 1) / WL::BLOCK_Q, n_slabs);
  flash_fwd_tf32x3_wide_kernel<W><<<grid, WL::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_q, t_k, d,
      slab0, q_offset, k_offset, causal, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, o: [bh, t_q, d]; k, v: [bh, t_k, d]; all contiguous float32 (dtype 0)
// with 16-byte aligned data, d a multiple of 8 (any size), any finite
// scale. Launches on `stream` (two kernels for a d above 256 whose last
// slab is narrower) and returns the launch status (cudaGetLastError); it
// does not synchronise.
extern "C" int v6t_flash_attention_fwd_tf32x3(const void* q, const void* k,
                                              const void* v, void* o,
                                              int dtype, int bh, int t_q,
                                              int t_k, int d, int q_offset,
                                              int k_offset, int causal,
                                              float scale, void* stream) {
  if (dtype != 0 || bh <= 0 || t_q <= 0 || t_k < 0 || d < 8 || d % 8 != 0 ||
      !std::isfinite(scale))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > SLAB) {
    // slabs of SLAB columns; a tail above 128 columns is one more of them,
    // a narrower tail a second launch at the narrowest W >= the tail
    const int full = d / SLAB;
    const int tail = d % SLAB;
    if (tail > 128)
      return launch_wide<SLAB>(q, k, v, o, bh, t_q, t_k, d, 0, full + 1,
                               q_offset, k_offset, causal, scale, s);
    cudaError_t err = launch_wide<SLAB>(q, k, v, o, bh, t_q, t_k, d, 0, full,
                                        q_offset, k_offset, causal, scale, s);
    if (err != cudaSuccess || tail == 0) return err;
    if (tail <= 64)
      return launch_wide<64>(q, k, v, o, bh, t_q, t_k, d, full * SLAB, 1,
                             q_offset, k_offset, causal, scale, s);
    return launch_wide<128>(q, k, v, o, bh, t_q, t_k, d, full * SLAB, 1,
                            q_offset, k_offset, causal, scale, s);
  }
  // the narrowest instantiated width W >= d
  if (d <= 8)
    return launch<8>(q, k, v, o, bh, t_q, t_k, d, q_offset, k_offset, causal,
                     scale, s);
  if (d <= 16)
    return launch<16>(q, k, v, o, bh, t_q, t_k, d, q_offset, k_offset,
                      causal, scale, s);
  if (d <= 32)
    return launch<32>(q, k, v, o, bh, t_q, t_k, d, q_offset, k_offset,
                      causal, scale, s);
  if (d <= 64)
    return launch<64>(q, k, v, o, bh, t_q, t_k, d, q_offset, k_offset,
                      causal, scale, s);
  if (d <= 128)
    return launch<128>(q, k, v, o, bh, t_q, t_k, d, q_offset, k_offset,
                       causal, scale, s);
  return launch<256>(q, k, v, o, bh, t_q, t_k, d, q_offset, k_offset, causal,
                     scale, s);
}

extern "C" const char* v6t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
