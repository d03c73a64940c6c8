// Flash-attention forward on the tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vantage6_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_forward through pl.pallas_call) for bf16 inputs at head
// dims 16, 32, 64 and 128; flash_attention.cu, on the CUDA cores, keeps f32
// (tensor cores would round it to TF32) and D = 8 (below wgmma's k16 depth).
// It computes the same function: online-softmax attention over [B*H, T, D]
// with causal masking by global position (q_offset + row >= k_offset + col),
// padded keys masked against k_valid = Tk, masked scores giving p = 0
// exactly (the TPU kernel's -1e30; -inf here), the running max floored at
// -1e20, m, l and acc in f32 with l summed from the f32 p, p rounded to bf16
// before p.v, and the output acc / (l > 0 ? l : 1), so fully masked rows are
// exactly 0. The running max is kept in log2 units and scale * log2(e) is
// folded into one FMA, p = exp2(s * scale * log2(e) - m) on the
// special-function unit: the same p as exp(s * scale - m) to a few f32 ulps,
// far below the bf16 rounding that follows. It needs scale > 0.
//
// Bound at the slice's full width (B=16, H=8, T=1024, D=128, causal): the
// visible score entries need 4*D*BH*T*(T+1)/2 = 3.44e10 operations, 34.8 us
// at the 989 TFLOP/s bf16 tensor-core peak; q, k, v and o move 134 MB, 40.1
// us at 3.35 TB/s. Bytes and operations are close, so both products have to
// run on the tensor cores and the loads have to overlap them.
//
// Design.
// - One block of two consumer warpgroups (256 threads) per (b*h, 128-row
//   query tile); each warpgroup owns 64 query rows. The grid runs the query
//   tiles in reverse, so the heaviest causal tiles start first and the tail
//   of the grid is short.
// - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared memory
//   (Q and K are [T, D] row-major). O += P V is wgmma m64nDk16 with P from
//   registers: the S accumulator, after the softmax and the cast to bf16, is
//   already wgmma's register A fragment for each k16 slice; V is the B
//   operand, MN-major (transposed) from shared memory.
// - Tiles stay bf16 in shared memory, in the swizzled layout wgmma reads
//   (128-byte swizzle for D >= 64, 64-byte for D = 32, 32-byte for D = 16).
//   Q is loaded once per block; K/V tiles of 64 keys move through a ring of
//   two stages by 16-byte cp.async, the next tile in flight while the
//   current one is multiplied. Rows past Tq or Tk are zero-filled by the
//   copy, so the wrapper makes no padding copies. At D = 128 a block holds
//   32 KB of Q and 64 KB of K/V stages: two blocks fit on one SM.
// - The softmax runs in registers: each accumulator row lies on the 4 lanes
//   of a quad, so row max and row sum are two xor shuffles. P is built one
//   k16 slice at a time, each slice's wgmma issued as soon as it is packed,
//   which keeps D = 128 within the 128 registers that two blocks per SM
//   allow.
// - Each key tile is classified per warpgroup: fully visible (no mask
//   work), partly visible (per-element causal and k_valid mask), or
//   invisible (skipped: it would add exactly 0). Tiles past the causal
//   horizon of the whole block are never loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 128;  // query rows per block: two warpgroups
constexpr int WG_ROWS = 64;   // query rows per warpgroup (wgmma's M)
constexpr int BLOCK_K = 64;   // keys per K/V tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;     // K/V ring in shared memory (three stages
                              // leave room for one block per SM: slower)
constexpr int MIN_BLOCKS = 2;  // blocks per SM the registers must allow
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;

// A [rows, D] bf16 tile in shared memory in wgmma's canonical swizzled
// layout: D is cut into column blocks of ATOM elements (one swizzle row of
// ROW_BYTES), each block stores its rows ROW_BYTES apart, and the 16-byte
// chunk c of row r lands at chunk c ^ f(r) (see swizzle()). Tiles start on
// 1024-byte boundaries, the period of the widest pattern.
template <int D>
struct Layout {
  static constexpr int ATOM = D < 64 ? D : 64;
  static constexpr int ROW_BYTES = 2 * ATOM;           // 32, 64 or 128
  static constexpr int CHUNKS = D / 8;                 // 16-byte chunks a row
  static constexpr int ATOM_CHUNKS = ATOM / 8;
  static constexpr uint32_t MASK = ROW_BYTES / 16 - 1;  // 1, 3 or 7
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t MODE = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2
                                                                          : 3;
  static constexpr uint32_t Q_BYTES = BLOCK_Q * D * 2;
  static constexpr uint32_t KV_BYTES = BLOCK_K * D * 2;
  static constexpr uint32_t SMEM_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
};

// The hardware's swizzle on shared-memory byte addresses: bits [4, 4+b) xor
// bits [7, 7+b), b = 3, 2, 1 for the 128-, 64- and 32-byte patterns.
__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

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

// Copy rows [row0, row0 + ROWS) of a row-major [t, D] matrix into a swizzled
// tile at shared address dst. Rows at or past t are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int t, int tid) {
  using L = Layout<D>;
  constexpr int N = ROWS * L::CHUNKS;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (N % THREADS == 0 || c < N) {
      const int row = c / L::CHUNKS;
      const int cc = c % L::CHUNKS;
      const uint32_t off = (cc / L::ATOM_CHUNKS) * ROWS * L::ROW_BYTES +
                           row * L::ROW_BYTES + (cc % L::ATOM_CHUNKS) * 16;
      const bool in = row0 + row < t;
      const __nv_bfloat16* g =
          src + static_cast<size_t>(in ? row0 + row : 0) * D + cc * 8;
      cp_async16(dst + swizzle(off, L::MASK), g, in ? 16 : 0);
    }
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | mode << 62;
}

// K-major operand: k16 slice `ks` of rows [r0, r0 + 64) of a tile with
// `rows` rows. Groups of 8 rows are 8 * ROW_BYTES apart (SBO); a k16 slice
// is 32 bytes into its swizzle row (LBO unused by swizzled K-major).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int r0, int ks) {
  using L = Layout<D>;
  const uint32_t addr = tile + (ks * 16 / L::ATOM) * rows * L::ROW_BYTES +
                        r0 * L::ROW_BYTES + (ks * 16 % L::ATOM) * 2;
  return make_desc(addr, 16, 8 * L::ROW_BYTES, L::MODE);
}

// MN-major operand V [keys, D] for P.V: k16 slice `kk` holds keys
// [16kk, 16kk + 16). Groups of 8 keys are 8 * ROW_BYTES apart (SBO); column
// blocks of ATOM values are a whole column block of the tile apart (LBO).
template <int D>
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t tile, int kk) {
  using L = Layout<D>;
  return make_desc(tile + kk * 16 * L::ROW_BYTES, BLOCK_K * L::ROW_BYTES,
                   8 * L::ROW_BYTES, L::MODE);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Accumulator layout of wgmma m64nNk16 (f32), for lane l of warp w of the
// warpgroup: d[4n + 2i + j] is row 16w + l/4 + 8i, column 8n + 2(l%4) + j.

// S = Q K^T, both operands K-major from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O += P V with P from registers, V MN-major (imm-trans-b = 1); N = D.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// 2^x on the special-function unit (2 ulp; flushes denormals, which are
// far below the bf16 rounding of p)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int t_q, int t_k,
                       int q_offset, int k_offset, int causal,
                       float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t k_s = q_s + L::Q_BYTES;             // STAGES K tiles
  const uint32_t v_s = k_s + STAGES * L::KV_BYTES;   // STAGES V tiles

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_Q;  // heaviest first
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * t_q * D;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * t_k * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * t_k * D;
  __nv_bfloat16* og = o + static_cast<size_t>(bh) * t_q * D;

  // keys any row of this block can see (k_valid = t_k; causal horizon)
  int k_end = t_k;
  if (causal) {
    const int last_q = q_offset + min(q0 + BLOCK_Q, t_q) - 1;
    k_end = min(t_k, last_q - k_offset + 1);
  }
  const int n_kt = k_end > 0 ? (k_end + BLOCK_K - 1) / BLOCK_K : 0;

  load_tile<D, BLOCK_Q>(q_s, qg, q0, t_q, tid);
  if (n_kt > 0) {
    load_tile<D, BLOCK_K>(k_s, kg, 0, t_k, tid);
    load_tile<D, BLOCK_K>(v_s, vg, 0, t_k, tid);
  }
  cp_async_commit();

  // this warpgroup's query rows, and the global positions of the valid ones
  const int wq0 = q0 + wg * WG_ROWS;
  const int w_rows = min(WG_ROWS, t_q - wq0);  // <= 0: nothing to compute
  const int r_lo = q_offset + wq0;
  const int r_hi = r_lo + w_rows - 1;
  // this thread's two rows: 16 * warp + lane / 4, and 8 below it
  const int row0 = warp * 16 + lane / 4;
  const int pos0 = r_lo + row0;  // global position of row0
  const float m_floor = M_FLOOR * LOG2E;

  float acc[D / 2];
  float s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    if (kt + 1 < n_kt) {  // the next tile, in flight during this one
      const int next = (kt + 1) % STAGES;
      load_tile<D, BLOCK_K>(k_s + next * L::KV_BYTES, kg, (kt + 1) * BLOCK_K,
                            t_k, tid);
      load_tile<D, BLOCK_K>(v_s + next * L::KV_BYTES, vg, (kt + 1) * BLOCK_K,
                            t_k, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kt has landed
    // the copies wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int k0 = kt * BLOCK_K;
    const int kv = min(BLOCK_K, t_k - k0);  // valid keys in the tile
    const int c_lo = k_offset + k0;
    const int c_hi = c_lo + kv - 1;
    // warpgroup-uniform: every row precedes every key -> adds exactly 0
    const bool visible = w_rows > 0 && !(causal && r_hi < c_lo);
    if (visible) {
      const bool full = kv == BLOCK_K && (!causal || r_lo >= c_hi);
      const uint32_t kt_s = k_s + stage * L::KV_BYTES;
      const uint32_t vt_s = v_s + stage * L::KV_BYTES;

      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s, kmajor_desc<D>(q_s, BLOCK_Q, wg * WG_ROWS, ks),
                     kmajor_desc<D>(kt_s, BLOCK_K, 0, ks), ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masked scores -inf: p = exp2(-inf) = 0, as exp(-1e30 - m) is
      if (!full) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i % 2);
          const int pos = pos0 + 8 * ((i / 2) % 2);
          const bool ok = col < t_k && (!causal || pos >= k_offset + col);
          s[i] = ok ? s[i] : -INFINITY;
        }
      }

      // online softmax on the thread's two rows i, m in log2 units
      float m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[i] = fmaxf(fmaxf(m[i], mx * scale_log2), m_floor);
        const float corr = exp2_approx(m[i] - m_new[i]);
        l[i] *= corr;
        m[i] = m_new[i];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n + 2 * i] *= corr;
          acc[4 * n + 2 * i + 1] *= corr;
        }
      }

      // O += P V, one k16 slice of P at a time, so that only its four
      // registers are live (with all of P live at D = 128, ptxas runs out of
      // registers and serialises the wgmmas): slice kk is score columns
      // [16kk, 16kk + 16), rows i = 0, 1 of column blocks n = 2kk and
      // 2kk + 1, and wgmma's register A fragment is {(n0, i0), (n0, i1),
      // (n1, i0), (n1, i1)}. The exp2 of one slice overlaps the product of
      // the one before.
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 2 * kk + r / 2;
          const int i = r % 2;
          const float p0 =
              exp2_approx(fmaf(s[4 * n + 2 * i], scale_log2, -m_new[i]));
          const float p1 =
              exp2_approx(fmaf(s[4 * n + 2 * i + 1], scale_log2, -m_new[i]));
          l[i] += p0 + p1;  // the f32 p, before the bf16 rounding
          a[r] = pack_bf16(p0, p1);
        }
        wgmma_fence();  // a was written since the last wgmma
        wgmma_rs<D>(acc, a, vmajor_desc<D>(vt_s, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= w_rows) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    __nv_bfloat16* dst =
        og + static_cast<size_t>(wq0 + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          acc[4 * n + 2 * i] / denom, acc[4 * n + 2 * i + 1] / denom);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t_q, int t_k, int q_offset, int k_offset,
                   int causal, float scale, cudaStream_t stream) {
  // + 1024: the kernel aligns its tiles to 1024 bytes
  const size_t bytes = Layout<D>::SMEM_BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_wgmma_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      t_q, t_k, q_offset, k_offset, causal, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, o: [bh, t_q, d]; k, v: [bh, t_k, d]; all contiguous bfloat16 (dtype 1)
// with 16-byte aligned data. Launches on `stream` and returns the launch
// status (cudaGetLastError); it does not synchronise.
extern "C" int v6t_flash_attention_fwd_tc(const void* q, const void* k,
                                          const void* v, void* o, int dtype,
                                          int bh, int t_q, int t_k, int d,
                                          int q_offset, int k_offset,
                                          int causal, float scale,
                                          void* stream) {
  if (dtype != 1 || bh <= 0 || t_q <= 0 || t_k < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
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
