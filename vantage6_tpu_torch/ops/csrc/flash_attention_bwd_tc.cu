// Flash-attention backward on the tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's backward
// (vantage6_tpu/ops/flash_attention.py::_attention_bwd) is plain jnp, and
// the port first carried it over as plain PyTorch (_attention_bwd in
// ops/flash_attention.py), which casts every operand to f32, runs its
// products on the CUDA cores, computes every [Tq, 128] score block, the
// causally invisible ones too, and writes s, p, dp and ds to device memory
// as f32 tensors. In a bf16 GPT-2-medium round at 1024 tokens on an H100
// that plain backward took 72% of the device time. This kernel computes the
// same gradients for bf16 q, k, v, o and dO at head dims up to 192, with the
// precision the configuration states: every product (S = Q K^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) takes bf16 operands
// on the tensor cores with f32 accumulation; the row statistics, the
// exponentials, P, dP - D and dS are f32, and P and dS are rounded to bf16
// only where they enter a product, as the forward rounds P for P V.
//
// What it computes, per (batch * head), with scores masked as the forward
// masks them (keys at or past Tk; causally, q_offset + row < k_offset +
// col) and c = scale * log2(e):
//   L = m + log2(l), from the online max m (floored at -1e20 * log2(e))
//       and sum l of 2^(c s) over the visible keys; l = 0 (a fully masked
//       row) keeps L = m, so every P of that row is 0;
//   D = rowsum(dO o), in f32 from the bf16 values;
//   P = 2^(c s - L); dS = P (dP - D);
//   dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO.
// L is _attention_bwd's m + log(l) in log2 units: the same P to a few f32
// ulps, far below the bf16 rounding of P that follows.
//
// Bounds (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s, 132 SMs at 1.98 GHz, 16
// ex2 a clock per SM). The work the gradients need is the Q K^T recompute
// and the dV, dP, dQ and dK products, 10 D operations a visible (q, k)
// pair, with q, k, v, o and dO read and dq, dk and dv written once. At
// [B=8, H=16, T=1024, D=64] causal that is 4.30e10 operations, 43.5 us at
// the tensor-core peak, against 134 MB, 40.1 us: the products bound it. At
// [64, 16, 128, 64] causal the same bytes take 40.1 us and the products
// 5.5 us: the bytes bound it. The design spends products and exps to keep
// every score block out of device memory and to need no atomics: it issues
// 16 D operations a visible pair (S twice and dP in the dQ kernel, S and dP
// again in the dK/dV kernel), so at most about 62% of the products' bound is
// reachable at 1024 tokens, and three exps a pair (2.0e8 at 1024 tokens,
// 48 us at the special-function units' rate), which overlap the products of
// the slice before. At 128 tokens it reads q and dO twice, k and v twice and
// writes two f32 row statistics: about 1.5 times the least bytes.
//
// Design. Two kernels a call, each block one warpgroup (128 threads) that
// owns 64 rows of one axis and walks 64-row tiles of the other, so both
// work on the same grid of 64 x 64 tile pairs; on causal calls a pair in
// which every query precedes every key is skipped whole (it adds exactly
// 0), halving the work. No output is summed by more than one block, so no
// atomics: the same inputs give the same bits, run after run.
// - flash_bwd_dq_kernel: per 64 query rows, Q and dO loaded once; K tiles
//   (then K and V tiles) stream through a two-stage cp.async ring. Pass 1
//   runs S = Q K^T over the visible key tiles for m and l, and writes L; D
//   comes from dO and o read row by row. Pass 2 runs S and dP = dO V^T, P
//   and dS in registers, and dQ += dS K with dS from registers and K read
//   MN-major (as the forward reads V). dQ, L and D are written once.
// - flash_bwd_dkdv_kernel: per 64 keys, K and V loaded once; Q, dO and
//   their rows of L and D stream through the ring. It computes the
//   transposed blocks S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come
//   out of the accumulators already in wgmma's register A layout (rows:
//   keys): dV += P^T dO and dK += dS^T Q run with P^T and dS^T from
//   registers and dO and Q read MN-major. P^T and dS^T never leave the
//   registers.
// - Tiles are bf16 in shared memory in the swizzled layout wgmma reads
//   (128-byte swizzle for W >= 64, 64-byte for W = 32, 32-byte for
//   W = 16), as in flash_attention_tc.cu. The kernel is instantiated at
//   W = 16, 32, 64 and 128; a call at head dim d (a multiple of 8, the
//   wrapper pads) runs the narrowest W >= d and zero-fills its tiles from d
//   up to W, so the padded depth adds 0 and the padded output columns are
//   never stored. Rows past Tq or Tk are zero-filled by the copy and
//   masked.
// - The softmax is computed in registers: each accumulator row lies on the
//   4 lanes of a quad (row max and row sum are two xor shuffles). P and dS
//   are packed to bf16 one k16 slice at a time, each slice's products
//   issued as soon as it is packed.
//
// Head dims 129-192 run a W = 192 pair of their own (launch_w192), chosen by
// head dim, which leaves the narrower widths' kernels as they are. At 192
// columns a block's tiles fill most of an SM's shared memory, so one block
// runs an SM, and each block is two warpgroups (8 warps) so that one's
// exponentials overlap the other's products. flash_bwd_dq_w192_kernel: each
// warpgroup is flash_bwd_dq_kernel for its own 64 query rows (dQ, S and dP,
// 96 + 32 + 32 registers a thread), the two reading one K/V ring (192 KB in
// all). One warpgroup cannot hold dK and dV at 192 columns (96 + 96
// registers, besides S^T and dP^T), so flash_bwd_dkdv_w192_kernel splits a
// 64-key tile over two warpgroups, one accumulator each: the first computes
// S^T, P^T and dV, the second dP^T, dS^T and dK, with P^T handed over in f32
// through shared memory (162 KB in all). The latent attention of DeepSeek-V3's
// block (q/k 192, v 128 zero-padded to 192) calls it at [8, 16, 2048, 192]
// causal in the benchmark: 268.6M visible pairs, whose work at the true
// widths, 2 (3 x 192 + 2 x 128) operations a pair, takes 0.452 ms at the
// tensor-core peak, against 0.24 ms for q, k, v, o and dO read and dq, dk
// and dv written once at 192 columns: the products bound it. The pair
// issues 16 x 192 operations a visible pair, 0.83 ms at the peak, so at
// most some 54% of that bound is reachable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // rows of every tile: a warpgroup's M
constexpr int THREADS = 128;  // one warpgroup a block
constexpr int STAGES = 2;     // the streamed tiles' ring
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;

// A [TILE, D] bf16 tile in shared memory in wgmma's canonical swizzled
// layout (D is the instantiated width W): D is cut into column blocks of
// ATOM elements (one swizzle row of ROW_BYTES), each block stores its rows
// ROW_BYTES apart, and the 16-byte chunk c of row r lands at chunk c ^ f(r)
// (see swizzle()). Tiles start on 1024-byte boundaries.
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
  static constexpr uint32_t TILE_BYTES = TILE * D * 2;
  // dQ kernel: Q, dO, and STAGES (K, V) pairs
  static constexpr uint32_t DQ_SMEM = 2 * TILE_BYTES + STAGES * 2 * TILE_BYTES;
  // dK/dV kernel: K, V, and STAGES (Q, dO, L and D rows) stages, each
  // rounded up to 1024 bytes
  static constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES + 1024;
  static constexpr uint32_t DKDV_SMEM = 2 * TILE_BYTES + STAGES * STAGE_BYTES;
  // blocks per SM the registers must allow (dQ kernel: dq, s and dp; the
  // dK/dV kernel holds dk and dv besides s and dp)
  static constexpr int DQ_MIN_BLOCKS = D <= 64 ? 3 : 2;
  static constexpr int DKDV_MIN_BLOCKS = 2;
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

// Copy rows [row0, row0 + TILE) of a row-major [t, d] matrix (d a multiple
// of 8) into a swizzled W = D tile at shared address dst. Rows at or past t
// and columns at or past d are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int t, int d, int tid) {
  using L = Layout<D>;
  constexpr int N = TILE * L::CHUNKS;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (N % THREADS == 0 || c < N) {
      const int row = c / L::CHUNKS;
      const int cc = c % L::CHUNKS;
      const uint32_t off = (cc / L::ATOM_CHUNKS) * TILE * L::ROW_BYTES +
                           row * L::ROW_BYTES + (cc % L::ATOM_CHUNKS) * 16;
      const bool in = row0 + row < t && cc * 8 < d;
      const __nv_bfloat16* g =
          src + (in ? static_cast<size_t>(row0 + row) * d + cc * 8 : 0);
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

// K-major operand: k16 slice `ks` (columns [16 ks, 16 ks + 16)) of a tile.
// Groups of 8 rows are 8 * ROW_BYTES apart (SBO); a k16 slice is 32 bytes
// into its swizzle row (LBO unused by swizzled K-major).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks) {
  using L = Layout<D>;
  const uint32_t addr = tile + (ks * 16 / L::ATOM) * TILE * L::ROW_BYTES +
                        (ks * 16 % L::ATOM) * 2;
  return make_desc(addr, 16, 8 * L::ROW_BYTES, L::MODE);
}

// MN-major operand: a tile [rows, D] read as the B operand [K = rows,
// N = D] of a product (K for dQ, dO for dV, Q for dK); k16 slice `kk`
// holds rows [16 kk, 16 kk + 16). Groups of 8 rows are 8 * ROW_BYTES apart
// (SBO); column blocks of ATOM values are a whole column block of the tile
// apart (LBO).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using L = Layout<D>;
  return make_desc(tile + kk * 16 * L::ROW_BYTES, TILE * L::ROW_BYTES,
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

// A 64 x 64 block of scores, both operands K-major from shared memory.
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

// acc += A B with A from registers (a k16 slice of P, P^T, dS or dS^T) and
// B MN-major from shared memory (imm-trans-b = 1); N = D.
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

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
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

// wgmma's register A fragment of k16 slice kk of a 64 x 64 accumulator:
// columns [16kk, 16kk + 16), rows i = 0, 1 of column blocks n = 2kk and
// 2kk + 1, in the order {(n0, i0), (n0, i1), (n1, i0), (n1, i1)}
__device__ __forceinline__ void a_fragment(const float (&x)[32], int kk,
                                           uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = 2 * kk + r / 2;
    const int i = r % 2;
    a[r] = pack_bf16(x[4 * n + 2 * i], x[4 * n + 2 * i + 1]);
  }
}

// Rows [row0, row0 + 8) of the thread's accumulator, times `mul`, to rows
// [g0 + row, ...) of a row-major bf16 [*, d] matrix: rows at or past
// n_rows and columns at or past d are not stored.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, __nv_bfloat16* out,
                                           int g0, int row0, int n_rows,
                                           int d, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= n_rows) continue;
    __nv_bfloat16* dst =
        out + static_cast<size_t>(g0 + row) * d + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * mul,
                                  acc[4 * n + 2 * i + 1] * mul);
  }
}

// dQ, L and D for 64 query rows (q0 = this block's first). D is the
// instantiated width W; d (a multiple of 8, at most D) is the head dim and
// row stride in device memory; PAD = false is the instantiation for
// d == D. lse and delta are [bh, lse_rows] f32 (lse_rows = Tq rounded up
// to 64); rows at or past Tq get 0.
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS, Layout<D>::DQ_MIN_BLOCKS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
                    float* __restrict__ delta, int t_q, int t_k, int d_arg,
                    int lse_rows, int q_offset, int k_offset, int causal,
                    float scale_log2, float scale) {
  using L = Layout<D>;
  const int d = PAD ? d_arg : D;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float delta_s[TILE];
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t do_s = q_s + L::TILE_BYTES;
  const uint32_t kv_s = do_s + L::TILE_BYTES;  // STAGES (K, V) pairs

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;  // heaviest first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t q_base = static_cast<size_t>(bh) * t_q * d;
  const size_t k_base = static_cast<size_t>(bh) * t_k * d;
  const __nv_bfloat16* qg = q + q_base;
  const __nv_bfloat16* og = o + q_base;
  const __nv_bfloat16* dog = dout + q_base;
  const __nv_bfloat16* kg = k + k_base;
  const __nv_bfloat16* vg = v + k_base;

  const int w_rows = min(TILE, t_q - q0);  // > 0: the grid covers Tq
  const int r_lo = q_offset + q0;
  const int r_hi = r_lo + w_rows - 1;
  // this thread's two rows: 16 * warp + lane / 4, and 8 below it
  const int row0 = warp * 16 + lane / 4;
  const int pos0 = r_lo + row0;  // global position of row0
  // keys any row can see (k_valid = t_k; causal horizon)
  int k_end = t_k;
  if (causal) k_end = min(t_k, r_hi - k_offset + 1);
  const int n_kt = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;
  const int n_steps = 2 * n_kt;  // pass 1, then pass 2, over the key tiles

  // step j stages key tile j % n_kt: K in pass 1, K and V in pass 2
  auto stage_in = [&](int j) {
    const int kt = j % n_kt;
    const uint32_t st = kv_s + (j % STAGES) * 2 * L::TILE_BYTES;
    load_tile<D>(st, kg, kt * TILE, t_k, d, tid);
    if (j >= n_kt)
      load_tile<D>(st + L::TILE_BYTES, vg, kt * TILE, t_k, d, tid);
  };
  load_tile<D>(q_s, qg, q0, t_q, d, tid);
  load_tile<D>(do_s, dog, q0, t_q, d, tid);
  cp_async_commit();
  if (n_steps > 0) stage_in(0);
  cp_async_commit();

  // D = rowsum(dO o) in f32, two threads a row, while the tiles load
  {
    const int row = tid / 2;
    float acc = 0.f;
    if (q0 + row < t_q) {
      const __nv_bfloat16* a = dog + static_cast<size_t>(q0 + row) * d;
      const __nv_bfloat16* b = og + static_cast<size_t>(q0 + row) * d;
      for (int c = tid % 2; c < d / 8; c += 2) {
        const uint4 x = *reinterpret_cast<const uint4*>(a + 8 * c);
        const uint4 y = *reinterpret_cast<const uint4*>(b + 8 * c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) delta_s[row] = acc;
  }
  __syncthreads();
  float dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) dlt[i] = delta_s[row0 + 8 * i];

  float acc[D / 2];
  float s[32];
  float dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float m_floor = M_FLOOR * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  // scores of key tile kt in log2 units, s * c, masked ones -inf
  auto scale_mask = [&](int kt) {
    const int k0 = kt * TILE;
    const int kv = min(TILE, t_k - k0);
    const bool full =
        kv == TILE && (!causal || r_lo >= k_offset + k0 + kv - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i % 2);
      const int pos = pos0 + 8 * ((i / 2) % 2);
      const bool ok =
          full || (col < t_k && (!causal || pos >= k_offset + col));
      s[i] = ok ? s[i] * scale_log2 : -INFINITY;
    }
  };

  int j = 0;
  // pass 1: the online max and sum of each row
  for (int kt = 0; kt < n_kt; ++kt, ++j) {
    if (j + 1 < n_steps) stage_in(j + 1);  // in flight during this step
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: step j has landed
    // the copies wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t k_t = kv_s + (j % STAGES) * 2 * L::TILE_BYTES;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(s, kmajor_desc<D>(q_s, ks), kmajor_desc<D>(k_t, ks),
                   ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    scale_mask(kt);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(fmaxf(m[i], mx), m_floor);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        sum += exp2_approx(s[4 * n + 2 * i] - m_new) +
               exp2_approx(s[4 * n + 2 * i + 1] - m_new);
      l[i] = l[i] * exp2_approx(m[i] - m_new) + sum;
      m[i] = m_new;
    }
    __syncthreads();  // the next step refills the other stage: this one is
                      // free for the step after it
  }
  // L = m + log2(l) over the quad's sums; l == 0 (fully masked) keeps m
  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lse_r[i] = l[i] > 0.f ? m[i] + log2f(l[i]) : fmaxf(m[i], m_floor);
  }

  // pass 2: P, dS and dQ += dS K
  for (int kt = 0; kt < n_kt; ++kt, ++j) {
    if (j + 1 < n_steps) stage_in(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t k_t = kv_s + (j % STAGES) * 2 * L::TILE_BYTES;
    const uint32_t v_t = k_t + L::TILE_BYTES;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(s, kmajor_desc<D>(q_s, ks), kmajor_desc<D>(k_t, ks),
                   ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(dp, kmajor_desc<D>(do_s, ks), kmajor_desc<D>(v_t, ks),
                   ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    scale_mask(kt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float p = exp2_approx(s[i] - lse_r[r]);
      s[i] = p * (dp[i] - dlt[r]);  // dS, f32
    }
    // dQ += dS K, one k16 slice of dS (16 keys) at a time
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a[4];
      a_fragment(s, kk, a);
      wgmma_fence();  // a was written since the last wgmma
      wgmma_rs<D>(acc, a, mnmajor_desc<D>(k_t, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<D>(acc, scale, dq, bh * t_q + q0, row0, w_rows, d, lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const size_t g = static_cast<size_t>(bh) * lse_rows + q0 + row;
      lse[g] = row < w_rows ? lse_r[i] : 0.f;
      delta[g] = row < w_rows ? dlt[i] : 0.f;
    }
  }
}

// dK and dV for 64 keys (k0 = this block's first), from L and D of the dQ
// kernel. The block computes S^T = K Q^T and dP^T = V dO^T: rows are keys,
// columns queries.
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS, Layout<D>::DKDV_MIN_BLOCKS)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int t_q, int t_k,
                      int d_arg, int lse_rows, int q_offset, int k_offset,
                      int causal, float scale_log2, float scale) {
  using L = Layout<D>;
  const int d = PAD ? d_arg : D;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + L::TILE_BYTES;
  const uint32_t ring = v_s + L::TILE_BYTES;  // STAGES (Q, dO, L, D) stages

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * TILE;  // causal: the first keys are heaviest
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t q_base = static_cast<size_t>(bh) * t_q * d;
  const size_t k_base = static_cast<size_t>(bh) * t_k * d;
  const __nv_bfloat16* qg = q + q_base;
  const __nv_bfloat16* dog = dout + q_base;
  const float* lse_g = lse + static_cast<size_t>(bh) * lse_rows;
  const float* delta_g = delta + static_cast<size_t>(bh) * lse_rows;

  const int kv = min(TILE, t_k - k0);  // > 0: the grid covers Tk
  const int c_lo = k_offset + k0;
  const int c_hi = c_lo + kv - 1;
  const int n_qt = (t_q + TILE - 1) / TILE;
  // the first query tile that sees a key of this tile (causal horizon)
  int qt0 = 0;
  if (causal) {
    const int need = c_lo - q_offset;  // the first query that sees key k0
    qt0 = need > t_q - 1 ? n_qt : max(need, 0) / TILE;
  }
  const int n_steps = n_qt - qt0;

  auto stage_in = [&](int j) {
    const int q0 = (qt0 + j) * TILE;
    const uint32_t st = ring + (j % STAGES) * L::STAGE_BYTES;
    load_tile<D>(st, qg, q0, t_q, d, tid);
    load_tile<D>(st + L::TILE_BYTES, dog, q0, t_q, d, tid);
    if (tid < 32) {  // 64 L and 64 D values: 16 chunks each
      const float* src = (tid < 16 ? lse_g : delta_g) + q0 + 4 * (tid % 16);
      cp_async16(st + 2 * L::TILE_BYTES + (tid / 16) * 256 + 16 * (tid % 16),
                 src, 16);
    }
  };
  load_tile<D>(k_s, k + k_base, k0, t_k, d, tid);
  load_tile<D>(v_s, v + k_base, k0, t_k, d, tid);
  cp_async_commit();
  if (n_steps > 0) stage_in(0);
  cp_async_commit();

  // this thread's two key rows: 16 * warp + lane / 4, and 8 below it
  const int row0 = warp * 16 + lane / 4;
  float acc_dk[D / 2];
  float acc_dv[D / 2];
  float s[32];
  float dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    if (j + 1 < n_steps) stage_in(j + 1);  // in flight during this step
    cp_async_commit();
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int q0 = (qt0 + j) * TILE;
    const uint32_t q_t = ring + (j % STAGES) * L::STAGE_BYTES;
    const uint32_t do_t = q_t + L::TILE_BYTES;
    const float* lse_s =
        reinterpret_cast<const float*>(smem_raw + (q_t - raw) +
                                       2 * L::TILE_BYTES);
    const float* delta_s = lse_s + TILE;

    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(s, kmajor_desc<D>(k_s, ks), kmajor_desc<D>(q_t, ks),
                   ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(dp, kmajor_desc<D>(v_s, ks), kmajor_desc<D>(do_t, ks),
                   ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T: rows are keys k0 + row0 (+ 8), columns queries q0 + col
    const int qv = min(TILE, t_q - q0);
    const bool full = kv == TILE && qv == TILE &&
                      (!causal || q_offset + q0 >= c_hi);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      const float2 lq = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dq2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + row0 + 8 * i;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int e = 4 * n + 2 * i + jj;
          const int query = q0 + col + jj;
          const bool ok =
              full || (key < t_k && query < t_q &&
                       (!causal || q_offset + query >= k_offset + key));
          const float x = ok ? s[e] * scale_log2 : -INFINITY;
          const float p = exp2_approx(x - (jj ? lq.y : lq.x));
          s[e] = p;                                  // P^T, f32
          dp[e] = p * (dp[e] - (jj ? dq2.y : dq2.x));  // dS^T, f32
        }
      }
    }
    // dV += P^T dO and dK += dS^T Q, one k16 slice (16 queries) at a time
    fence_regs(acc_dv);
    fence_regs(acc_dk);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a_p[4];
      uint32_t a_ds[4];
      a_fragment(s, kk, a_p);
      a_fragment(dp, kk, a_ds);
      wgmma_fence();
      wgmma_rs<D>(acc_dv, a_p, mnmajor_desc<D>(do_t, kk));
      wgmma_rs<D>(acc_dk, a_ds, mnmajor_desc<D>(q_t, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    __syncthreads();  // this stage is free for the step after the next
  }
  cp_async_wait<0>();
  store_rows<D>(acc_dk, scale, dk, bh * t_k + k0, row0, kv, d, lane);
  store_rows<D>(acc_dv, 1.f, dv, bh * t_k + k0, row0, kv, d, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int bh, int t_q,
                   int t_k, int d, int lse_rows, int q_offset, int k_offset,
                   int causal, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  const float scale_log2 = scale * LOG2E;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  // + 1024: the kernels align their tiles to 1024 bytes
  if (t_q > 0) {
    const size_t bytes = L::DQ_SMEM + 1024;
    auto kernel = d == D ? flash_bwd_dq_kernel<D, false>
                         : flash_bwd_dq_kernel<D, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (t_q + TILE - 1) / TILE);
    kernel<<<grid, THREADS, bytes, stream>>>(
        qb, kb, vb, ob, dob, static_cast<__nv_bfloat16*>(dq), lse, delta,
        t_q, t_k, d, lse_rows, q_offset, k_offset, causal, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (t_k > 0) {
    const size_t bytes = L::DKDV_SMEM + 1024;
    auto kernel = d == D ? flash_bwd_dkdv_kernel<D, false>
                         : flash_bwd_dkdv_kernel<D, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (t_k + TILE - 1) / TILE);
    kernel<<<grid, THREADS, bytes, stream>>>(
        qb, kb, vb, dob, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), t_q, t_k, d, lse_rows, q_offset,
        k_offset, causal, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Named barrier 1 over `threads` threads: arrive signals without waiting,
// sync waits for the others' arrival (barrier 0 is __syncthreads). The
// shared-memory writes a thread made before its arrive are visible to the
// threads past the sync.
__device__ __forceinline__ void named_bar_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// dQ, L and D at W = 192 for 128 query rows: two warpgroups, each computing
// what flash_bwd_dq_kernel computes for its own 64 rows (its Q and dO tiles
// loaded once), over one K/V ring that both read, so the block streams each
// key tile once for 128 rows and one warpgroup's exponentials overlap the
// other's products. The block walks the key tiles that its lower rows see;
// a tile that none of a warpgroup's rows sees is skipped by that
// warpgroup, which still takes part in the ring's barriers. Where Tq ends
// inside the block's first 64 rows, the second warpgroup's rows are all
// past it: it computes nothing and stores nothing.
template <bool PAD>
__global__ void __launch_bounds__(2 * THREADS, 1)
flash_bwd_dq_w192_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         __nv_bfloat16* __restrict__ dq,
                         float* __restrict__ lse, float* __restrict__ delta,
                         int t_q, int t_k, int d_arg, int lse_rows,
                         int q_offset, int k_offset, int causal,
                         float scale_log2, float scale) {
  constexpr int D = 192;
  using L = Layout<D>;
  const int d = PAD ? d_arg : D;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float delta_s[2 * TILE];
  const int wg = threadIdx.x / THREADS;
  const int tid = threadIdx.x % THREADS;
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t q_s = base + wg * 2 * L::TILE_BYTES;  // this warpgroup's
  const uint32_t do_s = q_s + L::TILE_BYTES;
  const uint32_t kv_s = base + 4 * L::TILE_BYTES;  // STAGES (K, V) pairs

  const int bh = blockIdx.x;
  const int b0 = (gridDim.y - 1 - blockIdx.y) * 2 * TILE;  // heaviest first
  const int q0 = b0 + wg * TILE;  // this warpgroup's first row
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t q_base = static_cast<size_t>(bh) * t_q * d;
  const size_t k_base = static_cast<size_t>(bh) * t_k * d;
  const __nv_bfloat16* qg = q + q_base;
  const __nv_bfloat16* og = o + q_base;
  const __nv_bfloat16* dog = dout + q_base;
  const __nv_bfloat16* kg = k + k_base;
  const __nv_bfloat16* vg = v + k_base;

  const int w_rows = min(TILE, t_q - q0);  // <= 0: no row of this warpgroup
  const int r_lo = q_offset + q0;
  const int r_hi = r_lo + w_rows - 1;
  // this thread's two rows: 16 * warp + lane / 4, and 8 below it
  const int row0 = warp * 16 + lane / 4;
  const int pos0 = r_lo + row0;  // global position of row0
  // key tiles the block walks (its last row's causal horizon) and the ones
  // this warpgroup's rows see
  int k_end = t_k;
  if (causal)
    k_end = min(t_k, q_offset + min(b0 + 2 * TILE, t_q) - 1 - k_offset + 1);
  const int n_kt = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;
  int k_end_w = w_rows > 0 ? t_k : 0;
  if (causal && w_rows > 0) k_end_w = min(t_k, r_hi - k_offset + 1);
  const int n_kt_w = k_end_w > 0 ? (k_end_w + TILE - 1) / TILE : 0;
  const int n_steps = 2 * n_kt;  // pass 1, then pass 2, over the key tiles

  // step j stages key tile j % n_kt: K in pass 1 (the first warpgroup
  // copies it), K and V in pass 2 (one warpgroup each)
  auto stage_in = [&](int j) {
    const int kt = j % n_kt;
    const uint32_t st = kv_s + (j % STAGES) * 2 * L::TILE_BYTES;
    if (wg == 0)
      load_tile<D>(st, kg, kt * TILE, t_k, d, tid);
    else if (j >= n_kt)
      load_tile<D>(st + L::TILE_BYTES, vg, kt * TILE, t_k, d, tid);
  };
  load_tile<D>(q_s, qg, q0, t_q, d, tid);
  load_tile<D>(do_s, dog, q0, t_q, d, tid);
  cp_async_commit();
  if (n_steps > 0) stage_in(0);
  cp_async_commit();

  // D = rowsum(dO o) in f32, two threads a row, while the tiles load
  {
    const int row = tid / 2;
    float acc = 0.f;
    if (q0 + row < t_q) {
      const __nv_bfloat16* a = dog + static_cast<size_t>(q0 + row) * d;
      const __nv_bfloat16* b = og + static_cast<size_t>(q0 + row) * d;
      for (int c = tid % 2; c < d / 8; c += 2) {
        const uint4 x = *reinterpret_cast<const uint4*>(a + 8 * c);
        const uint4 y = *reinterpret_cast<const uint4*>(b + 8 * c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) delta_s[wg * TILE + row] = acc;
  }
  __syncthreads();
  float dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) dlt[i] = delta_s[wg * TILE + row0 + 8 * i];

  float acc[D / 2];
  float s[32];
  float dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float m_floor = M_FLOOR * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  // scores of key tile kt in log2 units, s * c, masked ones -inf
  auto scale_mask = [&](int kt) {
    const int k0 = kt * TILE;
    const int kv = min(TILE, t_k - k0);
    const bool full =
        kv == TILE && (!causal || r_lo >= k_offset + k0 + kv - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i % 2);
      const int pos = pos0 + 8 * ((i / 2) % 2);
      const bool ok =
          full || (col < t_k && (!causal || pos >= k_offset + col));
      s[i] = ok ? s[i] * scale_log2 : -INFINITY;
    }
  };

  int j = 0;
  // pass 1: the online max and sum of each row
  for (int kt = 0; kt < n_kt; ++kt, ++j) {
    if (j + 1 < n_steps) stage_in(j + 1);  // in flight during this step
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: step j has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt < n_kt_w) {
      const uint32_t k_t = kv_s + (j % STAGES) * 2 * L::TILE_BYTES;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s, kmajor_desc<D>(q_s, ks), kmajor_desc<D>(k_t, ks),
                     ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      scale_mask(kt);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(fmaxf(m[i], mx), m_floor);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          sum += exp2_approx(s[4 * n + 2 * i] - m_new) +
                 exp2_approx(s[4 * n + 2 * i + 1] - m_new);
        l[i] = l[i] * exp2_approx(m[i] - m_new) + sum;
        m[i] = m_new;
      }
    }
    __syncthreads();  // the next step refills the other stage: this one is
                      // free for the step after it
  }
  // L = m + log2(l) over the quad's sums; l == 0 (fully masked) keeps m
  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lse_r[i] = l[i] > 0.f ? m[i] + log2f(l[i]) : fmaxf(m[i], m_floor);
  }

  // pass 2: P, dS and dQ += dS K
  for (int kt = 0; kt < n_kt; ++kt, ++j) {
    if (j + 1 < n_steps) stage_in(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt < n_kt_w) {
      const uint32_t k_t = kv_s + (j % STAGES) * 2 * L::TILE_BYTES;
      const uint32_t v_t = k_t + L::TILE_BYTES;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s, kmajor_desc<D>(q_s, ks), kmajor_desc<D>(k_t, ks),
                     ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(dp, kmajor_desc<D>(do_s, ks), kmajor_desc<D>(v_t, ks),
                     ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      scale_mask(kt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        const float p = exp2_approx(s[i] - lse_r[r]);
        s[i] = p * (dp[i] - dlt[r]);  // dS, f32
      }
      // dQ += dS K, one k16 slice of dS (16 keys) at a time
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t a[4];
        a_fragment(s, kk, a);
        wgmma_fence();  // a was written since the last wgmma
        wgmma_rs<D>(acc, a, mnmajor_desc<D>(k_t, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (w_rows <= 0) return;
  store_rows<D>(acc, scale, dq, bh * t_q + q0, row0, w_rows, d, lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const size_t g = static_cast<size_t>(bh) * lse_rows + q0 + row;
      lse[g] = row < w_rows ? lse_r[i] : 0.f;
      delta[g] = row < w_rows ? dlt[i] : 0.f;
    }
  }
}

// dK and dV for 64 keys at W = 192 (head dims 129-192), from L and D of the
// dQ kernel, with the same grid, ring and masking as flash_bwd_dkdv_kernel.
// One warpgroup cannot hold dK and dV at 192 columns (96 + 96 registers a
// thread, besides S^T and dP^T), so a block is two warpgroups over the same
// 64 keys, each holding one accumulator and running the same sequence of
// products on other operands:
//   warpgroup 0: S^T = K Q^T, P^T (f32), dV += P^T dO;
//   warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - D) (f32), dK += dS^T Q,
// with P^T handed from 0 to 1 in f32 through shared memory under a named
// barrier, so dS^T is formed from the same f32 P as in one warpgroup.
// Warpgroup 0 copies each step's Q and its L and D rows, warpgroup 1 its dO.
template <bool PAD>
__global__ void __launch_bounds__(2 * THREADS, 1)
flash_bwd_dkdv_w192_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int t_q, int t_k,
                           int d_arg, int lse_rows, int q_offset,
                           int k_offset, int causal, float scale_log2,
                           float scale) {
  constexpr int D = 192;
  using L = Layout<D>;
  const int d = PAD ? d_arg : D;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + L::TILE_BYTES;
  const uint32_t ring = v_s + L::TILE_BYTES;  // STAGES (Q, dO, L, D) stages
  // P^T, f32: element 4c + r of thread t at float4 c * THREADS + t
  float4* const p_x = reinterpret_cast<float4*>(
      smem_raw + (ring + STAGES * L::STAGE_BYTES - raw));

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * TILE;  // causal: the first keys are heaviest
  const int wg = threadIdx.x / THREADS;  // 0: P^T and dV; 1: dS^T and dK
  const int tid = threadIdx.x % THREADS;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t q_base = static_cast<size_t>(bh) * t_q * d;
  const size_t k_base = static_cast<size_t>(bh) * t_k * d;
  const __nv_bfloat16* qg = q + q_base;
  const __nv_bfloat16* dog = dout + q_base;
  const float* lse_g = lse + static_cast<size_t>(bh) * lse_rows;
  const float* delta_g = delta + static_cast<size_t>(bh) * lse_rows;

  const int kv = min(TILE, t_k - k0);  // > 0: the grid covers Tk
  const int c_lo = k_offset + k0;
  const int c_hi = c_lo + kv - 1;
  const int n_qt = (t_q + TILE - 1) / TILE;
  // the first query tile that sees a key of this tile (causal horizon)
  int qt0 = 0;
  if (causal) {
    const int need = c_lo - q_offset;  // the first query that sees key k0
    qt0 = need > t_q - 1 ? n_qt : max(need, 0) / TILE;
  }
  const int n_steps = n_qt - qt0;

  auto stage_in = [&](int j) {
    const int q0 = (qt0 + j) * TILE;
    const uint32_t st = ring + (j % STAGES) * L::STAGE_BYTES;
    if (wg == 1) {
      load_tile<D>(st + L::TILE_BYTES, dog, q0, t_q, d, tid);
      return;
    }
    load_tile<D>(st, qg, q0, t_q, d, tid);
    if (tid < 32) {  // 64 L and 64 D values: 16 chunks each
      const float* src = (tid < 16 ? lse_g : delta_g) + q0 + 4 * (tid % 16);
      cp_async16(st + 2 * L::TILE_BYTES + (tid / 16) * 256 + 16 * (tid % 16),
                 src, 16);
    }
  };
  load_tile<D>(wg == 0 ? k_s : v_s, (wg == 0 ? k : v) + k_base, k0, t_k, d,
               tid);
  cp_async_commit();
  if (n_steps > 0) stage_in(0);
  cp_async_commit();

  // this thread's two key rows: 16 * warp + lane / 4, and 8 below it
  const int row0 = warp * 16 + lane / 4;
  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
  float x[32];       // S^T, then P^T (0); dP^T, then dS^T (1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    if (j + 1 < n_steps) stage_in(j + 1);  // in flight during this step
    cp_async_commit();
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int q0 = (qt0 + j) * TILE;
    const uint32_t q_t = ring + (j % STAGES) * L::STAGE_BYTES;
    const uint32_t do_t = q_t + L::TILE_BYTES;
    const float* lse_s =
        reinterpret_cast<const float*>(smem_raw + (q_t - raw) +
                                       2 * L::TILE_BYTES);
    const float* delta_s = lse_s + TILE;

    // S^T = K Q^T (0) or dP^T = V dO^T (1)
    const uint32_t a_t = wg == 0 ? k_s : v_s;
    const uint32_t b_t = wg == 0 ? q_t : do_t;
    fence_regs(x);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(x, kmajor_desc<D>(a_t, ks), kmajor_desc<D>(b_t, ks),
                   ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);

    // rows are keys k0 + row0 (+ 8), columns queries q0 + col
    if (wg == 0) {
      const int qv = min(TILE, t_q - q0);
      const bool full = kv == TILE && qv == TILE &&
                        (!causal || q_offset + q0 >= c_hi);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        const float2 lq = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + row0 + 8 * i;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int e = 4 * n + 2 * i + jj;
            const int query = q0 + col + jj;
            const bool ok =
                full || (key < t_k && query < t_q &&
                         (!causal || q_offset + query >= k_offset + key));
            const float s = ok ? x[e] * scale_log2 : -INFINITY;
            x[e] = exp2_approx(s - (jj ? lq.y : lq.x));  // P^T, f32
          }
        }
        p_x[n * THREADS + tid] =
            make_float4(x[4 * n], x[4 * n + 1], x[4 * n + 2], x[4 * n + 3]);
      }
      named_bar_arrive(2 * THREADS);
    } else {
      named_bar_sync(2 * THREADS);  // P^T of this step is in p_x
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
        const float4 p = p_x[n * THREADS + tid];
        const float ps[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)  // r = 2 i + jj
          x[4 * n + r] = ps[r] * (x[4 * n + r] - (r % 2 ? dl.y : dl.x));
      }
    }
    // dV += P^T dO (0) or dK += dS^T Q (1), one k16 slice (16 queries) at
    // a time
    const uint32_t c_t = wg == 0 ? do_t : q_t;
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a[4];
      a_fragment(x, kk, a);
      wgmma_fence();
      wgmma_rs<D>(acc, a, mnmajor_desc<D>(c_t, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // this stage and p_x are free for the next steps
  }
  cp_async_wait<0>();
  store_rows<D>(acc, wg == 0 ? 1.f : scale, wg == 0 ? dv : dk,
                bh * t_k + k0, row0, kv, d, lane);
}

// The W = 192 pair, flash_bwd_dq_w192_kernel and flash_bwd_dkdv_w192_kernel,
// launched as launch<D> launches its pair.
cudaError_t launch_w192(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, float* lse, float* delta, int bh, int t_q,
                        int t_k, int d, int lse_rows, int q_offset,
                        int k_offset, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int D = 192;
  using L = Layout<D>;
  // two warpgroups' Q and dO, then the K/V ring
  constexpr uint32_t DQ_SMEM = 4 * L::TILE_BYTES + STAGES * 2 * L::TILE_BYTES;
  // K, V and the ring as flash_bwd_dkdv_kernel's, then P^T in f32
  constexpr uint32_t DKDV_SMEM = L::DKDV_SMEM + 32 * THREADS * 4;
  const float scale_log2 = scale * LOG2E;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  // + 1024: the kernels align their tiles to 1024 bytes
  if (t_q > 0) {
    const size_t bytes = DQ_SMEM + 1024;
    auto kernel = d == D ? flash_bwd_dq_w192_kernel<false>
                         : flash_bwd_dq_w192_kernel<true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (t_q + 2 * TILE - 1) / (2 * TILE));
    kernel<<<grid, 2 * THREADS, bytes, stream>>>(
        qb, kb, vb, ob, dob, static_cast<__nv_bfloat16*>(dq), lse, delta,
        t_q, t_k, d, lse_rows, q_offset, k_offset, causal, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (t_k > 0) {
    const size_t bytes = DKDV_SMEM + 1024;
    auto kernel = d == D ? flash_bwd_dkdv_w192_kernel<false>
                         : flash_bwd_dkdv_w192_kernel<true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (t_k + TILE - 1) / TILE);
    kernel<<<grid, 2 * THREADS, bytes, stream>>>(
        qb, kb, vb, dob, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), t_q, t_k, d, lse_rows, q_offset,
        k_offset, causal, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// q, o, dout, dq: [bh, t_q, d]; k, v, dk, dv: [bh, t_k, d]; all contiguous
// bfloat16 (dtype 1) with 16-byte aligned data, d a multiple of 8 up to
// 192, any finite scale. lse and delta: f32 scratch of [bh, lse_rows],
// lse_rows = t_q rounded up to 64 (the dQ kernel writes them, the dK/dV
// kernel reads them). Launches the two kernels on `stream` in that order,
// checks each launch, and returns the first failing launch status
// (cudaGetLastError) or 0; it does not synchronise.
extern "C" int v6t_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int dtype, int bh, int t_q, int t_k, int d, int lse_rows, int q_offset,
    int k_offset, int causal, float scale, void* stream) {
  if (dtype != 1 || bh <= 0 || t_q < 0 || t_k < 0 || d < 8 || d > 192 ||
      d % 8 != 0 || lse_rows != (t_q + TILE - 1) / TILE * TILE ||
      !std::isfinite(scale))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  auto* dl = static_cast<float*>(delta);
  // the narrowest instantiated width W >= d
  if (d <= 16)
    return launch<16>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, t_q, t_k, d,
                      lse_rows, q_offset, k_offset, causal, scale, s);
  if (d <= 32)
    return launch<32>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, t_q, t_k, d,
                      lse_rows, q_offset, k_offset, causal, scale, s);
  if (d <= 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, t_q, t_k, d,
                      lse_rows, q_offset, k_offset, causal, scale, s);
  if (d <= 128)
    return launch<128>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, t_q, t_k, d,
                       lse_rows, q_offset, k_offset, causal, scale, s);
  return launch_w192(q, k, v, o, dout, dq, dk, dv, l, dl, bh, t_q, t_k, d,
                     lse_rows, q_offset, k_offset, causal, scale, s);
}

extern "C" const char* v6t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
