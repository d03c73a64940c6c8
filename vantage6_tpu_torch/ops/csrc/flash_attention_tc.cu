// Flash-attention forward on the tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vantage6_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_forward through pl.pallas_call) for bf16 inputs at
// every head dim that is a multiple of 8 (the wrapper zero-pads any other D
// up to one). Up to 256 it is instantiated at widths W = 16, 32, 64, 128
// and 256; a call at head dim d runs the narrowest W >= d, loads
// the true d columns of each row and zero-fills the shared-memory tile up
// to W, so the padded depth adds exactly 0 to every score and the padded
// output columns, never stored, are 0. It computes the same function:
// online-softmax attention over [B*H, T, D] with causal masking by global
// position (q_offset + row >= k_offset + col), padded keys masked against
// k_valid = Tk, masked scores giving p = 0 exactly (the TPU kernel's -1e30;
// -inf here), the running max floored at -1e20, m, l and acc in f32 with l
// summed from the f32 p, p rounded to bf16 before p.v, and the output
// acc / (l > 0 ? l : 1), so fully masked rows are exactly 0. The running
// max is kept in log2 units and scale * log2(e) is folded into one FMA,
// p = exp2(s * scale * log2(e) - m) on the special-function unit: the same
// p as exp(s * scale - m) to a few f32 ulps, far below the bf16 rounding
// that follows. The max is that of the scaled scores, so every finite
// scale gives the TPU kernel's softmax: at scale 0 every visible p is 1,
// and a negative scale is applied as |scale| to scores of -q (the block
// negates its Q tile once in shared memory: exact in bf16, and the q.k
// sums come out exactly negated), so the FMA fold stays exact.
//
// Bounds (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s, 132 SMs at 1.98 GHz, 16
// ex2 a clock per SM). At [B=16, H=8, T=1024, D=128] causal the visible
// score entries need 4*D*BH*T*(T+1)/2 = 3.44e10 operations, 34.8 us at the
// tensor-core peak; q, k, v and o move 134 MB, 40.1 us; their 6.72e7 ex2
// take 16.1 us. Bytes and products are close, so both products run on the
// tensor cores and the loads overlap them. At D = 8 the same scores need
// 16 times fewer products and bytes (2.5 us of bytes) but the same 6.72e7
// ex2: the special-function unit bounds it at 16.1 us. D = 8 runs the
// W = 16 instantiation (q.k over a zero-filled k16 depth; P.V at n16, half
// of it on zero columns): the exp rate, not the tensor cores, is what it
// spends, so the design spends no ex2 on invisible tiles (skipped whole,
// below) and issues each slice's ex2 while the tensor cores run the slice
// before. Moving part of the exp onto the FMA pipes is a later change.
// m64n8k16 (wgmma at n = 8, V as it is) was not used: it needs V in the
// unswizzled layout, a second layout for one width that the exp bounds.
//
// Design.
// - One block of two consumer warpgroups (256 threads) per (b*h, 128-row
//   query tile); each warpgroup owns 64 query rows. The grid runs the query
//   tiles in reverse, so the heaviest causal tiles start first and the tail
//   of the grid is short.
// - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared memory
//   (Q and K are [T, D] row-major), over all W / 16 k16 steps: those past
//   the true d add 0 (skipping them under a runtime condition made ptxas
//   serialise the products). O += P V is wgmma m64nWk16 (two m64n128k16
//   at W = 256)
//   with P from registers: the S accumulator, after the softmax and the
//   cast to bf16, is already wgmma's register A fragment for each k16
//   slice; V is the B operand, MN-major (transposed) from shared memory.
// - Tiles stay bf16 in shared memory, in the swizzled layout wgmma reads
//   (128-byte swizzle for W >= 64, 64-byte for W = 32, 32-byte for W = 16).
//   Q is loaded once per block; K/V tiles of 64 keys move through a ring of
//   two stages by 16-byte cp.async, the next tile in flight while the
//   current one is multiplied. Rows past Tq or Tk and columns past d are
//   zero-filled by the copy, so the wrapper makes no padding copies. At
//   W = 128 a block holds 32 KB of Q and 64 KB of K/V stages: two blocks
//   fit on one SM. At W = 256 it holds 64 KB of Q and 128 KB of stages, and
//   the O accumulator takes 128 registers a thread: one block per SM.
// - The softmax runs in registers: each accumulator row lies on the 4 lanes
//   of a quad, so row max and row sum are two xor shuffles. P is built one
//   k16 slice at a time, each slice's wgmma issued as soon as it is packed,
//   which keeps W = 128 within the 128 registers that two blocks per SM
//   allow.
// - Each key tile is classified per warpgroup: fully visible (no mask
//   work), partly visible (per-element causal and k_valid mask), or
//   invisible (skipped: it would add exactly 0). Tiles past the causal
//   horizon of the whole block are never loaded.
//
// Head dims above 256 (flash_fwd_wgmma_wide_kernel). A W = 512 copy of the
// design above fits neither shared memory (128 KB of Q, 256 KB of stages)
// nor the registers (a 256-register O accumulator). So O is cut into
// column slabs of at most SLAB = 256, one more grid dimension: each block
// owns one slab of O, with its own m and l. Every slab needs the whole S =
// Q K^T over the full depth, so each block accumulates S in its 32
// registers over depth chunks of DEPTH = 128 columns: chunk c of the Q tile
// and of the key tile's K move through the two-stage cp.async ring (48 KB
// a stage), the next chunk in flight while this one is multiplied, and the
// key tile's V slab comes in with its first chunk; after the last chunk S
// is whole and the softmax and O += P V run as above on the slab. A depth
// chunk or slab that runs past d is zero-filled by the copy and adds 0, as
// the padded widths do (D = 300 pads to 304: chunks 128, 128 and 48 of
// 128; slabs 256 and 48 of 64). The slabs compute the same S from the same
// operands in the same order, so m, l and p are bit-equal across slabs.
// Full slabs run at W = 256; a tail slab of at most 128 columns runs in a
// second launch at W = 64 or 128, a wider one as one more W = 256 slab. The
// Q tile is reloaded from L2 for every key tile, as it no longer fits
// beside the stages. A negative scale negates S in registers (exact, as
// rounding is symmetric) instead of the Q tile.
// Cost: ceil(d / 256) passes of Q K^T (one per slab) where one would do,
// and as many exps. At [B=4, H=8, T=1024, D=512] causal the visible pairs
// need 4*D*BH*T*(T+1)/2 = 3.44e10 operations, 34.8 us at the bf16 peak,
// and q, k, v and o move 134 MB, 40.1 us: bytes bound it. The kernel
// issues two passes of Q K^T, 5.16e10 operations, 52.2 us at the peak, and
// 3.36e7 exps, 8.0 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 128;  // query rows per block: two warpgroups
constexpr int WG_ROWS = 64;   // query rows per warpgroup (wgmma's M)
constexpr int BLOCK_K = 64;   // keys per K/V tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;     // K/V ring in shared memory (three stages
                              // leave room for one block per SM: slower)
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;

// A [rows, D] bf16 tile in shared memory in wgmma's canonical swizzled
// layout (D is the instantiated width W): D is cut into column blocks of
// ATOM elements (one swizzle row of ROW_BYTES), each block stores its rows
// ROW_BYTES apart, and the 16-byte chunk c of row r lands at chunk c ^ f(r)
// (see swizzle()). Tiles start on 1024-byte boundaries, the period of the
// widest pattern.
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
  // blocks per SM the registers must allow: at W = 256 the O accumulator
  // alone is 128 registers a thread
  static constexpr int MIN_BLOCKS = D == 256 ? 1 : 2;
};

// Head dims above SLAB (the wide kernel): O in slabs of at most SLAB
// columns, S = Q K^T over depth chunks of DEPTH columns.
constexpr int SLAB = 256;
constexpr int DEPTH = 128;

// The wide kernel's shared memory at O slab width W: STAGES stages of a
// [BLOCK_Q, DEPTH] Q chunk (32 KB) and a [BLOCK_K, DEPTH] K chunk (16 KB),
// then STAGES [BLOCK_K, W] V slab tiles (32 KB at W = 256): 160 KB, each
// tile on a 1024-byte boundary.
template <int W>
struct WideLayout {
  static constexpr uint32_t Q_BYTES = Layout<DEPTH>::Q_BYTES;
  static constexpr uint32_t STAGE_BYTES = Q_BYTES + Layout<DEPTH>::KV_BYTES;
  static constexpr uint32_t V_BYTES = Layout<W>::KV_BYTES;
  static constexpr uint32_t SMEM_BYTES = STAGES * (STAGE_BYTES + V_BYTES);
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

// Copy rows [row0, row0 + ROWS) and columns [col0, col0 + D) of a
// row-major [t, d] matrix (d and col0 multiples of 8) into a swizzled W = D
// tile at shared address dst. Rows at or past t and columns at or past d
// are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int t, int d, int tid,
                                          int col0 = 0) {
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
      const bool in = row0 + row < t && col0 + cc * 8 < d;
      const __nv_bfloat16* g =
          src + (in ? static_cast<size_t>(row0 + row) * d + col0 + cc * 8
                    : 0);
      cp_async16(dst + swizzle(off, L::MASK), g, in ? 16 : 0);
    }
  }
}

// Flip the sign of the chunks of a [ROWS, D] tile that this thread copied
// with load_tile (so no barrier is needed between them): -x is exact in
// bf16, and so is every product and sum of q.k with q negated.
template <int D, int ROWS>
__device__ __forceinline__ void negate_tile(uint32_t tile, int tid) {
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
      const uint32_t addr = tile + swizzle(off, L::MASK);
      uint32_t x0, x1, x2, x3;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
                   : "r"(addr));
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                   "r"(x0 ^ 0x80008000u), "r"(x1 ^ 0x80008000u),
                   "r"(x2 ^ 0x80008000u), "r"(x3 ^ 0x80008000u)
                   : "memory");
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

// m64n128k16 into accumulator entries [OFF, OFF + 64) of d
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
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
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]),
        "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]),
        "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]),
        "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]),
        "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]),
        "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]),
        "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]),
        "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]),
        "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]),
        "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]),
        "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]),
        "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]),
        "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]),
        "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]),
        "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_rs_n128<0>(d, a, desc_b);
}

// W = 256: two m64n128k16 products, on V's column blocks 0-1 and 2-3 (a
// column block of 64 values is BLOCK_K rows of 128 bytes); accumulator
// entries 64-127 are columns 128-255, as in m64n256k16's own layout.
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_rs_n128<0>(d, a, desc_b);
  wgmma_rs_n128<64>(d, a, desc_b + ((2 * BLOCK_K * 128) >> 4));
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

// One key tile's online-softmax update and O += P V on the thread's two
// rows. s holds the tile's scores q.k, unscaled; k0 is the tile's first
// key, pos0 the global position of the thread's first row, vt_s the tile's
// V (W = D columns) in shared memory.
template <int D>
__device__ __forceinline__ void softmax_pv(float (&s)[32], float (&acc)[D / 2],
                                           float (&m)[2], float (&l)[2],
                                           bool full, float scale_log2,
                                           int k0, int t_k, int pos0,
                                           int causal, int k_offset, int lane,
                                           uint32_t vt_s) {
  const float m_floor = M_FLOOR * LOG2E;
  // scores in log2 units are s * c, c = |scale| * log2(e) >= 0 (a negative
  // scale negated the scores instead). A fully visible tile keeps s and
  // folds c into the exp's FMA: max(s * c) = c * max(s) exactly, as
  // rounding is monotone. A partly visible tile is scaled first and its
  // masked scores set to -inf (p = exp2(-inf) = 0, as exp(-1e30 - m) is,
  // also at c = 0); then c = 1.
  float c = scale_log2;
  if (!full) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i % 2);
      const int pos = pos0 + 8 * ((i / 2) % 2);
      const bool ok = col < t_k && (!causal || pos >= k_offset + col);
      s[i] = ok ? s[i] * scale_log2 : -INFINITY;
    }
    c = 1.f;
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
    m_new[i] = fmaxf(fmaxf(m[i], mx * c), m_floor);
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
      const float p0 = exp2_approx(fmaf(s[4 * n + 2 * i], c, -m_new[i]));
      const float p1 =
          exp2_approx(fmaf(s[4 * n + 2 * i + 1], c, -m_new[i]));
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

// The thread's two output rows, columns [col0, col0 + D) of o (row stride
// d): acc / l, with l summed over the quad first and l == 0 (a fully masked
// row) giving 0. Columns at or past d are the zero padding's: not stored.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float (&l)[2],
                                           __nv_bfloat16* og, int wq0,
                                           int row0, int w_rows, int d,
                                           int col0, int lane) {
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
        og + static_cast<size_t>(wq0 + row) * d + col0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (col0 + 8 * n < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] / denom,
                                  acc[4 * n + 2 * i + 1] / denom);
  }
}

// D is the instantiated width W; d (a multiple of 8, at most D) is the
// head dim of q, k, v and o, the row stride in device memory. PAD = false
// is the instantiation for d == D, where d is a constant (the padded one
// spends registers on the runtime stride and column bounds).
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS, Layout<D>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int t_q, int t_k,
                       int d_arg, int q_offset, int k_offset, int causal,
                       float scale_log2, int negate_q) {
  using L = Layout<D>;
  const int d = PAD ? d_arg : D;
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

  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * t_q * d;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * t_k * d;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * t_k * d;
  __nv_bfloat16* og = o + static_cast<size_t>(bh) * t_q * d;

  // keys any row of this block can see (k_valid = t_k; causal horizon)
  int k_end = t_k;
  if (causal) {
    const int last_q = q_offset + min(q0 + BLOCK_Q, t_q) - 1;
    k_end = min(t_k, last_q - k_offset + 1);
  }
  const int n_kt = k_end > 0 ? (k_end + BLOCK_K - 1) / BLOCK_K : 0;

  load_tile<D, BLOCK_Q>(q_s, qg, q0, t_q, d, tid);
  cp_async_commit();
  if (n_kt > 0) {
    load_tile<D, BLOCK_K>(k_s, kg, 0, t_k, d, tid);
    load_tile<D, BLOCK_K>(v_s, vg, 0, t_k, d, tid);
  }
  cp_async_commit();
  if (negate_q) {  // once a block: the chunks this thread copied
    cp_async_wait<1>();
    negate_tile<D, BLOCK_Q>(q_s, tid);
  }

  // this warpgroup's query rows, and the global positions of the valid ones
  const int wq0 = q0 + wg * WG_ROWS;
  const int w_rows = min(WG_ROWS, t_q - wq0);  // <= 0: nothing to compute
  const int r_lo = q_offset + wq0;
  const int r_hi = r_lo + w_rows - 1;
  // this thread's two rows: 16 * warp + lane / 4, and 8 below it
  const int row0 = warp * 16 + lane / 4;
  const int pos0 = r_lo + row0;  // global position of row0

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
                            t_k, d, tid);
      load_tile<D, BLOCK_K>(v_s + next * L::KV_BYTES, vg, (kt + 1) * BLOCK_K,
                            t_k, d, tid);
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

      fence_regs(s);
      wgmma_fence();
      // every k16 step, also past d on zero-filled columns (they add 0): a
      // product issued under a condition makes ptxas wait for each one
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s, kmajor_desc<D>(q_s, BLOCK_Q, wg * WG_ROWS, ks),
                     kmajor_desc<D>(kt_s, BLOCK_K, 0, ks), ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      softmax_pv<D>(s, acc, m, l, full, scale_log2, k0, t_k, pos0, causal,
                    k_offset, lane, v_s + stage * L::KV_BYTES);
    }
    __syncthreads();  // the next iteration refills the other stage: this
                      // one is free for the tile after it
  }
  cp_async_wait<0>();
  store_rows<D>(acc, l, og, wq0, row0, w_rows, d, 0, lane);
}

// Head dims above 256 (see "Head dims above 256" at the top). W is the
// width of the block's O slab, output columns [col0, col0 + W) with
// col0 = slab0 + W * blockIdx.z; d (a multiple of 8, above 256) is the head
// dim and row stride. The block walks steps j = kt * n_c + c: step j
// stages depth chunk c (DEPTH columns) of the Q tile and of key tile kt's
// K, and with c = 0 key tile kt's V slab, while step j - 1 is multiplied.
template <int W>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_wide_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int t_q, int t_k,
                            int d, int slab0, int q_offset, int k_offset,
                            int causal, float scale_log2, int negate) {
  using WL = WideLayout<W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t v_base = base + STAGES * WL::STAGE_BYTES;  // STAGES V slabs

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_Q;  // heaviest first
  const int col0 = slab0 + blockIdx.z * W;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * t_q * d;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * t_k * d;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * t_k * d;
  __nv_bfloat16* og = o + static_cast<size_t>(bh) * t_q * d;

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
    const uint32_t st = base + (j % STAGES) * WL::STAGE_BYTES;
    load_tile<DEPTH, BLOCK_Q>(st, qg, q0, t_q, d, tid, c * DEPTH);
    load_tile<DEPTH, BLOCK_K>(st + WL::Q_BYTES, kg, kt * BLOCK_K, t_k, d, tid,
                              c * DEPTH);
    if (c == 0)
      load_tile<W, BLOCK_K>(v_base + (kt % STAGES) * WL::V_BYTES, vg,
                            kt * BLOCK_K, t_k, d, tid, col0);
  };
  if (n_steps > 0) stage_in(0);
  cp_async_commit();

  const int wq0 = q0 + wg * WG_ROWS;
  const int w_rows = min(WG_ROWS, t_q - wq0);
  const int r_lo = q_offset + wq0;
  const int r_hi = r_lo + w_rows - 1;
  const int row0 = warp * 16 + lane / 4;
  const int pos0 = r_lo + row0;

  float acc[W / 2];
  float s[32];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    const int kv = min(BLOCK_K, t_k - k0);
    const int c_lo = k_offset + k0;
    const int c_hi = c_lo + kv - 1;
    const bool visible = w_rows > 0 && !(causal && r_hi < c_lo);
    const bool full = kv == BLOCK_K && (!causal || r_lo >= c_hi);
    for (int c = 0; c < n_c; ++c) {
      const int j = kt * n_c + c;
      if (j + 1 < n_steps) stage_in(j + 1);  // in flight during this step
      cp_async_commit();
      cp_async_wait<1>();  // step j's chunks (and V slab) have landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (visible) {
        const uint32_t st = base + (j % STAGES) * WL::STAGE_BYTES;
        fence_regs(s);
        wgmma_fence();
        // S accumulates over the chunks: the first product of chunk 0
        // overwrites it. A tail chunk's zero-filled columns add 0.
#pragma unroll
        for (int ks = 0; ks < DEPTH / 16; ++ks)
          wgmma_ss_n64(s, kmajor_desc<DEPTH>(st, BLOCK_Q, wg * WG_ROWS, ks),
                       kmajor_desc<DEPTH>(st + WL::Q_BYTES, BLOCK_K, 0, ks),
                       c > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        if (c == n_c - 1) {  // S is whole: every slab sees the same S
          if (negate) {  // q.k of -q, exactly: rounding is symmetric
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = -s[i];
          }
          softmax_pv<W>(s, acc, m, l, full, scale_log2, k0, t_k, pos0,
                        causal, k_offset, lane,
                        v_base + (kt % STAGES) * WL::V_BYTES);
        }
      }
      __syncthreads();  // step j's stage is free for step j + 2
    }
  }
  cp_async_wait<0>();
  store_rows<W>(acc, l, og, wq0, row0, w_rows, d, col0, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t_q, int t_k, int d, int q_offset,
                   int k_offset, int causal, float scale,
                   cudaStream_t stream) {
  // + 1024: the kernel aligns its tiles to 1024 bytes
  const size_t bytes = Layout<D>::SMEM_BYTES + 1024;
  auto kernel = d == D ? flash_fwd_wgmma_kernel<D, false>
                       : flash_fwd_wgmma_kernel<D, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + BLOCK_Q - 1) / BLOCK_Q);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      t_q, t_k, d, q_offset, k_offset, causal, std::fabs(scale) * LOG2E,
      scale < 0.f);
  return cudaGetLastError();
}

// n_slabs O slabs of width W from column slab0
template <int W>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int bh, int t_q, int t_k, int d, int slab0,
                        int n_slabs, int q_offset, int k_offset, int causal,
                        float scale, cudaStream_t stream) {
  const size_t bytes = WideLayout<W>::SMEM_BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_wide_kernel<W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + BLOCK_Q - 1) / BLOCK_Q, n_slabs);
  flash_fwd_wgmma_wide_kernel<W><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      t_q, t_k, d, slab0, q_offset, k_offset, causal,
      std::fabs(scale) * LOG2E, scale < 0.f);
  return cudaGetLastError();
}

}  // namespace

// q, o: [bh, t_q, d]; k, v: [bh, t_k, d]; all contiguous bfloat16 (dtype 1)
// with 16-byte aligned data, d a multiple of 8 (any size), any finite
// scale. Launches on `stream` (two kernels for a d above 256 whose last
// slab is narrower) and returns the launch status (cudaGetLastError); it
// does not synchronise.
extern "C" int v6t_flash_attention_fwd_tc(const void* q, const void* k,
                                          const void* v, void* o, int dtype,
                                          int bh, int t_q, int t_k, int d,
                                          int q_offset, int k_offset,
                                          int causal, float scale,
                                          void* stream) {
  if (dtype != 1 || bh <= 0 || t_q <= 0 || t_k < 0 || d < 8 || d % 8 != 0 ||
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
