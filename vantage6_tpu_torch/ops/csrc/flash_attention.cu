// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel vantage6_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_forward through pl.pallas_call). It computes the same
// function: online-softmax attention over [B*H, T, D] tiles with causal
// masking by global position (q_offset + row >= k_offset + col), padded-key
// masking against k_valid = Tk, masked scores NEG_INF = -1e30, the running
// max floored at -1e20 (a fully masked tile adds exp(-huge) = 0), m, l and
// acc in f32, p rounded to v's dtype before p.v, and the output
// acc / (l > 0 ? l : 1) in q's dtype, so fully masked rows are exactly 0.
//
// Which calls it serves: f32 (the tensor cores would round it to TF32) and
// D = 8 (below wgmma's k16 depth). bf16 at D >= 16 goes to the tensor-core
// kernel in flash_attention_tc.cu; this one still takes bf16 at every D, so
// the two can be held against each other on the same inputs.
//
// Design. One thread block of 128 threads per (b*h, 64-row query tile).
// The query tile is staged once in shared memory as f32; the block then
// walks the 64-row key/value tiles (this loop replaces the TPU's sequential
// fori_loop), staging each through shared memory. Ragged Tq/Tk are masked
// here: the wrapper makes no padding copies. Under the causal mask the walk
// stops at the last key tile any row of the query tile can see; the skipped
// tiles are fully masked and would add exactly 0. Products are f32 FMAs on
// the CUDA cores: exact for bf16 inputs, and never TF32 for f32 inputs.
//
// Bound at the slice's full width (B=16, H=8, T=1024, D=128, bf16, causal):
// the unmasked score entries need 4*D*BH*T*(T+1)/2 = 3.44e10 operations,
// 34.8 us at the 989 TFLOP/s bf16 tensor-core peak; q, k, v and o move
// 4 * 33.6 MB = 134 MB, 40.1 us at 3.35 TB/s. So the bound is the bytes,
// with the operations close behind.
//
// What this simple design leaves on the table: the tensor cores (wgmma, or
// mma.sync) - f32 FMA peaks at 67 TFLOP/s, so this kernel cannot come within
// 10x of the bound; TMA and cp.async double buffering of the K/V tiles (the
// loads here are synchronous and 2-byte wide for bf16); shared memory holds
// f32 copies, which caps occupancy at one block per SM at D=128; and the
// scores take a round trip through shared memory between the two products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 128;
constexpr int TY = 16;                       // thread rows
constexpr int TX = 8;                        // thread columns
constexpr int ROWS = BLOCK_Q / TY;           // query rows per thread
constexpr int SCOLS = BLOCK_K / TX;          // score columns per thread
constexpr int ROWS_PER_WARP = BLOCK_Q / (THREADS / 32);
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;

static_assert(TY * TX == THREADS, "thread grid");
static_assert(BLOCK_K == 64, "softmax pass gives each lane two columns");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Shared-memory layout. Rows of q and k are padded by one float so that the
// column walks of the score product hit distinct banks.
template <int D>
struct Smem {
  static constexpr int QS = D + 1;
  static constexpr int KS = D + 1;
  static constexpr int VS = D;
  static constexpr int SS = BLOCK_K + 1;
  static constexpr int FLOATS =
      BLOCK_Q * QS + BLOCK_K * KS + BLOCK_K * VS + BLOCK_Q * SS + 3 * BLOCK_Q;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t_q,
                 int t_k, int q_offset, int k_offset, int causal,
                 float scale) {
  using L = Smem<D>;
  constexpr int DCOLS = D / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BLOCK_Q * L::QS;
  float* vs = ks + BLOCK_K * L::KS;
  float* ss = vs + BLOCK_K * L::VS;
  float* m_s = ss + BLOCK_Q * L::SS;
  float* l_s = m_s + BLOCK_Q;
  float* c_s = l_s + BLOCK_Q;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BLOCK_Q;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const T* qg = q + static_cast<size_t>(bh) * t_q * D;
  const T* kg = k + static_cast<size_t>(bh) * t_k * D;
  const T* vg = v + static_cast<size_t>(bh) * t_k * D;
  T* og = o + static_cast<size_t>(bh) * t_q * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[r * L::QS + c] =
        q0 + r < t_q ? to_f32(qg[static_cast<size_t>(q0 + r) * D + c]) : 0.f;
  }
  if (tid < BLOCK_Q) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // keys any row of this tile can see (k_valid = t_k; causal horizon)
  int k_end = t_k;
  if (causal) {
    const int last_q = q_offset + min(q0 + BLOCK_Q, t_q) - 1;
    k_end = min(t_k, last_q - k_offset + 1);
  }
  const int n_kt = k_end > 0 ? (k_end + BLOCK_K - 1) / BLOCK_K : 0;

  float acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < t_k;
      const size_t g = static_cast<size_t>(k0 + r) * D + c;
      ks[r * L::KS + c] = in ? to_f32(kg[g]) : 0.f;
      vs[r * L::VS + c] = in ? to_f32(vg[g]) : 0.f;
    }
    __syncthreads();

    // scores: s = (q . k) * scale, f32 accumulation, then the masks
    float sacc[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qr[ROWS], kc[SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qr[i] = qs[(ty + TY * i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) kc[j] = ks[(tx + TX * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j)
          sacc[i][j] = fmaf(qr[i], kc[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const int c = tx + TX * j;
        const int kidx = k0 + c;
        bool valid = kidx < t_k;
        if (causal) valid = valid && (q_offset + q0 + r >= k_offset + kidx);
        ss[r * L::SS + c] = valid ? sacc[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 16 rows, each lane two columns
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const float s0 = ss[r * L::SS + lane];
      const float s1 = ss[r * L::SS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(fmaxf(m_old, mx), M_FLOOR);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // p.astype(v.dtype): the product with v uses the rounded p
      ss[r * L::SS + lane] = to_f32(from_f32<T>(p0));
      ss[r * L::SS + lane + 32] = to_f32(from_f32<T>(p1));
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float corr = c_s[ty + TY * i];
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float vc[DCOLS];
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) vc[j] = vs[kk * L::VS + tx + TX * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = ss[(ty + TY * i) * L::SS + kk];
#pragma unroll
        for (int j = 0; j < DCOLS; ++j) acc[i][j] = fmaf(p, vc[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // l_s of the last tile (or of the init) is visible

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = ty + TY * i;
    if (q0 + r >= t_q) continue;
    const float l = l_s[r];
    const float denom = l > 0.f ? l : 1.f;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j)
      og[static_cast<size_t>(q0 + r) * D + tx + TX * j] =
          from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t_q, int t_k, int q_offset, int k_offset,
                   int causal, float scale, cudaStream_t stream) {
  const size_t bytes = Smem<D>::BYTES;
  // above 48 KB a block's dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_q, t_k, q_offset,
      k_offset, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int bh, int t_q, int t_k, int q_offset,
                       int k_offset, int causal, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset,
                          causal, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset,
                           causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset,
                           causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, t_q, t_k, q_offset, k_offset,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [bh, t_q, d]; k, v: [bh, t_k, d]; all contiguous, one dtype
// (0 = float32, 1 = bfloat16). Launches on `stream` and returns the launch
// status (cudaGetLastError); it does not synchronise.
extern "C" int v6t_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int dtype,
                                       int bh, int t_q, int t_k, int d,
                                       int q_offset, int k_offset, int causal,
                                       float scale, void* stream) {
  if (bh <= 0 || t_q <= 0 || t_k < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, bh, t_q, t_k, q_offset, k_offset,
                             causal, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, bh, t_q, t_k, q_offset,
                                     k_offset, causal, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* v6t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
