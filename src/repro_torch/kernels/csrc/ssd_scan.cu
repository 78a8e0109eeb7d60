// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan on Hopper.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel behind
// ops.ssd_scan), which runs in every SSD block of a Mamba-2 forward and
// cold-start E (src/repro/models/ssm.py:98).
//
// Per (batch, head) the recurrence is h_t = exp(dt_t A) h_{t-1} +
// dt_t x_t B_t^T, y_t = h_t C_t, with h (dp, N) in f32.  The chunked form
// computes, per chunk of L steps with cum_i = sum_{k<=i} dt_k A:
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i h_prev                          (intra + inter)
//   h    = exp(cum_L) h_prev + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T
//
// What bounds it on an H100: operations.  The work is O(S L (N + dp) +
// S dp N) multiply-adds per head against O(S (dp + 2 N)) bytes, and this
// first kernel does it in f32 on the CUDA cores (no mma.sync or wgmma), so its
// bound is the float32 rate; at the path's shape (48 heads) it fills 48 of
// the card's 132 SMs.
//
// What the design does: one block per (batch row, head), walking its chunks
// in order with the state h resident in shared memory, as the TPU grid's
// innermost "arbitrary" chunk axis does with VMEM scratch.  The TPU kernel
// holds a whole bc-step chunk in VMEM (about 256 KB at bc 128, N 128, dp 64);
// a block here has at most 227 KB, so the kernel picks its own chunk length L
// (64, or 32 or 16 where dp and N are larger) -- the result is the
// recurrence's, not the tiling's.  Per chunk it stages B, C (L x N, rows
// padded by one word) and dt x (L x dp) in dynamic shared memory, forms
// (C B^T) masked and decayed (L x L) with the i >= j mask applied before
// exp (above the diagonal cum_i - cum_j > 0 could overflow), then y, then
// the state update.  A ragged last chunk is zero-filled (dt = 0, x = 0),
// which leaves the state as it was.  The state starts from h0 (b, nh, dp,
// N) f32 when given and the final state is written to hS, so the same
// kernel serves a prefill that continues a cache.  Accumulation is in f32,
// A is read as f32, and y is written in x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;     // bytes of shared memory a block can use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// floats of shared memory for chunk length L
__host__ __device__ __forceinline__ long long smem_floats(int L, int dp,
                                                          int N) {
  return (long long)dp * (N + 1) + 2LL * L * (N + 1) + (long long)L * dp +
         (long long)L * (L + 1) + 4LL * L + 1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ hS, int nh, int S, int dp,
           int N, int L) {
  extern __shared__ float smem[];
  const int NP = N + 1;                     // padded row of B, C and h
  float* hs = smem;                         // (dp, N + 1)
  float* bs = hs + dp * NP;                 // (L, N + 1)
  float* cs = bs + L * NP;                  // (L, N + 1)
  float* xs = cs + L * NP;                  // (L, dp): dt_j x_j
  float* gs = xs + L * dp;                  // (L, L + 1)
  float* sdt = gs + L * (L + 1);            // (L,)
  float* cum = sdt + L;                     // (L,) inclusive cumsum of dt A
  float* ecum = cum + L;                    // (L,) exp(cum_i)
  float* wrem = ecum + L;                   // (L,) exp(cum_last - cum_j)
  float* total = wrem + L;                  // exp(cum_last)

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long bh = (long long)b * nh + h;
  const float a_h = A[h];
  const T* xr = x + bh * S * dp;
  const float* dtr = dt + bh * S;
  const float* br = Bm + (long long)b * S * N;
  const float* cr = Cm + (long long)b * S * N;
  T* yr = y + bh * S * dp;

  for (int idx = tid; idx < dp * N; idx += THREADS)
    hs[(idx / N) * NP + idx % N] =
        h0 != nullptr ? h0[bh * dp * N + idx] : 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int n = min(L, S - t0);
    __syncthreads();                        // previous chunk consumed
    for (int idx = tid; idx < L * N; idx += THREADS) {
      const int j = idx / N;
      const int c = idx % N;
      const bool ok = j < n;
      bs[j * NP + c] = ok ? br[(long long)(t0 + j) * N + c] : 0.f;
      cs[j * NP + c] = ok ? cr[(long long)(t0 + j) * N + c] : 0.f;
    }
    if (tid < L) sdt[tid] = tid < n ? dtr[t0 + tid] : 0.f;
    __syncthreads();
    for (int idx = tid; idx < L * dp; idx += THREADS) {
      const int j = idx / dp;
      xs[idx] = j < n ? sdt[j] * to_f32(xr[(long long)(t0 + j) * dp +
                                           idx % dp])
                      : 0.f;
    }
    if (tid == 0) {
      float run = 0.f;
      for (int j = 0; j < L; ++j) {
        run += sdt[j] * a_h;
        cum[j] = run;
      }
      *total = expf(run);
    }
    __syncthreads();
    if (tid < L) {
      ecum[tid] = expf(cum[tid]);
      wrem[tid] = expf(cum[L - 1] - cum[tid]);
    }

    // (C B^T) masked and decayed: gs[i][j] = C_i . B_j exp(cum_i - cum_j)
    for (int idx = tid; idx < L * L; idx += THREADS) {
      const int i = idx / L;
      const int j = idx % L;
      float g = 0.f;
      if (j <= i) {
        const float* ci = cs + i * NP;
        const float* bj = bs + j * NP;
        for (int c = 0; c < N; ++c) g += ci[c] * bj[c];
        g *= expf(cum[i] - cum[j]);
      }
      gs[i * (L + 1) + j] = g;
    }
    __syncthreads();

    // y_i = sum_{j<=i} gs[i][j] xs[j] + exp(cum_i) C_i h_prev
    for (int idx = tid; idx < n * dp; idx += THREADS) {
      const int i = idx / dp;
      const int p = idx % dp;
      const float* gi = gs + i * (L + 1);
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra += gi[j] * xs[j * dp + p];
      const float* ci = cs + i * NP;
      const float* hp = hs + p * NP;
      float inter = 0.f;
      for (int c = 0; c < N; ++c) inter += ci[c] * hp[c];
      put(yr + (long long)(t0 + i) * dp + p, intra + ecum[i] * inter);
    }
    __syncthreads();                        // h_prev read; xs read
    for (int idx = tid; idx < L * dp; idx += THREADS)
      xs[idx] *= wrem[idx / dp];
    __syncthreads();

    // h = exp(cum_last) h_prev + sum_j wrem_j dt_j x_j B_j^T
    const float tot = *total;
    for (int idx = tid; idx < dp * N; idx += THREADS) {
      const int p = idx / N;
      const int c = idx % N;
      float s = 0.f;
      for (int j = 0; j < L; ++j) s += xs[j * dp + p] * bs[j * NP + c];
      float* hv = hs + p * NP + c;
      *hv = tot * *hv + s;
    }
  }
  __syncthreads();
  if (hS != nullptr)
    for (int idx = tid; idx < dp * N; idx += THREADS)
      hS[bh * dp * N + idx] = hs[(idx / N) * NP + idx % N];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* h0, void* y, float* hS, int b,
           int nh, int S, int dp, int N, cudaStream_t s) {
  int L = 64;
  while (L > 16 && smem_floats(L, dp, N) * 4 > MAX_SMEM) L /= 2;
  const long long bytes = smem_floats(L, dp, N) * 4;
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;             // idempotent, so a race is benign
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(nh, b);
  ssd_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, h0, static_cast<T*>(y), hS,
      nh, S, dp, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (b, nh, S, dp) contiguous in one dtype (0 = float32, 1 = bfloat16);
// dt (b, nh, S), A (nh,), B and C (b, S, N) contiguous float32; h0 (b, nh,
// dp, N) float32 or null (start from 0); hS (b, nh, dp, N) float32 or null
// (the state after step S - 1).  Returns cudaGetLastError().
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* hS, int b, int nh, int S, int dp,
                              int N, int dtype, void* stream) {
  if (b <= 0 || nh <= 0 || S <= 0 || dp <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* h0f = static_cast<const float*>(h0);
  float* hSf = static_cast<float*>(hS);
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Bf, Cf, h0f, y, hSf, b, nh, S, dp, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bf, Cf, h0f, y, hSf, b, nh, S,
                                 dp, N, s);
  return (int)cudaErrorInvalidValue;
}
