// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t on
// Hopper.
//
// Replaces src/repro/kernels/rglru_scan.py::rglru_scan (the Pallas kernel
// behind ops.rglru_scan), which runs in every recurrent block of a Griffin /
// RecurrentGemma forward and cold-start E (src/repro/models/griffin.py:84).
//
// What bounds it on an H100: the bytes of a, b and h (each read or written
// once, 3 * B * S * W elements) if enough loads are in flight; at the path's
// B = 1, W = 2560 the grid is 20 blocks of 128 threads, and each of the S
// steps of a thread waits on the step before it, so it is latency-bound well
// above that bound.
//
// What the design does: one thread per (batch row, lane) walks the sequence
// in order with its state in a register (f32), as the TPU kernel's fori_loop
// does per chunk with the state in VMEM scratch; neighbouring threads read
// neighbouring lanes, so every step's loads are coalesced.  The loop is
// unrolled so that the loads of later steps (which do not depend on h) are
// issued ahead of the chain of multiply-adds.  The state can start from h0
// (B, W) f32 and the state after step n_valid - 1 is written to hS (B, W)
// f32, so a caller that padded S with trailing zero steps (which would reset
// h to 0) still reads the true final state.  Prefetching a/b tiles into
// shared memory, or a two-pass chunked scan for more parallelism, is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ y, const float* __restrict__ h0,
             float* __restrict__ hS, int S, int W, int n_valid) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const long long base = (long long)row * S * W + w;
  float h = h0 != nullptr ? h0[(long long)row * W + w] : 0.f;
  float h_last = h;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const long long i = base + (long long)t * W;
    h = to_f32(a[i]) * h + to_f32(b[i]);
    put(y + i, h);
    if (t == n_valid - 1) h_last = h;
  }
  if (hS != nullptr) hS[(long long)row * W + w] = h_last;
}

template <typename T>
int launch(const void* a, const void* b, void* y, const float* h0, float* hS,
           int B, int S, int W, int n_valid, cudaStream_t s) {
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      h0, hS, S, W, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, y (B, S, W) contiguous, all of one dtype (0 = float32, 1 =
// bfloat16); h0 (B, W) f32 or null (start from 0); hS (B, W) f32 or null
// (the state after step n_valid - 1; n_valid in [0, S], 0 leaves h0).
// Returns cudaGetLastError().
extern "C" int repro_rglru_scan(const void* a, const void* b, void* y,
                                const void* h0, void* hS, int B, int S, int W,
                                int n_valid, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || n_valid < 0 || n_valid > S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hSf = static_cast<float*>(hS);
  if (dtype == 0)
    return launch<float>(a, b, y, h0f, hSf, B, S, W, n_valid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, y, h0f, hSf, B, S, W, n_valid, s);
  return (int)cudaErrorInvalidValue;
}
