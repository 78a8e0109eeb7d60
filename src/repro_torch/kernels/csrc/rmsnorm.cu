// rmsnorm: RMS normalisation of rows, y = x / sqrt(mean(x^2) + eps) *
// (1 + scale), on Hopper, one block per row.
//
// Not a TPU kernel: it stands for the reference's rmsnorm
// (src/repro/models/layers.py:44), which XLA compiles from jnp ops, and it
// exists so that a row's result does not depend on how many rows a call
// normalises.  With PyTorch's own mean over the last axis, a decode step's
// row at B = 4 could differ in its last bits from the same row at B = 1
// (its reduction sizes blocks from the number of rows), and the scheduler's
// tokens could leave reference_generate's at a near-tie (found by
// `ab.py --probe`).  Here a row is
// always summed by one block of 256 threads: thread t adds elements t, t +
// 256, ... in order, the warps' lanes are combined by a fixed butterfly and
// the eight warps in warp order.  So row b's bits are the same in a call of
// one row or of many, in prefill and in decode.
//
// What bounds it on an H100: bytes (x read once, y written once, the scale
// read once per block from L2); at a decode step's few rows of 2560 it is a
// few microseconds of latency, one launch where the PyTorch version took
// nine.
//
// The arithmetic follows the plain version's roundings: x in f32, the mean
// of squares, rsqrt(mean + eps), y = x * r, then y * (1 + scale) rounded
// once into x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, typename TS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ y, int d, float eps) {
  __shared__ float warp_sum[THREADS / 32];
  const int tid = threadIdx.x;
  const T* xr = x + (long long)blockIdx.x * d;
  T* yr = y + (long long)blockIdx.x * d;
  float s = 0.f;
  for (int i = tid; i < d; i += THREADS) {
    const float v = to_f32(xr[i]);
    s += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
  const float r = rsqrtf(total * (1.f / (float)d) + eps);
  for (int i = tid; i < d; i += THREADS) {
    const float v = to_f32(xr[i]) * r;
    put(yr + i, v * (1.f + to_f32(scale[i])));
  }
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* y, long long rows, int d,
           float eps, cudaStream_t s) {
  rmsnorm_kernel<T, TS><<<(unsigned)rows, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(y), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (rows, d) contiguous in one dtype (0 = float32, 1 = bfloat16), scale
// (d,) contiguous float32 (0) or bfloat16 (1).  Returns cudaGetLastError().
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long rows, int d, float eps, int x_kind,
                             int scale_kind, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_kind == 0 && scale_kind == 0)
    return launch<float, float>(x, scale, y, rows, d, eps, s);
  if (x_kind == 0 && scale_kind == 1)
    return launch<float, bf>(x, scale, y, rows, d, eps, s);
  if (x_kind == 1 && scale_kind == 0)
    return launch<bf, float>(x, scale, y, rows, d, eps, s);
  if (x_kind == 1 && scale_kind == 1)
    return launch<bf, bf>(x, scale, y, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
