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
//
// The backward (repro_rmsnorm_bwd, for training), with g the gradient of y
// and w = 1 + scale:
//   dx     = r g w - x r^3 mean(g w x)      (in x's dtype)
//   dscale = sum over rows of g x r         (f32; the wrapper casts)
// Pass 1: a block takes BWD_ROWS consecutive rows, one after the other; for
// each it sums x^2 exactly as the forward does (so r is the forward's) and
// g w x in the same order, writes the row's dx, and adds g x r into its own
// f32 partial of dscale in shared memory (a thread owns its columns).  Each
// block writes its partial row.  Pass 2 sums the partials over blocks in
// block order, a thread a column.  No atomics: dscale is the same bits run
// to run, and a row's dx does not depend on the other rows.  Bounded by
// bytes, as the forward: x and g read twice (the second from L2), dx
// written, the partials (rows / 16 x d f32) written and read once.
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

constexpr int BWD_ROWS = 16;   // rows a block of the backward's first pass

// the block-wide sum of one value a thread: lanes by a fixed butterfly, then
// the warps in order (the forward's order); warp_sum is free again on return
__device__ __forceinline__ float block_sum(float s, float* warp_sum) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
  __syncthreads();
  return total;
}

template <typename T, typename TS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d,
                   float eps) {
  extern __shared__ float acc[];             // this block's dscale partial
  __shared__ float warp_sum[THREADS / 32];
  const int tid = threadIdx.x;
  for (int i = tid; i < d; i += THREADS) acc[i] = 0.f;
  const long long r0 = (long long)blockIdx.x * BWD_ROWS;
  for (int rr = 0; rr < BWD_ROWS && r0 + rr < rows; ++rr) {
    const T* xr = x + (r0 + rr) * d;
    const T* gr = g + (r0 + rr) * d;
    T* dxr = dx + (r0 + rr) * d;
    float s = 0.f;
    for (int i = tid; i < d; i += THREADS) {
      const float v = to_f32(xr[i]);
      s += v * v;
    }
    const float r = rsqrtf(block_sum(s, warp_sum) * (1.f / (float)d) + eps);
    float u = 0.f;
    for (int i = tid; i < d; i += THREADS)
      u += to_f32(gr[i]) * (1.f + to_f32(scale[i])) * to_f32(xr[i]);
    const float c = r * r * r * (block_sum(u, warp_sum) * (1.f / (float)d));
    for (int i = tid; i < d; i += THREADS) {
      const float xv = to_f32(xr[i]);
      const float gv = to_f32(gr[i]);
      put(dxr + i, r * gv * (1.f + to_f32(scale[i])) - xv * c);
      acc[i] += gv * xv * r;
    }
  }
  for (int i = tid; i < d; i += THREADS)
    partial[(long long)blockIdx.x * d + i] = acc[i];
}

__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                          float* __restrict__ dscale, int nblocks, int d) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[(long long)b * d + c];
  dscale[c] = s;
}

template <typename T, typename TS>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               float* partial, float* dscale, long long rows, int d,
               float eps, cudaStream_t s) {
  const long long nb = (rows + BWD_ROWS - 1) / BWD_ROWS;
  rmsnorm_bwd_kernel<T, TS><<<(unsigned)nb, THREADS, d * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), partial, rows, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_reduce_kernel<<<(d + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partial, dscale, (int)nb, d);
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

// The backward: x, g, dx (rows, d) contiguous in one dtype (0 = float32,
// 1 = bfloat16), scale (d,) contiguous float32 (0) or bfloat16 (1); partial
// (ceil(rows / 16), d) and dscale (d,) f32, written (not accumulated).
// d up to 12000 (a block's partial row lives in shared memory, under the
// 48 KB a launch may take without opting in).  Two
// launches on `stream`; returns the first launch error, else
// cudaGetLastError().
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* g, void* dx, void* partial,
                                 void* dscale, long long rows, int d,
                                 float eps, int x_kind, int scale_kind,
                                 void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || d > 12000)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(partial);
  float* df = static_cast<float*>(dscale);
  using bf = __nv_bfloat16;
  if (x_kind == 0 && scale_kind == 0)
    return launch_bwd<float, float>(x, scale, g, dx, pf, df, rows, d, eps, s);
  if (x_kind == 0 && scale_kind == 1)
    return launch_bwd<float, bf>(x, scale, g, dx, pf, df, rows, d, eps, s);
  if (x_kind == 1 && scale_kind == 0)
    return launch_bwd<bf, float>(x, scale, g, dx, pf, df, rows, d, eps, s);
  if (x_kind == 1 && scale_kind == 1)
    return launch_bwd<bf, bf>(x, scale, g, dx, pf, df, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
