// weight_transform: the weight-application transform of a cold start on Hopper.
//
// Replaces src/repro/kernels/weight_transform.py::weight_transform (its
// _dequant_kernel and _cast_kernel), the A phase of int8 and apply_dtype
// loads (src/repro/core/coldstart.py:190-201).
//
// What bounds it on an H100: bytes.  Each element is read once (1 byte of
// int8 or 4 bytes of f32) and written once (2 or 4 bytes); the only
// arithmetic is one multiply per element, far below the ~295 operations per
// byte at which the tensor cores, not HBM, would be the limit.
//
// What the design does about it: a flat grid over the n*m elements, each
// thread moving VEC consecutive elements with 16-byte loads and stores where
// both pointers are 16-byte aligned.  Element i belongs to column i % m, so
// the path's skinny leaves ((14400, 64) for wq) and its wide ones
// ((49152, 960) for tok) run on the same grid, without the TPU kernel's
// (256, 512) tiles or the padding those tiles need.  The arithmetic is
// int8 -> f32, times the f32 scale, rounded to nearest-even into bf16
// (__float2bfloat16_rn): exactly what PyTorch's (w.float() * s).to(bf16)
// does, so the result equals the plain version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 16;       // elements per thread
constexpr int THREADS = 256;

__device__ __forceinline__ float convert(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 convert(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// Store VEC converted values at out; 16-byte stores when vec is set.
__device__ __forceinline__ void store_vec(float* out, const float (&v)[VEC],
                                          bool vec) {
  if (vec) {
    float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      o[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = v[i];
  }
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* out,
                                          const float (&v)[VEC], bool vec) {
  __align__(16) __nv_bfloat16 b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) b[i] = __float2bfloat16_rn(v[i]);
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(b);
    uint4* o = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int i = 0; i < VEC * 2 / 16; ++i) o[i] = s[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = b[i];
  }
}

template <typename Out>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const int8_t* __restrict__ w, const float* __restrict__ scale,
               Out* __restrict__ out, long long n, int m, int vec) {
  const long long base =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (base >= n) return;
  int col = (int)(base % m);
  if (base + VEC <= n) {
    int8_t q[VEC];
    if (vec) {
      const int4 raw = *reinterpret_cast<const int4*>(w + base);
      const int8_t* r = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) q[i] = r[i];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) q[i] = w[base + i];
    }
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      v[i] = (float)q[i] * __ldg(scale + col);
      if (++col == m) col = 0;
    }
    store_vec(out + base, v, vec != 0);
  } else {
    for (long long i = base; i < n; ++i) {
      out[i] = convert((float)w[i] * __ldg(scale + col), (Out*)nullptr);
      if (++col == m) col = 0;
    }
  }
}

template <typename Out>
__global__ void __launch_bounds__(THREADS)
cast_kernel(const float* __restrict__ w, Out* __restrict__ out, long long n,
            int vec) {
  const long long base =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (base >= n) return;
  if (base + VEC <= n) {
    float v[VEC];
    if (vec) {
      const float4* s = reinterpret_cast<const float4*>(w + base);
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const float4 t = s[i];
        v[4 * i] = t.x;
        v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z;
        v[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = w[base + i];
    }
    store_vec(out + base, v, vec != 0);
  } else {
    for (long long i = base; i < n; ++i) out[i] = convert(w[i], (Out*)nullptr);
  }
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + (long long)THREADS * VEC - 1) / ((long long)THREADS * VEC));
}

inline int aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

}  // namespace

// out_kind: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int repro_wt_dequant(const void* w, const void* scale, void* out,
                                long long n, int m, int out_kind,
                                void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(w, out);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (out_kind == 0)
    dequant_kernel<float><<<blocks_for(n), THREADS, 0, s>>>(
        wp, sp, static_cast<float*>(out), n, m, vec);
  else if (out_kind == 1)
    dequant_kernel<__nv_bfloat16><<<blocks_for(n), THREADS, 0, s>>>(
        wp, sp, static_cast<__nv_bfloat16*>(out), n, m, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int repro_wt_cast(const void* w, void* out, long long n,
                             int out_kind, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(w, out);
  const float* wp = static_cast<const float*>(w);
  if (out_kind == 0)
    cast_kernel<float><<<blocks_for(n), THREADS, 0, s>>>(
        wp, static_cast<float*>(out), n, vec);
  else if (out_kind == 1)
    cast_kernel<__nv_bfloat16><<<blocks_for(n), THREADS, 0, s>>>(
        wp, static_cast<__nv_bfloat16*>(out), n, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
