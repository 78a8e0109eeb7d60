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
// What the first design lost (40-50% of the byte bound at the main path's
// large leaves): a flat grid of n*m/16 threads, each moving 16 consecutive
// elements and exiting.  Each thread fetched the scale of each element with
// a scalar load, had one load in flight before its stores, paid a 64-bit
// modulo for its column, and converted to bf16 one value at a time.  Worst,
// its 16 elements left as four 16-byte stores (f32) or two (bf16) with the
// warp's lanes 64 or 32 bytes apart, so no store instruction wrote one
// contiguous run.  Scales held in registers and rows walked by an SM-sized
// grid did not help while a thread kept 16 columns (33-43% for f32, 56-67%
// for bf16); one 16-byte store a thread a row did (PERF.md, from
// ab.py --sweep).
//
// What this design does:
//  * a thread owns V consecutive columns, V = 16 bytes / output element (4
//    for f32, 8 for bf16; 4 where m % 8 != 0), so each row it writes is one
//    16-byte store (8 bytes for bf16 at V = 4) and its weights one 4- or
//    8-byte load: a warp's loads and stores are each one contiguous run;
//  * the dequant is a flat grid-stride walk over the n * m / V chunks of
//    the extent, about STEPS = 4 chunks a thread (weight_transform.plan).
//    A grid that walks has a multiple of the m / V chunks of a row in
//    threads, so a thread's column never changes: it loads its V scales
//    once (16-byte loads) into registers, and its UNROLL = 4 weight loads
//    are in flight before its stores.  Sized from n * m, the grid keeps the
//    blocks in flight on one sliding window of the extent; an SM-sized grid
//    that loops over it was 5-12% slower.  Rows are covered in blockIdx.x
//    and the loop only; offsets are 64-bit, since one leaf may exceed 2^31
//    elements;
//  * the cast (no per-column data) takes one tile of 4 * 256 float4 units
//    a block, a thread's loads 256 units apart (PyTorch's own layout for
//    elementwise kernels); a grid that loops over tiles lost 4.7%;
//  * bf16 is packed in pairs by __floats2bfloat162_rn (one
//    cvt.rn.bf16x2.f32 a pair, the same bits as __float2bfloat16_rn);
//  * a scalar path (V = 1) for m % 4 != 0 or pointers not aligned to the
//    vector width: the same walk, one element a step.
// The launch (V, grid) is chosen in Python by weight_transform.plan, where
// the CPU tests reach it; the entry points check it and refuse what the
// kernels cannot take.  Cache hints (ld.global.nc.L1::no_allocate,
// st.global.cs), 8 loads in flight, and 2 or 8 cast units a thread were
// measured and gained nothing, so none is used.
//
// The arithmetic is int8 -> f32, one f32 multiply by the f32 scale, rounded
// to nearest-even into bf16: exactly PyTorch's (w.float() * s).to(dt), so
// the result equals the plain version bit for bit.  No fast-math, no
// conversion of int8 to bf16 before the multiply, no half2 arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;   // threads a block at most
constexpr int MIN_BLOCKS = 4;      // blocks of 256 resident an SM (<= 64 regs)
constexpr int UNROLL = 4;          // loads in flight a thread; the cast's
                                   // float4 units a thread a tile

// V int8 weights of one row, as the raw bytes of one load
template <int V> struct Raw;
template <> struct Raw<8> { using T = int2; };
template <> struct Raw<4> { using T = int; };
template <> struct Raw<1> { using T = int8_t; };

template <int V>
__device__ __forceinline__ typename Raw<V>::T load_row(const int8_t* p) {
  return __ldg(reinterpret_cast<const typename Raw<V>::T*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// V f32 values to out: one 16-byte store (V == 4), or one scalar store
template <int V>
__device__ __forceinline__ void store_vals(float* o, const float (&v)[V]) {
  static_assert(V == 1 || V == 4, "f32 takes 1 or 4 columns a thread");
  if constexpr (V == 1)
    o[0] = v[0];
  else
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}

// V values rounded to bf16 in pairs: one 16-byte store (V == 8), 8 bytes
// (V == 4), or one scalar store
template <int V>
__device__ __forceinline__ void store_vals(__nv_bfloat16* o,
                                           const float (&v)[V]) {
  if constexpr (V == 1) {
    o[0] = __float2bfloat16_rn(v[0]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
    static_assert(V == 8, "bf16 takes 1, 4 or 8 columns a thread");
    *reinterpret_cast<uint4*>(o) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// one row's V weights times the thread's V scales, stored
template <int V, typename Out>
__device__ __forceinline__ void dequant_row(Out* o, typename Raw<V>::T raw,
                                            const float (&s)[V]) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = (float)q[i] * s[i];
  store_vals<V>(o, v);
}

// w, out: (rows, m) row-major, as rows * m / V chunks of V columns; scale:
// (m,).  Thread gid takes chunks gid, gid + G, ... (G threads in the
// grid); G is a multiple of the chunks of a row, or the walk is one pass,
// so the thread's column chunk is gid % (m / V) throughout.
template <typename Out, int V>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
dequant_kernel(const int8_t* __restrict__ w, const float* __restrict__ scale,
               Out* __restrict__ out, long long rows, int m) {
  const long long chunks = m / V;
  const long long total = rows * chunks;
  const long long G = (long long)gridDim.x * blockDim.x;
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  const long long col = (k % chunks) * V;
  float s[V];
  if constexpr (V == 1) {
    s[0] = __ldg(scale + col);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 f =
          __ldg(reinterpret_cast<const float4*>(scale + col) + i);
      s[4 * i] = f.x;
      s[4 * i + 1] = f.y;
      s[4 * i + 2] = f.z;
      s[4 * i + 3] = f.w;
    }
  }
  for (; k + (UNROLL - 1) * G < total; k += UNROLL * G) {
    typename Raw<V>::T raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      raw[u] = load_row<V>(w + (k + u * G) * V);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      dequant_row<V>(out + (k + u * G) * V, raw[u], s);
  }
  for (; k < total; k += G)
    dequant_row<V>(out + k * V, load_row<V>(w + k * V), s);
}

__device__ __forceinline__ float to_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// w, out: n elements, as float4 units (VEC) or elements.  Block b takes
// tile b of UNROLL * blockDim.x units; in it, thread t takes units t,
// t + blockDim.x, ...  (VEC: then the last n % 4 elements, one a thread.)
template <typename Out, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
cast_kernel(const float* __restrict__ w, Out* __restrict__ out,
            long long n) {
  constexpr int U = UNROLL;
  const long long units = VEC ? n / 4 : n;
  const long long T = blockDim.x;
  const long long i = (long long)blockIdx.x * U * T + threadIdx.x;
  if constexpr (VEC) {
    float4 f[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * T < units)
        f[u] = __ldg(reinterpret_cast<const float4*>(w) + i + u * T);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * T < units) {
        const float v[4] = {f[u].x, f[u].y, f[u].z, f[u].w};
        store_vals<4>(out + (i + u * T) * 4, v);
      }
  } else {
    float f[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * T < units) f[u] = w[i + u * T];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * T < units) out[i + u * T] = to_out(f[u], (Out*)nullptr);
  }
  if constexpr (VEC) {
    const long long t = units * 4 + (long long)blockIdx.x * T + threadIdx.x;
    if (t < n) out[t] = to_out(w[t], (Out*)nullptr);
  }
}

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename Out, int V>
int dequant(const void* w, const void* scale, void* out, long long rows,
            int m, int threads, int grid, cudaStream_t s) {
  dequant_kernel<Out, V><<<grid, threads, 0, s>>>(
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<Out*>(out), rows, m);
  return (int)cudaGetLastError();
}

template <typename Out>
int cast(const void* w, void* out, long long n, int vec, int threads,
         int grid, cudaStream_t s) {
  const float* wp = static_cast<const float*>(w);
  Out* op = static_cast<Out*>(out);
  if (vec == 4)
    cast_kernel<Out, true><<<grid, threads, 0, s>>>(wp, op, n);
  else
    cast_kernel<Out, false><<<grid, threads, 0, s>>>(wp, op, n);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch of weight_transform.plan: vec columns a thread (4 or 1 to
// float32, 8, 4 or 1 to bfloat16: one store a row), threads a block, grid
// blocks (grid * threads a multiple of m / vec, or at least rows * m /
// vec).  out_kind: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a launch the kernel cannot take.
extern "C" int repro_wt_dequant(const void* w, const void* scale, void* out,
                                long long rows, int m, int vec, int threads,
                                int grid, int out_kind, void* stream) {
  if (rows <= 0 || m <= 0 || threads <= 0 || threads > MAX_THREADS ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  if ((vec != 8 && vec != 4 && vec != 1) || m % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && !(aligned(w, vec) && aligned(scale, 16) &&
                   aligned(out, 16)))
    return (int)cudaErrorInvalidValue;
  const long long chunks = m / vec;
  const long long g = (long long)grid * threads;
  if (g % chunks != 0 && g < rows * chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (out_kind == 0 && vec == 4)
    return dequant<float, 4>(w, scale, out, rows, m, threads, grid, s);
  if (out_kind == 0 && vec == 1)
    return dequant<float, 1>(w, scale, out, rows, m, threads, grid, s);
  if (out_kind == 1 && vec == 8)
    return dequant<BF, 8>(w, scale, out, rows, m, threads, grid, s);
  if (out_kind == 1 && vec == 4)
    return dequant<BF, 4>(w, scale, out, rows, m, threads, grid, s);
  if (out_kind == 1 && vec == 1)
    return dequant<BF, 1>(w, scale, out, rows, m, threads, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The cast's launch: vec 4 (float4 units) or 1, threads a block, grid
// blocks, one tile of UNROLL * threads units each, covering the n / vec
// units.
extern "C" int repro_wt_cast(const void* w, void* out, long long n, int vec,
                             int threads, int grid, int out_kind,
                             void* stream) {
  if (n <= 0 || threads <= 0 || threads > MAX_THREADS || grid <= 0 ||
      (vec != 4 && vec != 1))
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && !(aligned(w, 16) && aligned(out, 16)))
    return (int)cudaErrorInvalidValue;
  if ((long long)grid * UNROLL * threads < n / vec ||
      (long long)grid * threads < n % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == 0) return cast<float>(w, out, n, vec, threads, grid, s);
  if (out_kind == 1)
    return cast<__nv_bfloat16>(w, out, n, vec, threads, grid, s);
  return (int)cudaErrorInvalidValue;
}
