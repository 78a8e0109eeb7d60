// rmsnorm: RMS normalisation of rows, y = x / sqrt(mean(x^2) + eps) *
// (1 + scale), on Hopper, with its backward for training.
//
// Not a TPU kernel: it stands for the reference's rmsnorm
// (src/repro/models/layers.py:44), which XLA compiles from jnp ops, and it
// exists so that a row's result does not depend on how many rows a call
// normalises.  With PyTorch's own mean over the last axis, a decode step's
// row at B = 4 could differ in its last bits from the same row at B = 1
// (its reduction sizes blocks from the number of rows), and the scheduler's
// tokens could leave reference_generate's at a near-tie (found by
// `ab.py --probe`).
//
// What bounds it on an H100: bytes.  The forward reads x once and writes y
// once (the scale comes from L1/L2); the backward reads x and g once and
// writes dx once, plus a small partial of dscale.  At a decode step's few
// rows it is one launch's latency.
//
// What the first design lost: one 256-thread block a row, so at d 960 a
// quarter of the threads idled in the last stride; scalar 2-byte loads;
// the row read twice (three times in the backward, five loads an
// element); a shared-memory round and __syncthreads for every sum; the
// backward's rows walked 16 after another in a block, and its dscale
// partials summed by one thread a column on 4 blocks.
//
// The design (launch choices in Python, rmsnorm.plan, from d and the
// dtypes alone, never from the row count):
//  * a CHUNK is 16 bytes of x: V = 8 bf16 or 4 f32 elements.  A row of d
//    elements has C = ceil(d / V) chunks and is shared by `threads` threads
//    (a warp, or 2, 4 or 8 warps for wide rows); thread t owns chunks t,
//    t + threads, ... (at most CPT, the instance) and holds them in
//    registers: the row is read once, with one 16-byte load a chunk.
//  * the sum of squares: thread t adds x_i^2 (an fma a term) chunk after
//    chunk, element after element; the lanes of a warp by the butterfly
//    xor 16, 8, 4, 2, 1 (every lane ends with the same bits); the warps of
//    a row in warp order through shared memory.  The order depends on
//    (threads, V) only, which depend on (d, dtype) only: a row's bits are
//    the same in a call of one row or of many.
//  * r = rsqrt(sum * (1 / d) + eps) in f32 (every fma written out: nothing
//    is left to the compiler to contract); y = x r, then * (1 + scale)
//    rounded once into x's dtype (the plain version's roundings); y leaves
//    by one 16-byte store a chunk.  The scale's chunks are loaded once a
//    thread, as 1 + scale in f32, and reused over the rows it takes.
//  * a block holds `teams` rows at once (teams x threads <= 256 threads);
//    a team takes `team_rows` rows, teams apart.  A row's team syncs its
//    warps by the block barrier, so a row past the end still joins the
//    barriers (it loads and stores nothing).
//  * a narrower instance for a d that is not a multiple of V or a pointer
//    not 16-byte aligned: the same chunks, loaded and stored an element at
//    a time (phase 3's d 20, the smoke widths 60 bf16).  The chunks and the
//    order are the same, so the bits are too.
//
// The backward, with g the gradient of y and w = 1 + scale:
//   dx     = r g w - x r^3 mean(g w x)      (in x's dtype)
//   dscale = sum over rows of g x r         (f32; the wrapper casts)
// Pass 1 (rmsnorm_bwd_kernel): the forward's chunks by the same plan.  x
// and g are read once into registers; sum(x^2) is summed exactly as the
// forward sums it (the same helper), so r is the forward's bit for bit;
// sum(g w x) in the same order, both by one butterfly and one exchange;
// dx by 16-byte stores.  A thread keeps its columns' g x r in f32 over the
// rows it takes (in row order); the teams of a block then write theirs to
// shared memory, and a thread a column adds them in team order, in f64,
// into the block's partial row (f64).  The block count is ceil(rows /
// (teams x team_rows)) (rmsnorm.bwd_blocks): from (rows, d), never from
// the card.  Pass 2 (rmsnorm_bwd_reduce_kernel): a block for each 32
// columns, its 8 warps over the partial rows (warp w adds rows w, w + 8,
// ... in order), the warps' sums then added in warp order, in f64, and
// rounded once to f32.  No atomics: dscale is the same bits run to run and
// card to card, and a row's dx does not depend on the other rows.  Summing
// across rows in f64 leaves dscale the error of its terms' f32 roundings
// (`ab.py --sweep` prints each launch shape's distance from an f64 sum).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;        // threads a block at most (teams x threads)
constexpr int CHUNK_BYTES = 16;   // a chunk of x: 8 bf16 or 4 f32
constexpr int MAX_CHUNKS = 16;    // chunks a thread at most (instances 1-16)
constexpr int REDUCE_COLS = 32;   // pass 2: columns a block (a lane each)
constexpr int REDUCE_WARPS = 8;   // pass 2: warps a block, over the partials
constexpr int SMEM_LIMIT = 48 * 1024;   // pass 1's team sum, without opt-in

using bf = __nv_bfloat16;

template <typename T>
struct Elems {
  static constexpr int V = CHUNK_BYTES / (int)sizeof(T);
};

__device__ __forceinline__ uint32_t word(const uint4& c, int i) {
  return i == 0 ? c.x : i == 1 ? c.y : i == 2 ? c.z : c.w;
}
__device__ __forceinline__ void set_word(uint4& c, int i, uint32_t v) {
  if (i == 0) c.x = v;
  else if (i == 1) c.y = v;
  else if (i == 2) c.z = v;
  else c.w = v;
}

// element j of a chunk as f32 (j a constant after unrolling)
template <typename T>
__device__ __forceinline__ float elem(const uint4& c, int j);
template <>
__device__ __forceinline__ float elem<float>(const uint4& c, int j) {
  return __uint_as_float(word(c, j));
}
template <>
__device__ __forceinline__ float elem<bf>(const uint4& c, int j) {
  const uint32_t w = word(c, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits_of(bf v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// chunk c of a row of x's type: one 16-byte load (wide), else n elements
// one at a time, the rest zero
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, bool wide, int n) {
  if (wide) return __ldg(reinterpret_cast<const uint4*>(p));
  constexpr int V = Elems<T>::V;
  uint4 c = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      const uint32_t b = bits_of(p[j]);
      if constexpr (sizeof(T) == 4) set_word(c, j, b);
      else set_word(c, j >> 1, word(c, j >> 1) | (b << (16 * (j & 1))));
    }
  }
  return c;
}

// store the f32 values v[0..V) of a chunk into x's type, rounded once
template <typename T>
__device__ __forceinline__ void store_chunk(T* p, bool wide, int n,
                                            const float (&v)[Elems<T>::V]) {
  constexpr int V = Elems<T>::V;
  if (wide) {
    uint4 c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        set_word(c, i, __float_as_uint(v[i]));
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i],
                                                       v[2 * i + 1]);
        set_word(c, i, *reinterpret_cast<const uint32_t*>(&h));
      }
    }
    *reinterpret_cast<uint4*>(p) = c;
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < n) put(p + j, v[j]);
}

// 1 + scale of chunk c (V values of the scale's type: 8, 16 or 32 bytes,
// one or two loads where wide); 1 past the row's end
template <typename TS, int V>
__device__ __forceinline__ void load_w(const TS* p, bool wide, int n,
                                       float (&w)[V]) {
  if (wide) {
    constexpr int WORDS = V * (int)sizeof(TS) / 4;
    uint32_t u[WORDS];
    if constexpr (WORDS == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      u[0] = q.x;
      u[1] = q.y;
    } else {
#pragma unroll
      for (int i = 0; i < WORDS / 4; ++i) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
        u[4 * i] = q.x;
        u[4 * i + 1] = q.y;
        u[4 * i + 2] = q.z;
        u[4 * i + 3] = q.w;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (sizeof(TS) == 4)
        w[j] = 1.f + __uint_as_float(u[j]);
      else
        w[j] = 1.f + __uint_as_float((j & 1) ? (u[j >> 1] & 0xffff0000u)
                                             : (u[j >> 1] << 16));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) w[j] = 1.f + (j < n ? to_f32(p[j]) : 0.f);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The sum of x^2 of a thread's chunks, chunk after chunk, element after
// element: the one order both kernels use, so the backward's r is the
// forward's.
template <typename T, int CPT>
__device__ __forceinline__ float sum_squares(const uint4 (&xc)[CPT]) {
  constexpr int V = Elems<T>::V;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = elem<T>(xc[k], j);
      s = __fmaf_rn(v, v, s);
    }
  return s;
}

// r from a row's sum of squares (the fma written out, so that no compiler
// choice can make the backward's r differ from the forward's)
__device__ __forceinline__ float rsqrt_mean(float total, int d, float eps) {
  return rsqrtf(__fmaf_rn(total, 1.f / (float)d, eps));
}

// The row's total of one (or two) values a thread: the warp's butterfly,
// then, where a row spans warps, the row's warps in order through `red`
// (two slots a warp, two buffers by `parity`; one block barrier, which
// every thread of the block reaches).
template <int N>
__device__ __forceinline__ void row_total(float (&v)[N], int threads,
                                          float (*red)[BLOCK / 32][2],
                                          int parity) {
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = warp_sum(v[q]);
  if (threads == 32) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int q = 0; q < N; ++q) red[parity][warp][q] = v[q];
  __syncthreads();
  const int first = (threadIdx.x / threads) * (threads >> 5);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    float t = 0.f;
    for (int w = 0; w < (threads >> 5); ++w) t += red[parity][first + w][q];
    v[q] = t;
  }
}

template <typename T, typename TS, int CPT>
__global__ void __launch_bounds__(BLOCK)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ y, long long rows, int d, float eps,
               int threads, int team_rows, bool wide) {
  constexpr int V = Elems<T>::V;
  __shared__ float red[2][BLOCK / 32][2];
  const int t = threadIdx.x % threads;
  const int team = threadIdx.x / threads;
  const int teams = blockDim.x / threads;
  const int nchunks = (d + V - 1) / V;
  float w[CPT][V];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = t + k * threads;
    load_w<TS, V>(scale + c * V, wide && c < nchunks, d - c * V, w[k]);
  }
  const long long first = (long long)blockIdx.x * teams * team_rows + team;
  for (int i = 0; i < team_rows; ++i) {
    const long long row = first + (long long)i * teams;
    const bool ok = row < rows;
    const T* xr = x + row * d;
    uint4 xc[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = t + k * threads;
      xc[k] = ok && c < nchunks ? load_chunk(xr + c * V, wide, d - c * V)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
    float s[1] = {sum_squares<T, CPT>(xc)};
    row_total<1>(s, threads, red, i & 1);
    const float r = rsqrt_mean(s[0], d, eps);
    if (!ok) continue;
    T* yr = y + row * d;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = t + k * threads;
      if (c >= nchunks) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = (elem<T>(xc[k], j) * r) * w[k][j];
      store_chunk(yr + c * V, wide, d - c * V, o);
    }
  }
}

template <typename T, typename TS, int CPT>
__global__ void __launch_bounds__(BLOCK)
rmsnorm_bwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   double* __restrict__ partial, long long rows, int d,
                   float eps, int threads, int team_rows, bool wide) {
  constexpr int V = Elems<T>::V;
  extern __shared__ float4 team_smem[];    // teams rows where teams > 1
  float* team_sum = reinterpret_cast<float*>(team_smem);
  __shared__ float red[2][BLOCK / 32][2];
  const int t = threadIdx.x % threads;
  const int team = threadIdx.x / threads;
  const int teams = blockDim.x / threads;
  const int nchunks = (d + V - 1) / V;
  float w[CPT][V], acc[CPT][V];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = t + k * threads;
    load_w<TS, V>(scale + c * V, wide && c < nchunks, d - c * V, w[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  }
  const long long first = (long long)blockIdx.x * teams * team_rows + team;
  for (int i = 0; i < team_rows; ++i) {
    const long long row = first + (long long)i * teams;
    const bool ok = row < rows;
    uint4 xc[CPT], gc[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = t + k * threads;
      const bool in = ok && c < nchunks;
      xc[k] = in ? load_chunk(x + row * d + c * V, wide, d - c * V)
                 : make_uint4(0u, 0u, 0u, 0u);
      gc[k] = in ? load_chunk(g + row * d + c * V, wide, d - c * V)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    float su[2] = {sum_squares<T, CPT>(xc), 0.f};
#pragma unroll
    for (int k = 0; k < CPT; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j)
        su[1] = __fmaf_rn(elem<T>(gc[k], j) * w[k][j], elem<T>(xc[k], j),
                          su[1]);
    row_total<2>(su, threads, red, i & 1);
    const float r = rsqrt_mean(su[0], d, eps);
    const float cf = r * r * r * (su[1] * (1.f / (float)d));
    if (!ok) continue;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = t + k * threads;
      if (c >= nchunks) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xv = elem<T>(xc[k], j), gv = elem<T>(gc[k], j);
        o[j] = __fmaf_rn(-xv, cf, (r * gv) * w[k][j]);
        acc[k][j] = __fmaf_rn(gv * xv, r, acc[k][j]);
      }
      store_chunk(dx + row * d + c * V, wide, d - c * V, o);
    }
  }
  // the block's partial row (f64): each team's sums into its row of
  // team_sum (16-byte stores), then a thread a column adds the teams in
  // team order; one team writes its sums as they are
  double* out = partial + (long long)blockIdx.x * d;
  if (teams == 1) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = t + k * threads;
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c < nchunks && c * V + j < d) out[c * V + j] = acc[k][j];
    }
    return;
  }
  const int stride = nchunks * V;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = t + k * threads;
    if (c >= nchunks) continue;
    float4* p = reinterpret_cast<float4*>(team_sum + team * stride + c * V);
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      p[q] = make_float4(acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
                         acc[k][4 * q + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    double s = team_sum[i];
    for (int q = 1; q < teams; ++q) s += (double)team_sum[q * stride + i];
    out[i] = s;
  }
}

__global__ void __launch_bounds__(REDUCE_COLS * REDUCE_WARPS)
rmsnorm_bwd_reduce_kernel(const double* __restrict__ partial,
                          float* __restrict__ dscale, int nblocks, int d) {
  __shared__ double part[REDUCE_WARPS][REDUCE_COLS];
  const int lane = threadIdx.x % REDUCE_COLS;
  const int warp = threadIdx.x / REDUCE_COLS;
  const int c = blockIdx.x * REDUCE_COLS + lane;
  double s = 0.0;
  if (c < d) {
#pragma unroll 8
    for (int b = warp; b < nblocks; b += REDUCE_WARPS)
      s += partial[(long long)b * d + c];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    double total = 0.0;
#pragma unroll
    for (int q = 0; q < REDUCE_WARPS; ++q) total += part[q][lane];
    dscale[c] = (float)total;
  }
}

// pass 1's shared memory: a row of ceil(d / V) * V f32 a team (none for
// one team)
size_t team_bytes(int d, int V, int teams) {
  return teams > 1 ? (size_t)teams * ((d + V - 1) / V) * V * sizeof(float)
                   : 0;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % CHUNK_BYTES == 0;
}

// The launch's checks shared by both entries; the instance CPT (chunks a
// thread, a power of two) through `cpt`.  0 when the launch is taken.
int check_launch(long long rows, int d, int itemsize, int threads,
                 int teams, int team_rows, int vec, int* cpt) {
  const int V = CHUNK_BYTES / itemsize;
  if (rows <= 0 || d <= 0 || team_rows <= 0 || teams <= 0 ||
      (threads != 32 && threads != 64 && threads != 128 && threads != 256) ||
      threads * teams > BLOCK || (vec != 1 && vec != V) ||
      (vec == V && d % V != 0))
    return 1;
  const int per = ((d + V - 1) / V + threads - 1) / threads;
  int c = 1;
  while (c < per) c *= 2;
  if (c > MAX_CHUNKS) return 1;
  const long long per_block = (long long)teams * team_rows;
  if ((rows + per_block - 1) / per_block > 0x7fffffffLL) return 1;
  *cpt = c;
  return 0;
}

template <typename T, typename TS, int CPT>
int launch_fwd(const void* x, const void* scale, void* y, long long rows,
               int d, float eps, int threads, int teams, int team_rows,
               bool wide, cudaStream_t s) {
  const long long per_block = (long long)teams * team_rows;
  rmsnorm_kernel<T, TS, CPT>
      <<<(unsigned)((rows + per_block - 1) / per_block), threads * teams, 0,
         s>>>(static_cast<const T*>(x), static_cast<const TS*>(scale),
              static_cast<T*>(y), rows, d, eps, threads, team_rows, wide);
  return (int)cudaGetLastError();
}

template <typename T, typename TS, int CPT>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               double* partial, float* dscale, long long rows, int d,
               float eps, int threads, int teams, int team_rows, bool wide,
               cudaStream_t s) {
  const long long per_block = (long long)teams * team_rows;
  const long long nb = (rows + per_block - 1) / per_block;
  rmsnorm_bwd_kernel<T, TS, CPT>
      <<<(unsigned)nb, threads * teams,
         team_bytes(d, CHUNK_BYTES / (int)sizeof(T), teams), s>>>(
          static_cast<const T*>(x), static_cast<const TS*>(scale),
          static_cast<const T*>(g), static_cast<T*>(dx), partial, rows, d,
          eps, threads, team_rows, wide);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_reduce_kernel<<<(d + REDUCE_COLS - 1) / REDUCE_COLS,
                              REDUCE_COLS * REDUCE_WARPS, 0, s>>>(
      partial, dscale, (int)nb, d);
  return (int)cudaGetLastError();
}

template <typename T, typename TS, int CPT>
struct Fwd {
  template <typename... A>
  static int run(A... a) { return launch_fwd<T, TS, CPT>(a...); }
};
template <typename T, typename TS, int CPT>
struct Bwd {
  template <typename... A>
  static int run(A... a) { return launch_bwd<T, TS, CPT>(a...); }
};

template <template <typename, typename, int> class Fn, typename T,
          typename TS, typename... A>
int by_chunks(int cpt, A... a) {
  switch (cpt) {
    case 1: return Fn<T, TS, 1>::run(a...);
    case 2: return Fn<T, TS, 2>::run(a...);
    case 4: return Fn<T, TS, 4>::run(a...);
    case 8: return Fn<T, TS, 8>::run(a...);
    case 16: return Fn<T, TS, 16>::run(a...);
  }
  return (int)cudaErrorInvalidValue;
}

// the instance of (x's type, the scale's type, CPT) by the entries' codes
template <template <typename, typename, int> class Fn, typename... A>
int dispatch(int x_kind, int scale_kind, int cpt, A... a) {
  if (x_kind == 0 && scale_kind == 0)
    return by_chunks<Fn, float, float>(cpt, a...);
  if (x_kind == 0 && scale_kind == 1)
    return by_chunks<Fn, float, bf>(cpt, a...);
  if (x_kind == 1 && scale_kind == 0)
    return by_chunks<Fn, bf, float>(cpt, a...);
  if (x_kind == 1 && scale_kind == 1)
    return by_chunks<Fn, bf, bf>(cpt, a...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y (rows, d) contiguous in one dtype (0 = float32, 1 = bfloat16), scale
// (d,) contiguous float32 (0) or bfloat16 (1).  The launch of rmsnorm.plan:
// `threads` a row (32, 64, 128 or 256), `teams` rows at once a block
// (threads x teams <= 256), `team_rows` rows a team, `vec` elements an
// access (16 bytes' worth: needs d a multiple of it and every pointer
// 16-byte aligned; or 1).  Returns cudaGetLastError().
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long rows, int d, float eps, int x_kind,
                             int scale_kind, int threads, int teams,
                             int team_rows, int vec, void* stream) {
  int cpt = 0;
  const int itemsize = x_kind == 0 ? 4 : 2;
  if (check_launch(rows, d, itemsize, threads, teams, team_rows, vec, &cpt) ||
      (vec > 1 && !(aligned(x) && aligned(scale) && aligned(y))))
    return (int)cudaErrorInvalidValue;
  return dispatch<Fwd>(x_kind, scale_kind, cpt, x, scale, y, rows, d, eps,
                       threads, teams, team_rows, vec > 1,
                       static_cast<cudaStream_t>(stream));
}

// The backward: x, g, dx (rows, d) contiguous in one dtype (0 = float32,
// 1 = bfloat16), scale (d,) contiguous float32 (0) or bfloat16 (1); the
// launch choices as the forward's (the same `threads`, for the same r);
// partial (ceil(rows / (teams x team_rows)), d) f64 and dscale (d,) f32,
// written (not accumulated).  Where teams > 1 a block's partial row is
// summed in shared memory: teams x ceil(d / V) x V f32, at most 48 KB.
// Two launches on `stream`; returns the first launch error, else
// cudaGetLastError().
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* g, void* dx, void* partial,
                                 void* dscale, long long rows, int d,
                                 float eps, int x_kind, int scale_kind,
                                 int threads, int teams, int team_rows,
                                 int vec, void* stream) {
  int cpt = 0;
  const int itemsize = x_kind == 0 ? 4 : 2;
  if (check_launch(rows, d, itemsize, threads, teams, team_rows, vec, &cpt) ||
      team_bytes(d, CHUNK_BYTES / itemsize, teams) > SMEM_LIMIT ||
      (vec > 1 && !(aligned(x) && aligned(scale) && aligned(g) &&
                    aligned(dx))))
    return (int)cudaErrorInvalidValue;
  return dispatch<Bwd>(x_kind, scale_kind, cpt, x, scale, g, dx,
                       static_cast<double*>(partial),
                       static_cast<float*>(dscale), rows, d, eps, threads,
                       teams, team_rows, vec > 1,
                       static_cast<cudaStream_t>(stream));
}
