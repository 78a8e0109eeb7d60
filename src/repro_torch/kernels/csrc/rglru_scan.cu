// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t on
// Hopper.
//
// Replaces src/repro/kernels/rglru_scan.py::rglru_scan (the Pallas kernel
// behind ops.rglru_scan), which runs in every recurrent block of a Griffin /
// RecurrentGemma forward and cold-start E (src/repro/models/griffin.py:84).
//
// What bounds it on an H100: the bytes of a, b and h (each read or written
// once, 3 B S W elements; 3.9 MB, 1.17 us, at the path's f32 (1, 128,
// 2560)), if enough loads are in flight.  The first design gave each (batch
// row, lane) one thread that walked all S steps: 20 blocks of 128 threads at
// the path's shape, each step's loads at most 8 steps ahead of the chain of
// multiply-adds, so the time was about S / 8 rounds of device-memory
// latency (0.0098 ms).
//
// What the design does: a two-level scan inside one block.  A block owns
// 32 lanes of one batch row and NS slices of T consecutive steps: thread
// (lane, slice k) covers steps [k T, (k + 1) T) of each pass of NS T steps.
//  1. It issues all 2 T loads of its slice's a and b at once (coalesced
//     across the 32 lanes), then composes the slice's affine map in
//     registers: the product of its a, and its h from 0.
//  2. The NS maps go to shared memory; each thread combines the maps of the
//     slices before its own, in slice order, from the pass's carry-in, into
//     its own carry-in.
//  3. It runs its slice again from that carry-in, in registers, and writes y
//     once.  The last slice's final h is the next pass's carry-in.
// So the path's shape runs W / 32 x B = 80 blocks, every load in flight at
// once, and the dependent chain is 2 T + NS steps long instead of S.  T and
// NS come from rglru_scan.py::plan (16 slices of 8 steps).
//
// What it keeps: slices start at fixed step offsets (multiples of T from the
// call's first step), independent of B and S, and a thread reads only its
// own (row, lane), so a row's bits are the same at any batch size and
// trailing zero steps leave the valid steps' bits as they were; the state
// after step n_valid - 1 (the true final state under padding, since a zero
// step resets h) is written to hS; h0 seeds the first pass; h is f32
// throughout and y is written in a's dtype.
//
// The backward (repro_rglru_scan_bwd, for training) replaces the gradient
// jax.grad takes of the reference's _xla_rglru (src/repro/kernels/ops.py:509).
// Given g = dL/dh it walks the reverse recurrence dh_t = g_t + a_{t+1}
// dh_{t+1} (a_S = 0), with db_t = dh_t, da_t = dh_t h_{t-1} (h_{-1} = h0 or
// 0) and dh0 = a_0 dh_0, reading h from the forward's f32 output.  It moves
// 5 B S W f32 (a, h, g read; da, db written) for 2 operations an element,
// so bytes bound it.  The design is the simple one: a thread per (row,
// lane), coalesced over the lanes, S walked in reverse with the loads of
// BWD_STEPS steps issued together ahead of the chain of multiply-adds.
// Each thread owns its column: no atomics, and a row's bits never depend on
// the batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;             // lanes (of W) a block
constexpr int MAX_SLICES = 16;        // NS: threads a lane, 512 a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// block (LANES, NS): threadIdx.x the lane, threadIdx.y the slice
template <typename T, int TS>
__global__ void __launch_bounds__(LANES * MAX_SLICES)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ y, const float* __restrict__ h0,
             float* __restrict__ hS, int S, int W, int n_valid) {
  __shared__ float map_a[MAX_SLICES][LANES];   // product of the slice's a
  __shared__ float map_b[MAX_SLICES][LANES];   // its h from 0
  __shared__ float carry[LANES];               // the pass's carry-in
  const int lane = threadIdx.x;
  const int k = threadIdx.y;
  const int ns = blockDim.y;
  const int w = blockIdx.x * LANES + lane;
  const int row = blockIdx.y;
  const bool live = w < W;
  const long long base = (long long)row * S * W + w;
  if (k == 0) carry[lane] = live && h0 != nullptr
                                ? h0[(long long)row * W + w]
                                : 0.f;
  const int pass = ns * TS;
  for (int s0 = 0; s0 < S; s0 += pass) {
    const int t0 = s0 + k * TS;                // this slice's first step
    float av[TS], bv[TS];
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const bool ok = live && t0 + i < S;
      const long long o = base + (long long)(t0 + i) * W;
      av[i] = ok ? to_f32(a[o]) : 1.f;
      bv[i] = ok ? to_f32(b[o]) : 0.f;
    }
    float pa = 1.f, hb = 0.f;
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      pa *= av[i];
      hb = av[i] * hb + bv[i];
    }
    map_a[k][lane] = pa;
    map_b[k][lane] = hb;
    __syncthreads();                           // the maps and the carry
    float h = carry[lane];
    for (int q = 0; q < k; ++q) h = map_a[q][lane] * h + map_b[q][lane];
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      h = av[i] * h + bv[i];
      if (live && t0 + i < S) {
        const long long o = base + (long long)(t0 + i) * W;
        put(y + o, h);
        if (hS != nullptr && t0 + i == n_valid - 1)
          hS[(long long)row * W + w] = h;
      }
    }
    __syncthreads();                           // the maps and carry read
    if (k == ns - 1) carry[lane] = h;
  }
  if (hS != nullptr && n_valid == 0 && k == 0 && live)
    hS[(long long)row * W + w] =
        h0 != nullptr ? h0[(long long)row * W + w] : 0.f;
}

template <typename T, int TS>
int launch(const void* a, const void* b, void* y, const float* h0, float* hS,
           int B, int S, int W, int n_valid, int ns, cudaStream_t s) {
  dim3 grid((W + LANES - 1) / LANES, B);
  rglru_kernel<T, TS><<<grid, dim3(LANES, ns), 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      h0, hS, S, W, n_valid);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* y, const float* h0,
             float* hS, int B, int S, int W, int n_valid, int ns, int ts,
             cudaStream_t s) {
  switch (ts) {
    case 4: return launch<T, 4>(a, b, y, h0, hS, B, S, W, n_valid, ns, s);
    case 8: return launch<T, 8>(a, b, y, h0, hS, B, S, W, n_valid, ns, s);
    case 16: return launch<T, 16>(a, b, y, h0, hS, B, S, W, n_valid, ns, s);
  }
  return (int)cudaErrorInvalidValue;
}

constexpr int BWD_THREADS = 128;      // lanes a block of the backward
constexpr int BWD_STEPS = 8;          // steps whose loads go out together

__global__ void __launch_bounds__(BWD_THREADS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ y,
                 const float* __restrict__ g, const float* __restrict__ h0,
                 float* __restrict__ da, float* __restrict__ db,
                 float* __restrict__ dh0, int S, int W) {
  const int w = blockIdx.x * BWD_THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const long long base = (long long)row * S * W + w;
  const float hinit = h0 != nullptr ? h0[(long long)row * W + w] : 0.f;
  float dh = 0.f;                  // dL/dh of the step after the current one
  float a_next = 0.f;              // a of that step (0 past the last)
  for (int t1 = S; t1 > 0; t1 -= BWD_STEPS) {
    float av[BWD_STEPS], gv[BWD_STEPS], hv[BWD_STEPS];
#pragma unroll
    for (int i = 0; i < BWD_STEPS; ++i) {      // steps t1 - 1 down
      const int t = t1 - 1 - i;
      const long long o = base + (long long)t * W;
      av[i] = t >= 0 ? a[o] : 0.f;
      gv[i] = t >= 0 ? g[o] : 0.f;
      hv[i] = t > 0 ? y[o - W] : hinit;
    }
#pragma unroll
    for (int i = 0; i < BWD_STEPS; ++i) {
      const int t = t1 - 1 - i;
      if (t < 0) break;
      dh = fmaf(a_next, dh, gv[i]);
      const long long o = base + (long long)t * W;
      db[o] = dh;
      da[o] = dh * hv[i];
      a_next = av[i];
    }
  }
  if (dh0 != nullptr) dh0[(long long)row * W + w] = a_next * dh;
}

}  // namespace

// a, y, g, da, db (B, S, W) contiguous float32: y the forward's output (h at
// every step), g = dL/dy; h0 (B, W) float32 or null (the forward started
// from 0); dh0 (B, W) float32 or null (not wanted).  Writes da, db and dh0.
// Returns cudaGetLastError().
extern "C" int repro_rglru_scan_bwd(const void* a, const void* y,
                                    const void* g, const void* h0, void* da,
                                    void* db, void* dh0, int B, int S, int W,
                                    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((W + BWD_THREADS - 1) / BWD_THREADS, B);
  rglru_bwd_kernel<<<grid, BWD_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<const float*>(h0),
      static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dh0), S, W);
  return (int)cudaGetLastError();
}

// a, b, y (B, S, W) contiguous, all of one dtype (0 = float32, 1 =
// bfloat16); h0 (B, W) f32 or null (start from 0); hS (B, W) f32 or null
// (the state after step n_valid - 1; n_valid in [0, S], 0 leaves h0).
// slices (1 to 16) and slice_len (4, 8 or 16) from rglru_scan.py::plan.
// Returns cudaGetLastError().
extern "C" int repro_rglru_scan(const void* a, const void* b, void* y,
                                const void* h0, void* hS, int B, int S, int W,
                                int n_valid, int dtype, int slices,
                                int slice_len, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0 || n_valid < 0 ||
      n_valid > S || slices < 1 || slices > MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hSf = static_cast<float*>(hS);
  if (dtype == 0)
    return dispatch<float>(a, b, y, h0f, hSf, B, S, W, n_valid, slices,
                           slice_len, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, b, y, h0f, hSf, B, S, W, n_valid,
                                   slices, slice_len, s);
  return (int)cudaErrorInvalidValue;
}
