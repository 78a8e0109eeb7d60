// decode_attention: one-token attention over a slotted kv-major cache on
// Hopper.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (the
// slotted Pallas kernel), which runs in every decode step
// (src/repro/models/layers.py:174).
//
// What bounds it on an H100: bytes.  A step reads the valid rows of the K and
// V caches once (2 * (pos + 1) * dh elements per kv head and row) and does
// only 4 * rep * dh operations per cache row, about 6 per byte in bf16.
//
// What the design does: one block per (kv head, batch row), holding that kv
// head's rep query heads together (rep = 3 at smollm-360m, not a power of
// two), so each K/V row is read once for all of them.  The block walks the
// cache up to its own row's pos in tiles of TK rows: the K tile is staged in
// shared memory (rows padded by one word so the per-row dot products do not
// collide on a bank), scores and probabilities for the tile live in shared
// memory, the per-head running max and denominator are updated one warp per
// head, and V is streamed from global memory in coalesced rows.  Statistics
// and accumulator stay in f32.  Validity follows the reference: slot j is
// valid if j <= pos, or, with a window, if the position it holds under the
// ring-buffer rule lies in (pos - window, pos] (decode_attention.py:70-72).
// With B=1 and K=5 this fills 5 of the card's 132 SMs; splitting the cache
// across blocks with a merge pass is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;          // cache rows per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 16;     // query heads per kv head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool slot_valid(int j, int pos, int window) {
  if (window > 0) {
    const int held = pos - (((pos - j) % window) + window) % window;
    return held >= 0 && held > pos - window;
  }
  return j <= pos;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ pos_arr,
              T* __restrict__ o, int H, int K, int S_max, int window,
              float scale) {
  constexpr int NG = THREADS / TK;          // head groups in the score phase
  constexpr int G = THREADS / DH;           // head groups in the PV phase
  constexpr int ACC = MAX_REP / G;
  __shared__ float qs[MAX_REP][DH];
  __shared__ float ks[TK][DH + 1];
  __shared__ float ps[MAX_REP][TK];
  __shared__ float m_s[MAX_REP];
  __shared__ float l_s[MAX_REP];
  __shared__ float alpha_s[MAX_REP];

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / K;
  const int pos = pos_arr[b];
  const long long cache_base = ((long long)b * K + kvh) * S_max;
  const long long q_base = ((long long)b * H + (long long)kvh * rep) * DH;

  for (int idx = tid; idx < rep * DH; idx += THREADS)
    qs[idx / DH][idx % DH] = to_f32(q[q_base + idx]) * scale;
  if (tid < rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int d = tid % DH;
  const int g = tid / DH;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  int n_keys = (window > 0 && pos >= window) ? S_max : min(pos + 1, S_max);
  if (n_keys < 0) n_keys = 0;

  for (int t0 = 0; t0 < n_keys; t0 += TK) {
    __syncthreads();                       // previous tile consumed
    for (int idx = tid; idx < TK * DH; idx += THREADS) {
      const int j = idx / DH;
      const int kp = t0 + j;
      ks[j][idx % DH] =
          kp < n_keys ? to_f32(kc[(cache_base + kp) * DH + idx % DH]) : 0.f;
    }
    __syncthreads();

    // scores: thread (j, group) for heads group, group + NG, ...
    {
      const int j = tid % TK;
      const int kp = t0 + j;
      const bool ok = kp < n_keys && slot_valid(kp, pos, window);
      for (int r = tid / TK; r < rep; r += NG) {
        float s = -INFINITY;
        if (ok) {
          s = 0.f;
#pragma unroll 16
          for (int e = 0; e < DH; ++e) s += qs[r][e] * ks[j][e];
        }
        ps[r][j] = s;
      }
    }
    __syncthreads();

    // per-head statistics, one warp per head
    {
      const int warp = tid >> 5;
      const int lane = tid & 31;
      for (int r = warp; r < rep; r += WARPS) {
        const float s0 = ps[r][lane];
        const float s1 = ps[r][lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float p0 = 0.f, p1 = 0.f, alpha = 1.f;
        if (m_new != -INFINITY) {
          p0 = expf(s0 - m_new);
          p1 = expf(s1 - m_new);
          alpha = expf(m_old - m_new);
        }
        ps[r][lane] = p0;
        ps[r][lane + 32] = p1;
        float sm = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sm += __shfl_xor_sync(0xffffffffu, sm, off);
        if (lane == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + sm;
          alpha_s[r] = alpha;
        }
      }
    }
    __syncthreads();

    // P @ V: thread (d, group) for heads group, group + G, ...
    if (g < G) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int r = g + G * i;
        if (r < rep) acc[i] *= alpha_s[r];
      }
      const int n = min(TK, n_keys - t0);
      for (int j = 0; j < n; ++j) {
        const float vv = to_f32(vc[(cache_base + t0 + j) * DH + d]);
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const int r = g + G * i;
          if (r < rep) acc[i] += ps[r][j] * vv;
        }
      }
    }
  }
  __syncthreads();
  if (g < G) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = g + G * i;
      if (r < rep) {
        const float l = l_s[r];
        put(o + q_base + (long long)r * DH + d, l > 0.f ? acc[i] / l : 0.f);
      }
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* o, int B, int H, int K, int S_max, int window, float scale,
           cudaStream_t s) {
  dim3 grid(K, B);
  decode_kernel<T, DH><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<T*>(o), H, K, S_max, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, dh), caches (B, K, S_max, dh), o (B, H, dh), all contiguous;
// pos (B,) int32.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError().
extern "C" int repro_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* pos,
                                      void* o, int B, int H, int K, int S_max,
                                      int dh, int dtype, int window,
                                      float scale, void* stream) {
  if (B <= 0 || K <= 0 || S_max <= 0 || H % K != 0 || H / K > MAX_REP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, kc, vc, pos, o, B, H, K, S_max, window,
                             scale, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, kc, vc, pos, o, B, H, K, S_max, window,
                              scale, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, kc, vc, pos, o, B, H, K, S_max,
                                     window, scale, s);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, kc, vc, pos, o, B, H, K, S_max,
                                      window, scale, s);
  return (int)cudaErrorInvalidValue;
}
