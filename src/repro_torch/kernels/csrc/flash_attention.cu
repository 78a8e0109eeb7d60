// flash_attention: online-softmax attention for prefill on Hopper.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel behind ops.flash_attention), which runs every attention E of a cold
// start and every prefill (src/repro/models/layers.py:146).
//
// What bounds it on an H100: at the path's shapes (S up to ~1k, dh 64) the
// work is small and the bound is the bytes of q, k, v and o; at long S it
// becomes the 4*S*T*dh operations.  This first kernel is plain FMA on the
// CUDA cores (no mma.sync, no wgmma/TMA), so it sits well above either bound
// at long S; making it fast is later work.
//
// What the design does: one block per (64-row query tile, head, batch), two
// threads per query row, each holding half of the row's q and accumulator
// (dims 2i and 2i+1, so the pair reads neighbouring shared-memory words).
// K/V tiles of BK rows are staged in shared memory as f32, read once per
// block for all 64 rows; the running max, denominator and accumulator stay
// in registers in f32.  Masks come from absolute positions (queries are the
// last S of T positions, q_offset = T - S) with the causal and window rules of
// flash_attention.py:60-69; tiles wholly above the diagonal or outside the
// window are never visited, and ragged S and T are masked in the kernel
// (the TPU kernel asserts S % bq == 0).  q is read as (B, S, H, dh) and k/v as
// (B, T, K, dh) through strides, so no transpose is materialised.  A row with
// no key left after masking gives 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int THREADS = 2 * BQ;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  if (causal) {
    if (kpos > qpos) return false;
    return window <= 0 || kpos > qpos - window;
  }
  if (window > 0) return abs(kpos - qpos) < window;
  return true;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int K, int S,
             int T_len, long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, int causal, int window,
             float scale) {
  constexpr int HALF = DH / 2;
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int qi = qt * BQ + r;
  const bool row_ok = qi < S;
  const int q_off = T_len - S;
  const int qpos = q_off + qi;

  float qr[HALF];
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    acc[i] = 0.f;
    qr[i] = row_ok ? to_f32(q[b * qsb + (long long)qi * qss + h * qsh +
                              2 * i + half]) * scale
                   : 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys this block can see: [k_begin, k_end)
  const int qpos_lo = q_off + qt * BQ;
  const int qpos_hi = q_off + min(S, (qt + 1) * BQ) - 1;
  int k_begin = 0;
  int k_end = T_len;
  if (causal) {
    k_end = min(T_len, qpos_hi + 1);
    if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  } else if (window > 0) {
    k_begin = max(0, qpos_lo - window + 1);
    k_end = min(T_len, qpos_hi + window);
  }

  for (int t0 = (k_begin / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();                       // previous tile consumed
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int j = idx / DH;
      const int d = idx % DH;
      const int kp = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < T_len) {
        kv = to_f32(k[b * ksb + (long long)kp * kss + kvh * ksh + d]);
        vv = to_f32(v[b * vsb + (long long)kp * vss + kvh * vsh + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < HALF; ++i) part += qr[i] * ks[j][2 * i + half];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kp = t0 + j;
      const bool ok = row_ok && kp < k_end && kp >= k_begin &&
                      allowed(qpos, kp, causal, window);
      s[j] = ok ? part : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    if (m_new != -INFINITY) {
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < HALF; ++i) acc[i] += p * vs[j][2 * i + half];
      }
      m = m_new;
    }
  }

  if (row_ok) {
    T* orow = o + (((long long)b * S + qi) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < HALF; ++i)
      put(orow + 2 * i + half, l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int S, int T_len, const long long* st, int causal,
           int window, float scale, cudaStream_t s) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, DH><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, K, S, T_len, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, dh), k/v (B, T, K, dh) addressed through the element strides
// of their batch, sequence and head dims (the last dim is contiguous);
// o (B, S, H, dh) contiguous.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H, int K,
    int S, int T_len, int dh, int dtype, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, o, B, H, K, S, T_len, st, causal,
                             window, scale, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, o, B, H, K, S, T_len, st, causal,
                              window, scale, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, K, S, T_len, st,
                                     causal, window, scale, s);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, K, S, T_len, st,
                                      causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
