// flash_attention_bwd: the gradient of flash_attention.cu's attention, for
// training on Hopper.
//
// Not a TPU kernel: the JAX package has no backward kernel (no custom_vjp in
// src/repro/kernels/); jax.grad differentiates its pure-jnp flash attention
// (src/repro/kernels/ops.py::_xla_flash), which XLA compiles.  The port's
// forward is a ctypes call that autograd cannot see through, so its
// torch.autograd.Function (flash_attention.py::FlashAttention) calls this.
//
// What it computes, FA2-style, from the forward's inputs, its output o and
// the rows' log-sum-exp lse (flash_attention.cu writes it on request), for
// S = T (what training reaches), causal, causal with a window, or
// non-causal with or without one, GQA by kv head h // rep:
//   P_ij  = exp(q_i . k_j * scale - lse_i)   (0 where masked or lse = -inf)
//   D_i   = dO_i . o_i
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dK_j  = scale sum_i dS_ij q_i
//   dQ_i  = scale sum_j dS_ij k_j
// in three launches on the caller's stream:
//  1. dot_rows: D, one warp a (b, s, h) row, lanes over dh, a fixed butterfly.
//  2. kv: one block a (b, kv head, key tile).  Each thread holds 8 columns of
//     one key's k, v, dK and dV in registers; the block walks every query
//     row of the kv head's rep query heads, position-major (the forward's
//     row order), staging q and dO rows in shared memory, so dK and dV are
//     written once, by one thread each, with no atomics.
//  3. q: one block a (b, head, query tile), the same thread layout over
//     query rows, walking the keys in order through shared memory.
// No float atomics and a fixed order of every sum: the gradients are the
// same bits run to run, which the trainer's bit-equal resume needs.
//
// A simple kernel, right first: f32 FMA on the CUDA cores from the loaded
// values (bf16 converted on load), no wgmma and no TMA.  What bounds it on
// an H100: operations, about 2.5x the forward's (four dh-long dots or
// updates a (query, key) pair in pass 2, three in pass 3) at the f32 rate,
// since it does not use the tensor cores; a dot's TPR-wide reduction costs
// log2(TPR) shuffles.  Making it fast is later work.
//
// Any head dim up to 256: instances at a padded DP of 32, 64, 128 or 256
// (flash_attention.py::padded_dim), TPR = DP / 8 threads a row, 8 columns a
// thread (columns i * TPR + sub, so a warp's shared-memory reads are
// broadcasts or distinct banks); columns past dh load as 0 and are not
// stored.  Inputs are contiguous (the wrapper makes them so): q, o, dO, dQ
// (B, S, H, dh); k, v, dK, dV (B, S, K, dh); lse, D (B, H, S) f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
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

// Per padded head dim: threads a row (8 columns each), rows a block (keys in
// pass 2, queries in pass 3) and rows staged a step in shared memory (two
// CHUNK x DP f32 tiles: 32 KB).
template <int DP>
struct Bw {
  static constexpr int TPR = DP / 8;
  static constexpr int DPT = 8;
  static constexpr int ROWS = THREADS / TPR;
  static constexpr int CHUNK = 4096 / DP;
};

// the sum over a row's TPR threads (consecutive lanes): a fixed butterfly,
// so every lane of the group gets the same bits
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// D = rowsum(dO * o), laid out (B, H, S)
template <typename T>
__global__ void __launch_bounds__(THREADS)
dot_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ D, int B, int S, int H, int dh) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * S * H) return;   // the whole warp leaves
  const T* orow = o + row * dh;
  const T* grow = dout + row * dh;
  float s = 0.f;
  for (int c = lane; c < dh; c += 32) s += ld(orow + c) * ld(grow + c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int si = (int)(bs % S);
    const long long b = bs / S;
    D[(b * H + h) * S + si] = s;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    T* __restrict__ dk, T* __restrict__ dv, int H, int K,
                    int S, int dh, int causal, int window, float scale) {
  constexpr int TPR = Bw<DP>::TPR;
  constexpr int DPT = Bw<DP>::DPT;
  constexpr int ROWS = Bw<DP>::ROWS;
  constexpr int CHUNK = Bw<DP>::CHUNK;
  __shared__ float qs[CHUNK][DP];
  __shared__ float gs[CHUNK][DP];
  __shared__ float ls[CHUNK];
  __shared__ float dd[CHUNK];
  __shared__ int ps[CHUNK];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / K;
  const int j0 = blockIdx.x * ROWS;
  const int j = j0 + tid / TPR;
  const bool key_ok = j < S;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = i * TPR + sub;
    const long long off = (((long long)b * S + j) * K + kvh) * dh + c;
    kr[i] = key_ok && c < dh ? ld(k + off) : 0.f;
    vr[i] = key_ok && c < dh ? ld(v + off) : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }

  // the query positions that see a key of this block: [i_lo, i_hi]
  const int j_last = min(S, j0 + ROWS) - 1;
  int i_lo = 0, i_hi = S - 1;
  if (causal) {
    i_lo = j0;
    if (window > 0) i_hi = min(i_hi, j_last + window - 1);
  } else if (window > 0) {
    i_lo = max(0, j0 - window + 1);
    i_hi = min(i_hi, j_last + window - 1);
  }
  // (position, head) rows of the kv head, position-major
  const long long r_lo = (long long)i_lo * rep;
  const long long r_end = (long long)(i_hi + 1) * rep;

  for (long long r0 = r_lo; r0 < r_end; r0 += CHUNK) {
    __syncthreads();                         // the previous chunk consumed
    for (int idx = tid; idx < CHUNK * DP; idx += THREADS) {
      const int rr = idx / DP;
      const int c = idx % DP;
      const long long r = r0 + rr;
      float qv = 0.f, gv = 0.f;
      if (r < r_end && c < dh) {
        const long long pos = r / rep;
        const int h = kvh * rep + (int)(r % rep);
        const long long off = (((long long)b * S + pos) * H + h) * dh + c;
        qv = ld(q + off);
        gv = ld(dout + off);
      }
      qs[rr][c] = qv;
      gs[rr][c] = gv;
    }
    for (int rr = tid; rr < CHUNK; rr += THREADS) {
      const long long r = r0 + rr;
      if (r < r_end) {
        const int pos = (int)(r / rep);
        const int h = kvh * rep + (int)(r % rep);
        const long long at = ((long long)b * H + h) * S + pos;
        ls[rr] = lse[at];
        dd[rr] = D[at];
        ps[rr] = pos;
      } else {
        ls[rr] = -INFINITY;
        dd[rr] = 0.f;
        ps[rr] = -1;
      }
    }
    __syncthreads();
    const int n = (int)min((long long)CHUNK, r_end - r0);
    for (int rr = 0; rr < n; ++rr) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int c = i * TPR + sub;
        sp += qs[rr][c] * kr[i];
        dp += gs[rr][c] * vr[i];
      }
      sp = group_sum<TPR>(sp);
      dp = group_sum<TPR>(dp);
      const float l = ls[rr];
      const bool ok = key_ok && l != -INFINITY &&
                      allowed(ps[rr], j, causal, window);
      const float p = ok ? expf(sp * scale - l) : 0.f;
      const float ds = p * (dp - dd[rr]);
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int c = i * TPR + sub;
        dvr[i] += p * gs[rr][c];
        dkr[i] += ds * qs[rr][c];
      }
    }
  }

  if (key_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = i * TPR + sub;
      if (c < dh) {
        const long long off = (((long long)b * S + j) * K + kvh) * dh + c;
        st(dk + off, dkr[i] * scale);
        st(dv + off, dvr[i]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   T* __restrict__ dq, int H, int K, int S, int dh,
                   int causal, int window, float scale) {
  constexpr int TPR = Bw<DP>::TPR;
  constexpr int DPT = Bw<DP>::DPT;
  constexpr int ROWS = Bw<DP>::ROWS;
  constexpr int CHUNK = Bw<DP>::CHUNK;
  __shared__ float ks[CHUNK][DP];
  __shared__ float vs[CHUNK][DP];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int i0 = blockIdx.x * ROWS;
  const int qi = i0 + tid / TPR;
  const bool row_ok = qi < S;

  float qr[DPT], gr[DPT], dqr[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = i * TPR + sub;
    const long long off = (((long long)b * S + qi) * H + h) * dh + c;
    qr[i] = row_ok && c < dh ? ld(q + off) : 0.f;
    gr[i] = row_ok && c < dh ? ld(dout + off) : 0.f;
    dqr[i] = 0.f;
  }
  const long long at = ((long long)b * H + h) * S + qi;
  const float l = row_ok ? lse[at] : -INFINITY;
  const float Dq = row_ok ? D[at] : 0.f;

  // the keys a query of the block sees: [j_lo, j_hi]
  const int i_last = min(S, i0 + ROWS) - 1;
  int j_lo = 0, j_hi = S - 1;
  if (causal) {
    j_hi = i_last;
    if (window > 0) j_lo = max(0, i0 - window + 1);
  } else if (window > 0) {
    j_lo = max(0, i0 - window + 1);
    j_hi = min(j_hi, i_last + window - 1);
  }

  for (int t0 = j_lo; t0 <= j_hi; t0 += CHUNK) {
    __syncthreads();                         // the previous tile consumed
    for (int idx = tid; idx < CHUNK * DP; idx += THREADS) {
      const int jj = idx / DP;
      const int c = idx % DP;
      const int kp = t0 + jj;
      float kv = 0.f, vv = 0.f;
      if (kp <= j_hi && c < dh) {
        const long long off = (((long long)b * S + kp) * K + kvh) * dh + c;
        kv = ld(k + off);
        vv = ld(v + off);
      }
      ks[jj][c] = kv;
      vs[jj][c] = vv;
    }
    __syncthreads();
    const int n = min(CHUNK, j_hi + 1 - t0);
    for (int jj = 0; jj < n; ++jj) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int c = i * TPR + sub;
        sp += qr[i] * ks[jj][c];
        dp += gr[i] * vs[jj][c];
      }
      sp = group_sum<TPR>(sp);
      dp = group_sum<TPR>(dp);
      const bool ok = row_ok && l != -INFINITY &&
                      allowed(qi, t0 + jj, causal, window);
      const float p = ok ? expf(sp * scale - l) : 0.f;
      const float ds = p * (dp - Dq);
#pragma unroll
      for (int i = 0; i < DPT; ++i) dqr[i] += ds * ks[jj][i * TPR + sub];
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = i * TPR + sub;
      if (c < dh)
        st(dq + (((long long)b * S + qi) * H + h) * dh + c, dqr[i] * scale);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* D, int B, int H, int K, int S, int dh, int causal,
           int window, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dot_rows_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(o), gt, D, B, S, H, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int ROWS = Bw<DP>::ROWS;
  const unsigned tiles = (unsigned)((S + ROWS - 1) / ROWS);
  flash_bwd_kv_kernel<T, DP><<<dim3(tiles, K, B), THREADS, 0, s>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), H,
      K, S, dh, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_q_kernel<T, DP><<<dim3(tiles, H, B), THREADS, 0, s>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dq), H, K, S, dh, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, S, H, dh); k, v, dk, dv (B, S, K, dh): contiguous, one
// dtype (0 = float32, 1 = bfloat16); lse (B, H, S) f32 from the forward; D a
// (B, H, S) f32 scratch.  S = T, dh in [1, 256].  Three launches on
// `stream`; returns the first launch error, else cudaGetLastError().
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* D,
    int B, int H, int K, int S, int dh, int dtype, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || dh < 1 || dh > 256 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* Df = static_cast<float*>(D);
  const int dp = dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
  using bf = __nv_bfloat16;
#define REPRO_FA_BWD(DP)                                                     \
  if (dp == DP)                                                              \
    return dtype == 0                                                        \
               ? launch<float, DP>(q, k, v, o, dout, lf, dq, dk, dv, Df, B,  \
                                   H, K, S, dh, causal, window, scale, s)    \
               : launch<bf, DP>(q, k, v, o, dout, lf, dq, dk, dv, Df, B, H,  \
                                K, S, dh, causal, window, scale, s)
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  REPRO_FA_BWD(32);
  REPRO_FA_BWD(64);
  REPRO_FA_BWD(128);
  REPRO_FA_BWD(256);
#undef REPRO_FA_BWD
  return (int)cudaErrorInvalidValue;
}
