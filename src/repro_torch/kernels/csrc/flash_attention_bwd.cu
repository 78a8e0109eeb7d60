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
// in three launches on the caller's stream: D, then a kv pass that writes
// dK and dV, then a q pass that writes dQ.  No float atomics and a fixed
// order of every sum: each output element is written once, by the one
// thread that summed it, so the gradients are the same bits run to run,
// which the trainer's bit-equal resume needs.
//
// What bounds it on an H100: operations.  The two passes do seven products
// of (query, key) pairs over dh (S^T, dP^T, dV, dK in the kv pass; S, dP, dQ
// in the q pass), 14.1 GFLOP at smollm-360m's training shape (8, 512, 15/5,
// 64, causal), against 15.7 MB of o and dO that D reads and about 42 MB of
// inputs and gradients in all.  On the CUDA cores (the first design, f32
// FMA with a shuffle butterfly a dot) that work took 1.58 ms; on the tensor
// cores it is some 0.014 ms at the bf16 peak, so the design moves every
// product onto them.  It takes about 0.10 ms at that shape (PERF.md), some
// 14% of that peak.  What holds it there is not measured; the likeliest
// limit is latency: with 16 x DP f32 of dK and dV a warp, a kv-pass SM
// holds 8 warps, few to hide one tile's chain S^T -> P^T -> dV behind
// another's products.
//
// bf16: FA2's backward on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate; the building blocks of mma.cuh, as flash_attention.cu's
// flash_tc_kernel):
//  * D = rowsum(dO * o): 8 lanes a (b, s, h) row, 16 bytes a lane a step,
//    a fixed 3-step butterfly (bound by bytes).
//  * kv pass: a block a (b, kv head, tile of 64 keys); its warps own 16 keys
//    each.  The block walks the kv head's (position, head) rows,
//    position-major, in tiles of KV_ROWS rows at multiples of KV_ROWS, from
//    the first tile any of its keys sees; Q and dO tiles (bf16) with the
//    rows' lse, D and position are staged by cp.async into two buffers, so
//    the next tile's copy overlaps this tile's products.  A tile is
//    S^T = K Q^T and dP^T = V dO^T (Q and dO by plain ldmatrix as B), then
//    P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - D) on the
//    accumulator fragments, rounded to bf16 in registers and reused as the A
//    operand of dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix .trans).
//    dK and dV stay in f32 registers and are written once, by their warp,
//    dK times the scale.
//  * q pass: a block a (b, kv head, 64 (position, head) rows), GQA-packed
//    as the forward, so the rep query heads of a kv head share each K/V
//    tile; a warp's 16 rows keep Q and dO as A fragments in registers (at
//    DP 256 they are read again from shared memory: the 16 x 256 f32 dQ
//    takes 128 registers), with lse and D.  It walks the key tiles in order
//    at absolute positions, double-buffered: S = Q K^T, dP = dO V^T, P, dS,
//    then dQ += dS K (dS the bf16 A operand, K by ldmatrix .trans).
//  * Tiles wholly above the diagonal or outside the window are skipped; only
//    tiles that straddle an edge are masked (the q pass by each row's key
//    range, as the forward; the kv pass by each key's query range), by a
//    separate instance of the elementwise step, so a whole tile pays for no
//    compare.  exp2 is the SFU's ex2.approx, without the accurate exp2f's
//    range handling.
//  * The kv pass runs its blocks heaviest first: the key tile is the slowest
//    index of the grid, so under a causal mask the low key tiles, which see
//    the most rows, start first; the q pass likewise takes its last row
//    tiles first.
//  * Registers bound the occupancy: a warp's dK and dV for 16 keys are 16 x
//    DP f32 each.  Up to DP 128 a warp owns all DP columns (128 registers
//    at DP 128, where K and V are read from shared memory each tile rather
//    than kept in registers); at DP 256 two warps share a group of 16 keys,
//    each owning 128 of the columns of its dK and dV and both computing the
//    tile's S^T and dP^T (KV_SPLIT 2: 8 warps a block), and the q pass reads
//    Q and dO from shared memory each tile.  At DP 64 the kv pass holds 2
//    blocks an SM (245 registers); its 32-row tile (180 registers) runs
//    slower (ab.py --sweep).  The q pass at DP 64 is compiled for 4 blocks
//    an SM (Q_MIN_BLOCKS: 128 registers and a 32-byte spill); the EXACT kv
//    instance at DP 128 spills 28 bytes.
//  * The tiles are a function of the padded dim alone (Bk below, mirrored
//    by flash_attention_bwd.py::plan_bwd), chosen by ab.py --sweep on the
//    card: 64 rows a kv tile, and 32 keys a q tile at DP 64 but 64 at DP
//    128; DP 64 and 128 are also built at the other tile sizes, for the
//    sweep.
//  * Dynamic shared memory (57 KB for the kv pass at DP 64, 133 KB at DP
//    256), opted in once per instance.  Head dims below the padded one (20,
//    80, 120) load through mma::cp_chunk's zero-fill; a call at dh = DP
//    with 16-byte aligned rows runs the EXACT instance, which has no such
//    masks.
//
// f32 keeps the first design, as the forward's f32 path does, since the
// card-vs-CPU checks at 1e-4 need full f32 (TF32 would not hold them):
//  1. dot_rows: D, one warp a (b, s, h) row, lanes over dh, a fixed butterfly.
//  2. kv: one block a (b, kv head, key tile).  Each thread holds 8 columns of
//     one key's k, v, dK and dV in registers; the block walks every query
//     row of the kv head's rep query heads, position-major (the forward's
//     row order), staging q and dO rows in shared memory, so dK and dV are
//     written once, by one thread each, with no atomics.
//  3. q: one block a (b, head, query tile), the same thread layout over
//     query rows, walking the keys in order through shared memory.
// f32 FMA on the CUDA cores, a dot's TPR-wide reduction in log2(TPR)
// shuffles; TPR = DP / 8 threads a row, 8 columns a thread (columns
// i * TPR + sub, so a warp's shared-memory reads are broadcasts or distinct
// banks); columns past dh load as 0 and are not stored.
//
// Any head dim up to 256: instances at a padded DP of 32, 64, 128 or 256
// (flash_attention.py::padded_dim).  Inputs are contiguous (the wrapper
// makes them so): q, o, dO, dQ (B, S, H, dh); k, v, dK, dV (B, S, K, dh);
// lse, D (B, H, S) f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores (the first design)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;


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
__global__ void __launch_bounds__(THREADS)
dot_rows_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ D, int B, int S, int H, int dh) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * S * H) return;   // the whole warp leaves
  const float* orow = o + row * dh;
  const float* grow = dout + row * dh;
  float s = 0.f;
  for (int c = lane; c < dh; c += 32) s += orow[c] * grow[c];
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

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kv_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    float* __restrict__ dk, float* __restrict__ dv, int H,
                    int K,
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
    kr[i] = key_ok && c < dh ? k[off] : 0.f;
    vr[i] = key_ok && c < dh ? v[off] : 0.f;
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
        qv = q[off];
        gv = dout[off];
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
        dk[off] = dkr[i] * scale;
        dv[off] = dvr[i];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_q_kernel(const float* __restrict__ q,
                   const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   float* __restrict__ dq, int H, int K, int S, int dh,
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
    qr[i] = row_ok && c < dh ? q[off] : 0.f;
    gr[i] = row_ok && c < dh ? dout[off] : 0.f;
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
        kv = k[off];
        vv = v[off];
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
        dq[(((long long)b * S + qi) * H + h) * dh + c] = dqr[i] * scale;
    }
  }
}

template <int DP>
int launch_fma(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* D, int B, int H, int K, int S, int dh, int causal,
           int window, float scale, cudaStream_t s) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dot_rows_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const float*>(o), gt, D, B, S, H, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int ROWS = Bw<DP>::ROWS;
  const unsigned tiles = (unsigned)((S + ROWS - 1) / ROWS);
  flash_bwd_kv_kernel<DP><<<dim3(tiles, K, B), THREADS, 0, s>>>(
      qt, kt, vt, gt, lse, D, static_cast<float*>(dk),
      static_cast<float*>(dv), H,
      K, S, dh, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_q_kernel<DP><<<dim3(tiles, H, B), THREADS, 0, s>>>(
      qt, kt, vt, gt, lse, D, static_cast<float*>(dq), H, K, S, dh, causal,
      window, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KV_KEYS = 64;       // keys a kv-pass block: 4 groups of 16
constexpr int Q_ROWS = 64;        // (position, head) rows a q-pass block

// Per padded head dim (flash_attention_bwd.py::plan_bwd mirrors these):
// warps sharing a group of 16 keys in the kv pass (each owning DP / KV_SPLIT
// columns of its dK and dV), rows a Q / dO tile of the kv pass, keys a K / V
// tile of the q pass, the other tile sizes built for ab.py --sweep, the
// blocks an SM the q pass at Q_KEYS is compiled for (its registers capped
// to fit them), and whether the kv pass keeps its K and V fragments, and
// the q pass its Q and dO fragments, in registers.
template <int DP>
struct Bk;
template <>
struct Bk<32> {
  static constexpr int KV_SPLIT = 1, KV_ROWS = 64, Q_KEYS = 64;
  static constexpr int KV_ROWS_ALT = 64, Q_KEYS_ALT = 64;
  static constexpr int Q_MIN_BLOCKS = 1;
  static constexpr bool KREG = true, QREG = true;
};
template <>
struct Bk<64> {
  static constexpr int KV_SPLIT = 1, KV_ROWS = 64, Q_KEYS = 32;
  static constexpr int KV_ROWS_ALT = 32, Q_KEYS_ALT = 64;
  static constexpr int Q_MIN_BLOCKS = 4;
  static constexpr bool KREG = true, QREG = true;
};
template <>
struct Bk<128> {
  static constexpr int KV_SPLIT = 1, KV_ROWS = 64, Q_KEYS = 64;
  static constexpr int KV_ROWS_ALT = 32, Q_KEYS_ALT = 32;
  static constexpr int Q_MIN_BLOCKS = 1;
  static constexpr bool KREG = false, QREG = true;
};
template <>
struct Bk<256> {
  static constexpr int KV_SPLIT = 2, KV_ROWS = 32, Q_KEYS = 32;
  static constexpr int KV_ROWS_ALT = 32, Q_KEYS_ALT = 32;
  static constexpr int Q_MIN_BLOCKS = 1;
  static constexpr bool KREG = false, QREG = false;
};

// shared memory: the kv pass's K and V tiles, two buffers of Q and dO rows
// and two of the rows' lse, D and position; the q pass's Q and dO rows and
// two buffers of K and V
constexpr int kv_smem_bytes(int dp, int rows) {
  return (2 * KV_KEYS + 4 * rows) * (dp + 8) * 2 + 2 * rows * 12;
}
constexpr int q_smem_bytes(int dp, int keys) {
  return (2 * Q_ROWS + 4 * keys) * (dp + 8) * 2;
}

// 4 bytes global -> shared, zero-filling past src_bytes (0 or 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the keys a query at position qpos sees, inclusive [x, y] (empty where
// !ok), and the queries a key at kpos is seen by: allowed() as two compares
__device__ __forceinline__ int2 key_range(int qpos, bool ok, int causal,
                                          int window, int S) {
  int lo = 0, hi = S - 1;
  if (causal) {
    hi = min(hi, qpos);
    if (window > 0) lo = qpos - window + 1;
  } else if (window > 0) {
    lo = qpos - window + 1;
    hi = min(hi, qpos + window - 1);
  }
  return ok ? make_int2(lo, hi) : make_int2(1, 0);
}
__device__ __forceinline__ int2 query_range(int kpos, int causal,
                                            int window) {
  if (causal)
    return make_int2(kpos, window > 0 ? kpos + window - 1 : INT_MAX);
  if (window > 0) return make_int2(kpos - window + 1, kpos + window - 1);
  return make_int2(INT_MIN, INT_MAX);
}

// lse in the log2 domain; a row with no key (-inf) gets +inf, so its P is 0
__device__ __forceinline__ float lse_log2(float l) {
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

// 2^x by the SFU (ex2.approx, about 2 ulp; a result below 2^-126 is 0),
// without the accurate exp2f's range handling
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - D) of a kv
// tile, in place on the fragments (rows: keys g, g + 8; columns: the
// tile's rows 8 i + 2 t, + 1, whose lse, D and position are staged in lt,
// dt, pt).  MASK: P^T is 0 where the row's position is outside the key's
// query range (qa for key g, qb for key g + 8).
template <bool MASK, int NT>
__device__ __forceinline__ void kv_probs(float (&st)[NT][4],
                                         float (&dpt)[NT][4],
                                         const float* lt, const float* dt,
                                         const int* pt, int t, int2 qa,
                                         int2 qb, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int c0 = i * 8 + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(lt + c0);
    const float2 d2 = *reinterpret_cast<const float2*>(dt + c0);
    const float lb[2] = {lse_log2(l2.x), lse_log2(l2.y)};
    const float db[2] = {d2.x, d2.y};
    int pos[2] = {0, 0};
    if constexpr (MASK) {
      const int2 p2 = *reinterpret_cast<const int2*>(pt + c0);
      pos[0] = p2.x;
      pos[1] = p2.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(st[i][e] * scale_log2 - lb[e & 1]);
      if constexpr (MASK) {
        const int2 rg = e >= 2 ? qb : qa;
        if (pos[e & 1] < rg.x || pos[e & 1] > rg.y) p = 0.f;
      }
      st[i][e] = p;
      dpt[i][e] = p * (dpt[i][e] - db[e & 1]);
    }
  }
}

// P and dS of a q tile in place on the fragments (rows ra, rb of the
// thread: lse log2e l2a, l2b and D da, db; columns keys t0 + 8 i + 2 t, + 1),
// dS into sc.  MASK: P is 0 outside each row's key range.
template <bool MASK, int NT>
__device__ __forceinline__ void q_probs(float (&sc)[NT][4],
                                        const float (&dpp)[NT][4], int t0,
                                        int t, int2 rg_a, int2 rg_b,
                                        float l2a, float l2b, float da,
                                        float db, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(sc[i][e] * scale_log2 - (e >= 2 ? l2b : l2a));
      if constexpr (MASK) {
        const int kp = t0 + i * 8 + 2 * t + (e & 1);
        const int2 rg = e >= 2 ? rg_b : rg_a;
        if (kp < rg.x || kp > rg.y) p = 0.f;
      }
      sc[i][e] = p * (dpp[i][e] - (e >= 2 ? db : da));
    }
}

// A thread's columns col0 + 8 i + 2 t, + 1 of one output row (acc elements
// e0, e0 + 1 of n-tile i) times mul, in bf16: one paired store where both
// lie below dh and the pair is aligned (dh even), else element-wise.
template <int NTL, bool EXACT>
__device__ __forceinline__ void store_cols(bf16* row,
                                           const float (&acc)[NTL][4],
                                           int e0, float mul, int col0, int t,
                                           int dh) {
#pragma unroll
  for (int i = 0; i < NTL; ++i) {
    const int c = col0 + i * 8 + 2 * t;
    const float x0 = acc[i][e0] * mul;
    const float x1 = acc[i][e0 + 1] * mul;
    if (EXACT || (c + 1 < dh && (dh & 1) == 0)) {
      *reinterpret_cast<uint32_t*>(row + c) = mma::pack_bf16(x0, x1);
    } else {
      if (c < dh) row[c] = __float2bfloat16_rn(x0);
      if (c + 1 < dh) row[c + 1] = __float2bfloat16_rn(x1);
    }
  }
}

// D = rowsum(dO * o), laid out (B, H, S): 8 lanes a (b, s, h) row, 8
// elements (16 bytes) a lane a step where vec (dh % 8 == 0, 16-byte aligned
// bases), else element by element; a fixed 3-step butterfly.
__global__ void __launch_bounds__(256)
dot_rows_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dout,
              float* __restrict__ D, long long rows, int S, int H, int dh,
              int vec) {
  const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int sub = threadIdx.x & 7;
  float s = 0.f;
  if (row < rows) {
    const bf16* orow = o + row * dh;
    const bf16* grow = dout + row * dh;
    if (vec) {
      for (int c = sub * 8; c < dh; c += 64) {
        const uint4 a = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 w = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(a2[e]);
          const float2 fw = __bfloat1622float2(w2[e]);
          s += fa.x * fw.x;
          s += fa.y * fw.y;
        }
      }
    } else {
      for (int c = sub; c < dh; c += 8)
        s += __bfloat162float(orow[c]) * __bfloat162float(grow[c]);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (sub == 0 && row < rows) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int si = (int)(bs % S);
    const long long b = bs / S;
    D[(b * H + h) * S + si] = s;
  }
}

// kv pass: dK and dV of one (b, kv head, tile of 64 keys)
template <int DP, int ROWS, bool EXACT>
__global__ void __launch_bounds__(128 * Bk<DP>::KV_SPLIT)
bwd_kv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int K,
          int S, int dh, int causal, int window, float scale,
          float scale_log2, int qvb, int kvvb) {
  constexpr int SPLIT = Bk<DP>::KV_SPLIT;
  constexpr bool KREG = Bk<DP>::KREG;
  constexpr int NTHR = 128 * SPLIT;
  constexpr int PITCH = DP + 8;             // ldmatrix rows in distinct banks
  constexpr int CH = DP / 8;                // 16-byte chunks a row
  constexpr int NT = ROWS / 8;              // n-tiles of S^T (query rows)
  constexpr int DW = DP / SPLIT;            // dK / dV columns a warp owns
  extern __shared__ __align__(16) unsigned char kv_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(kv_smem);  // [KV_KEYS][PITCH]
  bf16* Vs = Ks + KV_KEYS * PITCH;
  bf16* Qs = Vs + KV_KEYS * PITCH;              // [2][ROWS][PITCH]
  bf16* Gs = Qs + 2 * ROWS * PITCH;             // dO, [2][ROWS][PITCH]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * ROWS * PITCH);  // [2][ROWS]
  float* Dm = Ls + 2 * ROWS;
  int* Ps = reinterpret_cast<int*>(Dm + 2 * ROWS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lj = lane >> 3;                 // ldmatrix: matrix lane / 8,
  const int lr = lane & 7;                  // row lane % 8 of it
  const int grp = warp & 3;                 // the warp's 16 keys
  const int part = warp >> 2;               // its columns of dK and dV
  const int rep = H / K;
  // the key tile is the grid's slowest index: heaviest first under causal
  const int per = K * B;
  const int j0 = (blockIdx.x / per) * KV_KEYS;
  const int kvh = (blockIdx.x % per) % K;
  const int b = (blockIdx.x % per) / K;

  for (int c = tid; c < KV_KEYS * CH; c += NTHR) {
    const int row = c / CH;
    const int ch = c % CH;
    const int j = j0 + row;
    const bool ok = j < S;
    const long long off = ok ? (((long long)b * S + j) * K + kvh) * dh +
                                   ch * 8
                             : 0;
    mma::cp_chunk<EXACT>(Ks + row * PITCH + ch * 8, k + off, ok,
                         dh - ch * 8, kvvb, k);
    mma::cp_chunk<EXACT>(Vs + row * PITCH + ch * 8, v + off, ok,
                         dh - ch * 8, kvvb, v);
  }
  mma::cp_commit();

  // the (position, head) rows that see a key of the block, [r_lo, r_end),
  // walked in tiles at multiples of ROWS
  const int j_last = min(S, j0 + KV_KEYS) - 1;
  int i_lo = 0, i_hi = S - 1;
  if (causal) {
    i_lo = j0;
    if (window > 0) i_hi = min(i_hi, j_last + window - 1);
  } else if (window > 0) {
    i_lo = max(0, j0 - window + 1);
    i_hi = min(i_hi, j_last + window - 1);
  }
  const int r_end = (i_hi + 1) * rep;
  const int t_first = (i_lo * rep / ROWS) * ROWS;
  const int ntiles = (r_end - t_first + ROWS - 1) / ROWS;

  // Q and dO rows of a tile (zero past r_end: they add exactly 0), with
  // each row's lse, D and position
  auto load_q = [&](int buf, int r0) {
    for (int c = tid; c < ROWS * CH; c += NTHR) {
      const int row = c / CH;
      const int ch = c % CH;
      const int r = r0 + row;
      const bool ok = r < r_end;
      const long long off =
          ok ? (((long long)b * S + r / rep) * H + kvh * rep + r % rep) * dh +
                   ch * 8
             : 0;
      mma::cp_chunk<EXACT>(Qs + (buf * ROWS + row) * PITCH + ch * 8, q + off,
                           ok, dh - ch * 8, qvb, q);
      mma::cp_chunk<EXACT>(Gs + (buf * ROWS + row) * PITCH + ch * 8,
                           dout + off, ok, dh - ch * 8, qvb, dout);
    }
    for (int i = tid; i < ROWS; i += NTHR) {
      const int r = r0 + i;
      const bool ok = r < r_end;
      const long long at =
          ok ? ((long long)b * H + kvh * rep + r % rep) * S + r / rep : 0;
      cp_async4(Ls + buf * ROWS + i, lse + at, ok ? 4 : 0);
      cp_async4(Dm + buf * ROWS + i, D + at, ok ? 4 : 0);
      Ps[buf * ROWS + i] = r / rep;
    }
    mma::cp_commit();
  };

  // this warp's keys [kw0, kw1], the query range of each, and of the
  // thread's two keys (rows g and g + 8 of the warp's 16)
  const int kw0 = j0 + 16 * grp;
  const bool warp_live = kw0 < S;
  const int kw1 = min(S - 1, kw0 + 15);
  const int2 rw0 = query_range(kw0, causal, window);
  const int2 rw1 = query_range(kw1, causal, window);
  const int2 qr_a = query_range(kw0 + g, causal, window);
  const int2 qr_b = query_range(kw0 + g + 8, causal, window);

  float dka[DW / 8][4], dva[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  uint32_t kf[KREG ? DP / 16 : 1][4], vf[KREG ? DP / 16 : 1][4];
  const bf16* k_lane = Ks + (16 * grp + (lj & 1) * 8 + lr) * PITCH +
                       (lj >> 1) * 8;
  const bf16* v_lane = Vs + (16 * grp + (lj & 1) * 8 + lr) * PITCH +
                       (lj >> 1) * 8;

  load_q(0, t_first);
  for (int it = 0; it < ntiles; ++it) {
    const int r0 = t_first + it * ROWS;
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_q(buf ^ 1, r0 + ROWS);
      mma::cp_wait<1>();
    } else {
      mma::cp_wait<0>();
    }
    __syncthreads();
    if constexpr (KREG) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < DP / 16; ++kc) {
          mma::ldmatrix_x4(kf[kc], k_lane + kc * 16);
          mma::ldmatrix_x4(vf[kc], v_lane + kc * 16);
        }
      }
    }
    // the tile's positions; skip it where no key of the warp sees any,
    // mask it only where some key does not see all
    const int p_lo = r0 / rep;
    const int p_hi = (min(r0 + ROWS, r_end) - 1) / rep;
    if (warp_live && p_hi >= rw0.x && p_lo <= rw1.y) {
      const bool whole = p_lo >= rw1.x && p_hi <= rw0.y;
      const bf16* qt = Qs + buf * ROWS * PITCH;
      const bf16* gt = Gs + buf * ROWS * PITCH;
      const float* lt = Ls + buf * ROWS;
      const float* dt = Dm + buf * ROWS;
      const int* pt = Ps + buf * ROWS;
      // S^T = K Q^T and dP^T = V dO^T, 16 keys x ROWS rows in f32
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        uint32_t ka[4], va[4];
        if constexpr (KREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kc][e];
            va[e] = vf[kc][e];
          }
        } else {
          mma::ldmatrix_x4(ka, k_lane + kc * 16);
          mma::ldmatrix_x4(va, v_lane + kc * 16);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (np * 16 + (lj >> 1) * 8 + lr) * PITCH + kc * 16 +
                          (lj & 1) * 8;
          uint32_t qb[4], gb[4];
          mma::ldmatrix_x4(qb, qt + off);
          mma::mma_bf16(st[2 * np], ka, qb[0], qb[1]);
          mma::mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
          mma::ldmatrix_x4(gb, gt + off);
          mma::mma_bf16(dpt[2 * np], va, gb[0], gb[1]);
          mma::mma_bf16(dpt[2 * np + 1], va, gb[2], gb[3]);
        }
      }
      // P^T and dS^T on the fragments: columns are the tile's rows
      if (whole)
        kv_probs<false>(st, dpt, lt, dt, pt, t, qr_a, qr_b, scale_log2);
      else
        kv_probs<true>(st, dpt, lt, dt, pt, t, qr_a, qr_b, scale_log2);
      // dV += P^T dO and dK += dS^T Q over the warp's columns
#pragma unroll
      for (int kc = 0; kc < ROWS / 16; ++kc) {
        const uint32_t pa[4] = {mma::pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                                mma::pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                                mma::pack_bf16(st[2 * kc + 1][0],
                                               st[2 * kc + 1][1]),
                                mma::pack_bf16(st[2 * kc + 1][2],
                                               st[2 * kc + 1][3])};
        const uint32_t sa[4] = {
            mma::pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]),
            mma::pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]),
            mma::pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
            mma::pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DW / 16; ++dp) {
          const int off = (kc * 16 + (lj & 1) * 8 + lr) * PITCH + part * DW +
                          dp * 16 + (lj >> 1) * 8;
          uint32_t gb[4], qb[4];
          mma::ldmatrix_x4_trans(gb, gt + off);
          mma::mma_bf16(dva[2 * dp], pa, gb[0], gb[1]);
          mma::mma_bf16(dva[2 * dp + 1], pa, gb[2], gb[3]);
          mma::ldmatrix_x4_trans(qb, qt + off);
          mma::mma_bf16(dka[2 * dp], sa, qb[0], qb[1]);
          mma::mma_bf16(dka[2 * dp + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();                        // buf consumed before reload
  }
  mma::cp_wait<0>();

  if (warp_live) {
    const int dhr = EXACT ? DP : dh;
    const int ja = kw0 + g;
    const int jb = ja + 8;
    if (ja < S) {
      const long long at = (((long long)b * S + ja) * K + kvh) * dhr;
      store_cols<DW / 8, EXACT>(dk + at, dka, 0, scale, part * DW, t, dh);
      store_cols<DW / 8, EXACT>(dv + at, dva, 0, 1.f, part * DW, t, dh);
    }
    if (jb < S) {
      const long long at = (((long long)b * S + jb) * K + kvh) * dhr;
      store_cols<DW / 8, EXACT>(dk + at, dka, 2, scale, part * DW, t, dh);
      store_cols<DW / 8, EXACT>(dv + at, dva, 2, 1.f, part * DW, t, dh);
    }
  }
}

// q pass: dQ of one (b, kv head, tile of 64 (position, head) rows)
template <int DP, int KEYS, bool EXACT>
__global__ void __launch_bounds__(128, KEYS == Bk<DP>::Q_KEYS
                                           ? Bk<DP>::Q_MIN_BLOCKS
                                           : 1)
bwd_q_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const bf16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ D,
         bf16* __restrict__ dq, int B, int H, int K, int S, int dh,
         int causal, int window, float scale, float scale_log2, int qvb,
         int kvvb, int row_tiles) {
  constexpr bool QREG = Bk<DP>::QREG;
  constexpr int PITCH = DP + 8;
  constexpr int CH = DP / 8;
  constexpr int NT = KEYS / 8;              // key n-tiles of S
  constexpr int DT = DP / 8;                // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char q_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(q_smem);   // [Q_ROWS][PITCH]
  bf16* Gs = Qs + Q_ROWS * PITCH;               // dO
  bf16* Ks = Gs + Q_ROWS * PITCH;               // [2][KEYS][PITCH]
  bf16* Vs = Ks + 2 * KEYS * PITCH;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lj = lane >> 3;
  const int lr = lane & 7;
  const int rep = H / K;
  const int rows_total = S * rep;
  // the row tile is the grid's slowest index, last tiles first: under a
  // causal mask they see the most keys
  const int per = K * B;
  const int row0 = (row_tiles - 1 - (int)(blockIdx.x / per)) * Q_ROWS;
  const int kvh = (blockIdx.x % per) % K;
  const int b = (blockIdx.x % per) / K;

  for (int c = tid; c < Q_ROWS * CH; c += 128) {
    const int row = c / CH;
    const int ch = c % CH;
    const int r = row0 + row;
    const bool ok = r < rows_total;
    const long long off =
        ok ? (((long long)b * S + r / rep) * H + kvh * rep + r % rep) * dh +
                 ch * 8
           : 0;
    mma::cp_chunk<EXACT>(Qs + row * PITCH + ch * 8, q + off, ok, dh - ch * 8,
                         qvb, q);
    mma::cp_chunk<EXACT>(Gs + row * PITCH + ch * 8, dout + off, ok,
                         dh - ch * 8, qvb, dout);
  }
  mma::cp_commit();

  auto load_kv = [&](int buf, int t0) {
    for (int c = tid; c < KEYS * CH; c += 128) {
      const int row = c / CH;
      const int ch = c % CH;
      const int kp = t0 + row;
      const bool ok = kp < S;
      const long long off =
          ok ? (((long long)b * S + kp) * K + kvh) * dh + ch * 8 : 0;
      mma::cp_chunk<EXACT>(Ks + (buf * KEYS + row) * PITCH + ch * 8, k + off,
                           ok, dh - ch * 8, kvvb, k);
      mma::cp_chunk<EXACT>(Vs + (buf * KEYS + row) * PITCH + ch * 8, v + off,
                           ok, dh - ch * 8, kvvb, v);
    }
    mma::cp_commit();
  };

  // keys the block can see, [k_begin, k_end), from its first and last row
  const int r_last = min(rows_total, row0 + Q_ROWS) - 1;
  const int pos_lo = row0 / rep;
  const int pos_hi = r_last / rep;
  int k_begin = 0;
  int k_end = S;
  if (causal) {
    k_end = min(S, pos_hi + 1);
    if (window > 0) k_begin = max(0, pos_lo - window + 1);
  } else if (window > 0) {
    k_begin = max(0, pos_lo - window + 1);
    k_end = min(S, pos_hi + window);
  }
  const int t_first = (k_begin / KEYS) * KEYS;        // absolute alignment
  const int ntiles = k_end > t_first ? (k_end - t_first + KEYS - 1) / KEYS : 0;

  // this warp's rows: a = g, b = g + 8 of its 16
  const int wr0 = row0 + 16 * warp;
  const bool warp_live = wr0 < rows_total;
  const int wr_last = min(rows_total, wr0 + 16) - 1;
  const int wpos_lo = wr0 / rep;
  const int wpos_hi = wr_last / rep;
  const int ra = wr0 + g;
  const int rb = ra + 8;
  const bool ok_a = ra < rows_total;
  const bool ok_b = rb < rows_total;
  const int2 rg_a = key_range(ra / rep, ok_a, causal, window, S);
  const int2 rg_b = key_range(rb / rep, ok_b, causal, window, S);
  const long long at_a =
      ((long long)b * H + kvh * rep + ra % rep) * S + ra / rep;
  const long long at_b =
      ((long long)b * H + kvh * rep + rb % rep) * S + rb / rep;
  const float l2a = ok_a ? lse_log2(lse[at_a]) : INFINITY;
  const float l2b = ok_b ? lse_log2(lse[at_b]) : INFINITY;
  const float da = ok_a ? D[at_a] : 0.f;
  const float db = ok_b ? D[at_b] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t qf[QREG ? DP / 16 : 1][4], gf[QREG ? DP / 16 : 1][4];
  const bf16* q_lane = Qs + (16 * warp + (lj & 1) * 8 + lr) * PITCH +
                       (lj >> 1) * 8;
  const bf16* g_lane = Gs + (16 * warp + (lj & 1) * 8 + lr) * PITCH +
                       (lj >> 1) * 8;

  if (ntiles > 0) load_kv(0, t_first);
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * KEYS;
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_kv(buf ^ 1, t0 + KEYS);
      mma::cp_wait<1>();
    } else {
      mma::cp_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < DP / 16; ++kc) {
          mma::ldmatrix_x4(qf[kc], q_lane + kc * 16);
          mma::ldmatrix_x4(gf[kc], g_lane + kc * 16);
        }
      }
    }
    // skip a tile that masks every row of the warp
    bool live = warp_live;
    if (causal) {
      live = live && t0 <= wpos_hi;
      if (window > 0) live = live && t0 + KEYS - 1 > wpos_lo - window;
    } else if (window > 0) {
      live = live && t0 + KEYS - 1 > wpos_lo - window &&
             t0 < wpos_hi + window;
    }
    if (live) {
      const bf16* kt = Ks + buf * KEYS * PITCH;
      const bf16* vt = Vs + buf * KEYS * PITCH;
      // S = Q K^T and dP = dO V^T, 16 rows x KEYS in f32
      float sc[NT][4], dpp[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dpp[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        uint32_t qa[4], ga[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kc][e];
            ga[e] = gf[kc][e];
          }
        } else {
          mma::ldmatrix_x4(qa, q_lane + kc * 16);
          mma::ldmatrix_x4(ga, g_lane + kc * 16);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (np * 16 + (lj >> 1) * 8 + lr) * PITCH + kc * 16 +
                          (lj & 1) * 8;
          uint32_t kb[4], vb[4];
          mma::ldmatrix_x4(kb, kt + off);
          mma::mma_bf16(sc[2 * np], qa, kb[0], kb[1]);
          mma::mma_bf16(sc[2 * np + 1], qa, kb[2], kb[3]);
          mma::ldmatrix_x4(vb, vt + off);
          mma::mma_bf16(dpp[2 * np], ga, vb[0], vb[1]);
          mma::mma_bf16(dpp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }
      // P and dS on the fragments, masked only where the tile is not
      // wholly visible to every row of the warp
      const bool whole = __all_sync(
          0xffffffffu, rg_a.x <= t0 && rg_a.y >= t0 + KEYS - 1 &&
                           rg_b.x <= t0 && rg_b.y >= t0 + KEYS - 1);
      if (whole)
        q_probs<false>(sc, dpp, t0, t, rg_a, rg_b, l2a, l2b, da, db,
                       scale_log2);
      else
        q_probs<true>(sc, dpp, t0, t, rg_a, rg_b, l2a, l2b, da, db,
                      scale_log2);
      // dQ += dS K
#pragma unroll
      for (int kc = 0; kc < KEYS / 16; ++kc) {
        const uint32_t sa[4] = {
            mma::pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
            mma::pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
            mma::pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
            mma::pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t kb[4];
          mma::ldmatrix_x4_trans(
              kb, kt + (kc * 16 + (lj & 1) * 8 + lr) * PITCH + dp * 16 +
                      (lj >> 1) * 8);
          mma::mma_bf16(acc[2 * dp], sa, kb[0], kb[1]);
          mma::mma_bf16(acc[2 * dp + 1], sa, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();                        // buf consumed before reload
  }
  mma::cp_wait<0>();

  const int dhr = EXACT ? DP : dh;
  if (ok_a)
    store_cols<DT, EXACT>(dq + (((long long)b * S + ra / rep) * H +
                                kvh * rep + ra % rep) * dhr,
                          acc, 0, scale, 0, t, dh);
  if (ok_b)
    store_cols<DT, EXACT>(dq + (((long long)b * S + rb / rep) * H +
                                kvh * rep + rb % rep) * dhr,
                          acc, 2, scale, 0, t, dh);
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per
// instance (idempotent: a race is benign)
template <typename Kern>
cudaError_t opt_in(Kern kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

struct TcArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *D;
  bf16 *dq, *dk, *dv;
  int B, H, K, S, dh, causal, window;
  float scale, scale_log2;
  int qvb, kvvb;
  bool exact;
  cudaStream_t s;
};

template <int DP, int ROWS, bool EXACT>
int launch_kv(const TcArgs& a) {
  static bool done = false;
  auto kernel = bwd_kv_tc<DP, ROWS, EXACT>;
  constexpr int bytes = kv_smem_bytes(DP, ROWS);
  const cudaError_t e = opt_in(kernel, bytes, done);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)((a.S + KV_KEYS - 1) / KV_KEYS) * a.K * a.B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128 * Bk<DP>::KV_SPLIT, bytes, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.D, a.dk, a.dv, a.B, a.H, a.K, a.S,
      a.dh, a.causal, a.window, a.scale, a.scale_log2, a.qvb, a.kvvb);
  return (int)cudaGetLastError();
}

template <int DP, int KEYS, bool EXACT>
int launch_q(const TcArgs& a) {
  static bool done = false;
  auto kernel = bwd_q_tc<DP, KEYS, EXACT>;
  constexpr int bytes = q_smem_bytes(DP, KEYS);
  const cudaError_t e = opt_in(kernel, bytes, done);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      ((long long)a.S * (a.H / a.K) + Q_ROWS - 1) / Q_ROWS;
  const long long blocks = tiles * a.K * a.B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128, bytes, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.D, a.dq, a.B, a.H, a.K, a.S, a.dh,
      a.causal, a.window, a.scale, a.scale_log2, a.qvb, a.kvvb, (int)tiles);
  return (int)cudaGetLastError();
}

// the kv pass at ROWS, EXACT or not, where ROWS is one this dim is built at
template <int DP>
int kv_pass(const TcArgs& a, int rows) {
  constexpr int R = Bk<DP>::KV_ROWS, RA = Bk<DP>::KV_ROWS_ALT;
  if (rows == R)
    return a.exact ? launch_kv<DP, R, true>(a) : launch_kv<DP, R, false>(a);
  if (rows == RA)
    return a.exact ? launch_kv<DP, RA, true>(a) : launch_kv<DP, RA, false>(a);
  return (int)cudaErrorInvalidValue;
}

template <int DP>
int q_pass(const TcArgs& a, int keys) {
  constexpr int T = Bk<DP>::Q_KEYS, TA = Bk<DP>::Q_KEYS_ALT;
  if (keys == T)
    return a.exact ? launch_q<DP, T, true>(a) : launch_q<DP, T, false>(a);
  if (keys == TA)
    return a.exact ? launch_q<DP, TA, true>(a) : launch_q<DP, TA, false>(a);
  return (int)cudaErrorInvalidValue;
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dq, void* dk,
              void* dv, float* D, int B, int H, int K, int S, int dh,
              int causal, int window, float scale, int kv_rows, int q_keys,
              cudaStream_t s) {
  // copy widths: the base addresses and the byte length of a row
  const unsigned long long row_bytes = 2ULL * dh;
  TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
           lse, D, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
           static_cast<bf16*>(dv), B, H, K, S, dh, causal, window, scale,
           scale * LOG2E,
           mma::copy_width(reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(dout) | row_bytes),
           mma::copy_width(reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | row_bytes),
           false, s};
  a.exact = dh == DP && a.qvb == 16 && a.kvvb == 16;
  const long long rows = (long long)B * S * H;
  const long long dblocks = (rows + 31) / 32;
  if (dblocks > 0x7fffffffLL || (long long)S * (H / K) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int vec = dh % 8 == 0 &&
                  mma::copy_width(reinterpret_cast<uintptr_t>(o) |
                                  reinterpret_cast<uintptr_t>(dout)) == 16;
  dot_rows_bf16<<<(unsigned)dblocks, 256, 0, s>>>(
      static_cast<const bf16*>(o), a.dout, D, rows, S, H, dh, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rc = kv_pass<DP>(a, kv_rows);
  if (rc != 0) return rc;
  return q_pass<DP>(a, q_keys);
}

}  // namespace

// q, o, dout, dq (B, S, H, dh); k, v, dk, dv (B, S, K, dh): contiguous, one
// dtype (0 = float32: the FMA kernel; 1 = bfloat16: the tensor cores at the
// tiles of flash_attention_bwd.py::plan_bwd, kv_rows rows a Q tile of the kv
// pass and q_keys keys a K/V tile of the q pass, each one the padded dim is
// built at; the f32 kernel ignores them); lse (B, H, S) f32 from the
// forward; D a (B, H, S) f32 scratch.  S = T, dh in [1, 256].  Three
// launches on `stream`; returns the first launch error, else
// cudaGetLastError().
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* D,
    int B, int H, int K, int S, int dh, int dtype, int causal, int window,
    float scale, int kv_rows, int q_keys, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || dh < 1 || dh > 256 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* Df = static_cast<float*>(D);
  const int dp = dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
#define REPRO_FA_BWD(DP)                                                     \
  if (dp == DP)                                                              \
    return dtype == 0                                                        \
               ? launch_fma<DP>(q, k, v, o, dout, lf, dq, dk, dv, Df, \
                                       B, H, K, S, dh, causal, window,       \
                                       scale, s)                             \
               : launch_tc<DP>(q, k, v, o, dout, lf, dq, dk, dv, Df, B, H,   \
                               K, S, dh, causal, window, scale, kv_rows,     \
                               q_keys, s)
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  REPRO_FA_BWD(32);
  REPRO_FA_BWD(64);
  REPRO_FA_BWD(128);
  REPRO_FA_BWD(256);
#undef REPRO_FA_BWD
  return (int)cudaErrorInvalidValue;
}
