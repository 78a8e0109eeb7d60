// flash_attention: online-softmax attention for prefill on Hopper.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel behind ops.flash_attention), which runs every attention E of a cold
// start and every prefill (src/repro/models/layers.py:146).
//
// What it computes: softmax(q k^T / sqrt(dh)) v for q (B, S, H, dh) and k/v
// (B, T, K, dh), GQA by kv head h // rep, queries at the last S of T
// positions (q_offset = T - S), with the causal and window rules of
// flash_attention.py:60-69 from absolute positions; tiles wholly above the
// diagonal or outside the window are never visited, ragged S and T are
// masked in the kernel (the TPU kernel asserts S % bq == 0), and a row with
// no key left after masking gives 0.  q is read as (B, S, H, dh) and k/v as
// (B, T, K, dh) through strides, so no transpose is materialised
// (transformer.py passes transposed views of the kv-major cache).
//
// What bounds it on an H100: at the path's S = 128 a causal head is 2.1
// MFLOP at dh 64 and 8.5 at dh 256, and the bytes of q, k, v and o are
// under 1 MB, both far below a microsecond: occupancy and latency set the
// time.  At long S the 2 S^2 dh operations of a causal head come to count.
//
// bf16: FA2 on the tensor cores.
//  * Each warp owns 16 query rows.  S = q k^T and O += P v run as mma.sync
//    m16n8k16 (bf16 in, f32 accumulate).  The online-softmax max and sum
//    live on the accumulator fragments in registers (log2 domain, exp2);
//    P is rounded to bf16 in registers and reused as the A operand of P v,
//    with no trip through shared memory; the sum uses P in f32.
//  * K/V tiles stay bf16 in shared memory, loaded by cp.async 16 bytes a
//    thread into two buffers, so the next tile's copy overlaps this tile's
//    products; ldmatrix (.trans for v) feeds the fragments.  Rows are padded
//    by 16 bytes so ldmatrix's 8 row addresses fall in distinct banks.
//    Dynamic shared memory, above 48 KB at dh 128 and 256.
//  * GQA packing: a block's rows are (position, head) pairs of one kv head,
//    position-major, so the rep query heads of a kv head share each K/V
//    tile (rep 3 at smollm, 10 at recurrentgemma).
//  * flash_attention.py::plan gives a block 4 warps (64 rows), so each K/V
//    tile it stages serves 64 rows: on the card that beats blocks of 1 or
//    2 warps at every timed S, although at S = 128 it leaves most SMs idle
//    (30 blocks at smollm, 20 at recurrentgemma; PERF.md, `ab.py --sweep`).
//  * The causal and window masks are a per-row key range, [lo, hi], two
//    compares a score; a tile that every row of the warp sees whole skips
//    them.
//  * K tiles sit at absolute key positions (multiples of the fixed key tile,
//    64 keys at dh 64 and 128, 32 at dh 256 where the accumulator takes 128
//    registers and q is reloaded from shared memory).  A row's tiles, and
//    every addition in them, are then the same whatever S, its q tile or its
//    packing; a tile that masks all of a row changes nothing of it.  So
//    prefill_continue over a reused prefix equals a full prefill bit for bit.
//
// f32 keeps the first design (plain FMA, full f32; TF32 would not hold the
// card-vs-CPU checks): one block per (64-row query tile, head), TPR threads
// per query row (2 up to dh 128, 8 at dh 256), K/V staged as f32 in BK-row
// tiles.
//
// Any head dim up to 256, as the TPU kernel takes the whole dh as one block:
// each design is instantiated at a padded head dim DP of 32, 64, 128 or 256
// (the next at or above dh) and reads the true dh through the strides.
// Loads past dh are zero-filled in registers or shared memory (a zero q
// column adds exactly 0 to every score, a zero v column is never stored),
// stores past dh are masked, and the scale is the caller's 1/sqrt(dh).
// Nothing is copied or padded in device memory.  bf16 rows whose byte
// length is not a multiple of 16 (dh 20: 40 bytes) are staged by 8-byte
// cp.async copies, element by element where not even a multiple of 8
// (mma.cuh cp_chunk).  A call at dh = DP whose rows
// are 16-byte aligned runs the EXACT instance, which has none of the masks:
// 64, 128 and 256 keep the code (and so the arithmetic and the speed) they
// had.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores (the first design)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block

// Per head dim: threads per query row and keys per shared-memory tile (the
// f32 K and V tiles stay within 48 KB of static shared memory).
template <int DH>
struct Tile {
  static constexpr int TPR = DH <= 128 ? 2 : 8;
  static constexpr int BK = DH <= 128 ? 32 : 16;
  static constexpr int THREADS = BQ * TPR;
  static_assert(TPR == 2 || TPR == 8, "row split by shifts and shuffles");
};

__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  if (causal) {
    if (kpos > qpos) return false;
    return window <= 0 || kpos > qpos - window;
  }
  if (window > 0) return abs(kpos - qpos) < window;
  return true;
}

template <int DH>
__global__ void __launch_bounds__(Tile<DH>::THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H, int K,
             int S,
             int T_len, long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, int causal, int window,
             float scale, int dh) {
  constexpr int TPR = Tile<DH>::TPR;
  constexpr int BK = Tile<DH>::BK;
  constexpr int THREADS = Tile<DH>::THREADS;
  constexpr int DPT = DH / TPR;           // dims of the row per thread
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];

  const int tid = threadIdx.x;
  const int r = tid >> (TPR == 2 ? 1 : 3);
  const int sub = tid & (TPR - 1);
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int qi = qt * BQ + r;
  const bool row_ok = qi < S;
  const int q_off = T_len - S;
  const int qpos = q_off + qi;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    acc[i] = 0.f;
    qr[i] = row_ok && i * TPR + sub < dh
                ? q[b * qsb + (long long)qi * qss + h * qsh + i * TPR + sub] *
                      scale
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
      if (kp < T_len && d < dh) {
        kv = k[b * ksb + (long long)kp * kss + kvh * ksh + d];
        vv = v[b * vsb + (long long)kp * vss + kvh * vsh + d];
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
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][i * TPR + sub];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if constexpr (TPR == 8) {
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
      }
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
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += p * vs[j][i * TPR + sub];
      }
      m = m_new;
    }
  }

  if (row_ok) {
    float* orow = o + (((long long)b * S + qi) * H + h) * dh;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (i * TPR + sub < dh) orow[i * TPR + sub] = l > 0.f ? acc[i] / l : 0.f;
  }
}

template <int DH>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int S, int T_len, int dh, const long long* st,
               int causal, int window, float scale, cudaStream_t s) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<DH><<<grid, Tile<DH>::THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, K, S, T_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, scale, dh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: FA2 on the tensor cores
// ---------------------------------------------------------------------------

// Per head dim: keys per K/V tile (fixed, so tiles sit at absolute key
// positions), the padded shared-memory row (8 bf16 more, so ldmatrix's 8
// row addresses fall in distinct banks) and whether a warp keeps its q
// fragments in registers (dh 256 reloads them from shared memory: its 16 x
// 256 f32 accumulator already takes 128 registers a thread).
template <int DH>
struct Fa {
  static constexpr int BKV = DH <= 128 ? 64 : 32;
  static constexpr int PITCH = DH + 8;
  static constexpr bool QREG = DH <= 128;
  static constexpr int CH = DH / 8;         // 16-byte chunks per row
};

// the keys a query at position qpos may see, as an inclusive range [x, y]:
// allowed() and kpos < T, as two compares a key (empty for a row past S)
__device__ __forceinline__ int2 key_range(int qpos, bool ok, int causal,
                                          int window, int T_len) {
  int lo = 0, hi = T_len - 1;
  if (causal) {
    hi = min(hi, qpos);
    if (window > 0) lo = qpos - window + 1;
  } else if (window > 0) {
    lo = qpos - window + 1;
    hi = min(hi, qpos + window - 1);
  }
  return ok ? make_int2(lo, hi) : make_int2(1, 0);
}

constexpr int FA_MAX_WARPS = 4;

// A thread's columns 8 i + 2 t, 8 i + 2 t + 1 of one output row (acc
// elements e0, e0 + 1 of tile i) times inv, in bf16: one paired store where
// both lie below dh and the pair is aligned (dh even), else element-wise.
template <int DT, bool EXACT>
__device__ __forceinline__ void store_row(__nv_bfloat16* orow,
                                          const float (&acc)[DT][4], int e0,
                                          float inv, int t, int dh) {
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t;
    const float x0 = acc[i][e0] * inv;
    const float x1 = acc[i][e0 + 1] * inv;
    if (EXACT || (c + 1 < dh && (dh & 1) == 0)) {
      *reinterpret_cast<uint32_t*>(orow + c) = mma::pack_bf16(x0, x1);
    } else {
      if (c < dh) orow[c] = __float2bfloat16_rn(x0);
      if (c + 1 < dh) orow[c + 1] = __float2bfloat16_rn(x1);
    }
  }
}

template <int DH>
constexpr int fa_smem_bytes(int warps) {
  return (16 * warps + 4 * Fa<DH>::BKV) * Fa<DH>::PITCH * 2;
}

template <int DH, bool EXACT>
__global__ void __launch_bounds__(32 * FA_MAX_WARPS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int H, int K, int S, int T_len,
                long long qsb, long long qss, long long qsh, long long ksb,
                long long kss, long long ksh, long long vsb, long long vss,
                long long vsh, int causal, int window, float scale_log2,
                int qvb, int kvvb, int dh) {
  constexpr int BKV = Fa<DH>::BKV;
  constexpr int PITCH = Fa<DH>::PITCH;
  constexpr int CH = Fa<DH>::CH;
  constexpr bool QREG = Fa<DH>::QREG;
  constexpr int NT = BKV / 8;               // key n-tiles of S
  constexpr int DT = DH / 8;                // d n-tiles of O
  extern __shared__ __align__(16) unsigned char fa_smem[];

  const int nthr = blockDim.x;
  const int W = nthr >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rep = H / K;
  const int rows_total = S * rep;           // (position, head) rows
  const int row0 = blockIdx.x * 16 * W;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q_off = T_len - S;

  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + 16 * W * PITCH;  // [2][BKV][PITCH]
  __nv_bfloat16* Vs = Ks + 2 * BKV * PITCH;

  // q rows of the block: row r is position r / rep of head kvh*rep + r % rep
  for (int c = tid; c < 16 * W * CH; c += nthr) {
    const int row = c / CH;
    const int ch = c % CH;
    const int r = row0 + row;
    __nv_bfloat16* dst = Qs + row * PITCH + ch * 8;
    const bool ok = r < rows_total;
    const __nv_bfloat16* src =
        ok ? q + b * qsb + (long long)(r / rep) * qss +
                 (long long)(kvh * rep + r % rep) * qsh + ch * 8
           : q;
    mma::cp_chunk<EXACT>(dst, src, ok, dh - ch * 8, qvb, q);
  }
  mma::cp_commit();

  auto load_kv = [&](int buf, int t0) {
    for (int c = tid; c < BKV * CH; c += nthr) {
      const int row = c / CH;
      const int ch = c % CH;
      const int kp = t0 + row;
      const bool ok = kp < T_len;
      __nv_bfloat16* kd = Ks + (buf * BKV + row) * PITCH + ch * 8;
      __nv_bfloat16* vd = Vs + (buf * BKV + row) * PITCH + ch * 8;
      const __nv_bfloat16* ksrc =
          ok ? k + b * ksb + (long long)kp * kss + kvh * ksh + ch * 8 : k;
      const __nv_bfloat16* vsrc =
          ok ? v + b * vsb + (long long)kp * vss + kvh * vsh + ch * 8 : v;
      mma::cp_chunk<EXACT>(kd, ksrc, ok, dh - ch * 8, kvvb, k);
      mma::cp_chunk<EXACT>(vd, vsrc, ok, dh - ch * 8, kvvb, v);
    }
    mma::cp_commit();
  };

  // keys the block can see, [k_begin, k_end), from its first and last row
  const int r_last = min(rows_total, row0 + 16 * W) - 1;
  const int qpos_lo = q_off + row0 / rep;
  const int qpos_hi = q_off + r_last / rep;
  int k_begin = 0;
  int k_end = T_len;
  if (causal) {
    k_end = min(T_len, qpos_hi + 1);
    if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  } else if (window > 0) {
    k_begin = max(0, qpos_lo - window + 1);
    k_end = min(T_len, qpos_hi + window);
  }
  const int t_first = (k_begin / BKV) * BKV;          // absolute alignment
  const int ntiles = k_end > t_first ? (k_end - t_first + BKV - 1) / BKV : 0;

  // this warp's rows: a = g, b = g + 8 of its 16
  const int wr0 = row0 + 16 * warp;
  const bool warp_live = wr0 < rows_total;
  const int wr_last = min(rows_total, wr0 + 16) - 1;
  const int wpos_lo = q_off + wr0 / rep;
  const int wpos_hi = q_off + wr_last / rep;
  const int ra = wr0 + g;
  const int rb = ra + 8;
  const bool ok_a = ra < rows_total;
  const bool ok_b = rb < rows_total;
  // keys each of the thread's two rows may see: [lo, hi] (empty past S)
  const int2 rg_a = key_range(q_off + ra / rep, ok_a, causal, window, T_len);
  const int2 rg_b = key_range(q_off + rb / rep, ok_b, causal, window, T_len);

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;   // running max, log2 domain
  float l_a = 0.f, l_b = 0.f;               // this thread's part of the sum
  uint32_t qf[QREG ? DH / 16 : 1][4];

  // ldmatrix lane roles: matrix j = lane / 8, row lane % 8 of it
  const int lj = lane >> 3;
  const int lr = lane & 7;
  const __nv_bfloat16* q_lane = Qs + (16 * warp + (lj & 1) * 8 + lr) * PITCH +
                                (lj >> 1) * 8;

  if (ntiles > 0) load_kv(0, t_first);
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * BKV;
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_kv(buf ^ 1, t0 + BKV);
      mma::cp_wait<1>();
    } else {
      mma::cp_wait<0>();
    }
    __syncthreads();
    if (QREG && it == 0) {
#pragma unroll
      for (int kc = 0; kc < (QREG ? DH / 16 : 1); ++kc)
        mma::ldmatrix_x4(qf[kc], q_lane + kc * 16);
    }
    // skip a tile that masks every row of the warp (it would change nothing)
    bool live = warp_live;
    if (causal) {
      live = live && t0 <= wpos_hi;
      if (window > 0) live = live && t0 + BKV - 1 > wpos_lo - window;
    } else if (window > 0) {
      live = live && t0 + BKV - 1 > wpos_lo - window &&
             t0 < wpos_hi + window;
    }
    if (live) {
      const __nv_bfloat16* kt = Ks + buf * BKV * PITCH;
      const __nv_bfloat16* vt = Vs + buf * BKV * PITCH;
      // S = Q K^T, 16 x BKV in f32
      float sc[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t qa[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kc][e];
        } else {
          mma::ldmatrix_x4(qa, q_lane + kc * 16);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          mma::ldmatrix_x4(kb, kt + (np * 16 + (lj >> 1) * 8 + lr) * PITCH +
                                   kc * 16 + (lj & 1) * 8);
          mma::mma_bf16(sc[2 * np], qa, kb[0], kb[1]);
          mma::mma_bf16(sc[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // scale into the log2 domain, mask (only where the tile is not
      // wholly visible to every row of the warp), row max over the quad
      const bool whole = __all_sync(
          0xffffffffu, rg_a.x <= t0 && rg_a.y >= t0 + BKV - 1 &&
                           rg_b.x <= t0 && rg_b.y >= t0 + BKV - 1);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t0 + i * 8 + 2 * t + (e & 1);
          const int2 rg = e >= 2 ? rg_b : rg_a;
          const bool ok = whole || (kp >= rg.x && kp <= rg.y);
          const float x = ok ? sc[i][e] * scale_log2 : -INFINITY;
          sc[i][e] = x;
          if (e >= 2) mx_b = fmaxf(mx_b, x);
          else mx_a = fmaxf(mx_a, x);
        }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f(m_a - base_a);
      const float al_b = exp2f(m_b - base_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        acc[i][0] *= al_a;
        acc[i][1] *= al_a;
        acc[i][2] *= al_b;
        acc[i][3] *= al_b;
      }
      // P = exp2(S - max) in f32 for the sum, rounded to bf16 in registers
      // as the A operand of P V
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        float p[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[h2][e] = exp2f(sc[2 * kc + h2][e] - (e >= 2 ? base_b : base_a));
            if (e >= 2) l_b += p[h2][e];
            else l_a += p[h2][e];
          }
        const uint32_t pa[4] = {mma::pack_bf16(p[0][0], p[0][1]),
                                mma::pack_bf16(p[0][2], p[0][3]),
                                mma::pack_bf16(p[1][0], p[1][1]),
                                mma::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vb[4];
          mma::ldmatrix_x4_trans(
              vb, vt + (kc * 16 + (lj & 1) * 8 + lr) * PITCH + dp * 16 +
                      (lj >> 1) * 8);
          mma::mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
          mma::mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                        // buf consumed before reload
  }
  mma::cp_wait<0>();

  // the row sums over the quad, then O / l (0 for a row with no key)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const int dhr = EXACT ? DH : dh;          // the row stride of o
  if (ok_a)
    store_row<DT, EXACT>(o + (((long long)b * S + ra / rep) * H + kvh * rep +
                              ra % rep) * dhr,
                         acc, 0, inv_a, t, dh);
  if (ok_b)
    store_row<DT, EXACT>(o + (((long long)b * S + rb / rep) * H + kvh * rep +
                              rb % rep) * dhr,
                         acc, 2, inv_b, t, dh);
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per
// instance
template <int DH, bool EXACT>
cudaError_t opt_in() {
  static bool done = false;                 // idempotent: a race is benign
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<DH, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fa_smem_bytes<DH>(FA_MAX_WARPS));
  if (e == cudaSuccess) done = true;
  return e;
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int K, int S, int T_len, int dh, const long long* st,
              int causal, int window, float scale, int warps, int key_tile,
              cudaStream_t s) {
  if (key_tile != Fa<DH>::BKV || warps < 1 || warps > FA_MAX_WARPS ||
      (warps & (warps - 1)))
    return (int)cudaErrorInvalidValue;
  const int bytes = fa_smem_bytes<DH>(warps);
  // copy widths: the base addresses and the byte strides of the rows
  const int qvb = mma::copy_width(reinterpret_cast<uintptr_t>(q) |
                                  2ULL * (st[0] | st[1] | st[2]));
  const int kvvb = mma::copy_width(
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
      2ULL * (st[3] | st[4] | st[5] | st[6] | st[7] | st[8]));
  const long long rows = (long long)S * (H / K);
  const long long tiles = (rows + 16LL * warps - 1) / (16LL * warps);
  if (tiles > 0x7fffffffLL || K > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, K, B);
  const bool exact = dh == DH && qvb == 16 && kvvb == 16;
  auto kernel = exact ? flash_tc_kernel<DH, true> : flash_tc_kernel<DH, false>;
  const cudaError_t e = exact ? opt_in<DH, true>() : opt_in<DH, false>();
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 32 * warps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      K, S, T_len, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, scale * 1.4426950408889634f, qvb, kvvb, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, dh), k/v (B, T, K, dh) addressed through the element strides
// of their batch, sequence and head dims (the last dim is contiguous);
// o (B, S, H, dh) contiguous, dh in [1, 256].  dtype: 0 = float32 (FMA
// design), 1 = bfloat16 (tensor cores, with the plan of
// flash_attention.py::plan: warps per block and the key tile, which must be
// the padded head dim's).  Returns cudaGetLastError().
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H, int K,
    int S, int T_len, int dh, int dtype, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, float scale,
    int warps, int key_tile, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the padded head dim of the instance (flash_attention.py::padded_dim)
  const int dp = dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
  if (dh < 1 || dh > 256) return (int)cudaErrorInvalidValue;
#define REPRO_FA(DP)                                                        \
  if (dp == DP)                                                             \
    return dtype == 0 ? launch_fma<DP>(q, k, v, o, B, H, K, S, T_len, dh,   \
                                       st, causal, window, scale, s)        \
                      : launch_tc<DP>(q, k, v, o, B, H, K, S, T_len, dh, st, \
                                      causal, window, scale, warps,         \
                                      key_tile, s)
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  REPRO_FA(32);
  REPRO_FA(64);
  REPRO_FA(128);
  REPRO_FA(256);
#undef REPRO_FA
  return (int)cudaErrorInvalidValue;
}
