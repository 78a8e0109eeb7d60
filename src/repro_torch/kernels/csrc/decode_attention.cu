// decode_attention: one-token attention over a slotted kv-major cache on
// Hopper, split over the cache.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (the
// slotted Pallas kernel), which runs in every decode step
// (src/repro/models/layers.py:174).
//
// What bounds it on an H100: at the path's shapes, latency.  A step reads
// the valid rows of the K and V caches once (2 * (pos + 1) * dh elements per
// kv head and row) and does only 4 * rep * dh operations per cache row,
// about 6 per byte in bf16, so bytes bound the work; but at 160 rows that is
// 0.2 MB, tens of nanoseconds of the card's bandwidth, and the time is set by
// how many dependent steps the slowest block takes and how many SMs share
// the rows: a block per (kv head, batch row) walking its whole cache would
// fill 5 of 132 SMs at smollm-360m and 1 at recurrentgemma-2b.
//
// What the design does:
//  * The TPU kernel's sequential cache axis becomes blocks that run in
//    parallel.  Pass 1 has one block per (split, kv head, batch row); a
//    split is split_len consecutive cache positions (logical positions for
//    the paged kernel), split_len fixed by decode_attention.py::plan from the
//    model's head geometry alone.  Row b's splits are [s L, (s+1) L) within
//    [0, n_keys(b)); a block whose split starts at or past n_keys exits
//    before it reads the table or the cache.  Each block writes per-head
//    partial statistics (running max m in the log2 domain, sum l) and the
//    unnormalised accumulator (rep, dh) in f32 to a scratch buffer.
//  * Pass 2 merges a row's splits in split order, in one pass (the running
//    max, and the sum and accumulator rescaled to it split by split), and
//    writes o in q's dtype.  It is a programmatic dependent launch: pass 1
//    lets it launch at once, and griddepcontrol.wait holds it until the
//    partials are complete.  No atomics; the order of every addition is
//    fixed by position, so a row's result is the same at any batch size,
//    any cache length (given the same valid rows) and through pages or
//    slots.
//  * bf16 runs on the tensor cores.  The rep query heads of the kv head are
//    the rows of an mma.sync m16n8k16 A operand (3 at smollm, 10 at
//    recurrentgemma; zero rows up to 16).  A block has min(4, L / 16) warps;
//    warp w takes the split's 16-key chunks w, w + W, ..., each staged with
//    16-byte cp.async copies in its own two buffers so the next chunk's copy
//    overlaps this chunk's products.  S = Q K^T and O += P V run as
//    mma.sync (ldmatrix, .trans for V) with an online softmax in the log2
//    domain; P is rounded to bf16 for P V as in flash_attention.cu, the sum
//    uses P in f32.  The warps' statistics are combined in warp order
//    through shared memory.
//  * f32 keeps an FMA design on the CUDA cores (TF32 would not hold the
//    card-vs-CPU checks): 128 threads walk the split in tiles of TK rows,
//    the K tile staged as f32 in shared memory (rows padded by one word),
//    scores a serial chain per (key, head), V streamed from global memory.
//    It splits, and merges, exactly as bf16 does.
//
// Validity follows the reference: slot j is valid if j <= pos, or, with a
// window, if the position it holds under the ring-buffer rule lies in
// (pos - window, pos] (decode_attention.py:70-72).  Rows past n_keys are
// zero-filled in shared memory and masked, so nothing past them is read.
//
// Any head dim up to 256, as the TPU kernels take: each body is instantiated
// at a padded head dim DP of 32, 64, 128 or 256 (the next at or above dh;
// flash_attention.py::padded_dim) and reads rows of the true dh.  Loads
// past dh are zero-filled in registers or shared memory, the f32 partials
// keep DP columns (zeros past dh), the merge stores only the dh real ones,
// and the scale is the caller's 1/sqrt(dh).  The caches stay as they are:
// nothing is padded per call.  bf16 rows that are not a multiple of 16
// bytes long are staged by 8-byte cp.async copies, element by element
// where not even a multiple of 8 (mma.cuh cp_chunk).
// A bf16 call at dh = DP with 16-byte aligned rows runs the EXACT
// instances, which have none of the masks: 64, 128 and 256 keep the code
// (and so the arithmetic and the speed) they had; so does f32 at those
// dims.
//
// decode_attention_paged (repro_decode_attention_paged) replaces
// src/repro/kernels/decode_attention.py::decode_attention_paged, which runs in
// every step of the paged scheduler (src/repro/models/layers.py:179-210).  It
// is the same device code over page pools (P, K, pt, dh) shared by the batch:
// logical cache row s of batch row b lives in physical page tables[b, s / pt],
// row s % pt.  A block reads its own table row (no scalar prefetch): the
// row offsets of its split are computed once, one table read and one
// division a row, into shared memory.  Splits sit at logical positions, so
// paged equals slotted over the same rows bit for bit; table entries past the
// row's pages (the scratch page) are never read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

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

// cache rows a row at pos may read: [0, n_keys)
__device__ __forceinline__ int n_keys_of(int pos, int S_ext, int window) {
  const int n = (window > 0 && pos >= window) ? S_ext : min(pos + 1, S_ext);
  return n < 0 ? 0 : n;
}

// Row addressing: the element offset / dh of logical cache row s.
// kStage: stage the split's row offsets in shared memory (worth it only
// where an offset costs a table read and a division).
struct SlotRows {          // slotted cache (B, K, S_max, dh)
  static constexpr bool kStage = false;
  long long base;          // (b * K + kvh) * S_max
  __device__ __forceinline__ long long operator()(int s) const {
    return base + s;
  }
};

struct PageRows {          // page pools (P, K, pt, dh) through a table row
  static constexpr bool kStage = true;
  const int* tbl;          // tables[b, :]
  int K, kvh, pt;
  __device__ __forceinline__ long long operator()(int s) const {
    return ((long long)__ldg(tbl + s / pt) * K + kvh) * pt + s % pt;
  }
};

// The scratch of partials: acc (B, K, NS, rep, DH) at part, then (m, l)
// pairs (B, K, NS, rep, 2) at part + acc_total.  blk = (b K + kvh) NS + s.
struct Partials {
  float* part;
  long long acc_total;
  __device__ __forceinline__ float* acc(long long blk, int rep, int r,
                                        int DH) const {
    return part + (blk * rep + r) * DH;
  }
  __device__ __forceinline__ float* ml(long long blk, int rep, int r) const {
    return part + acc_total + (blk * rep + r) * 2;
  }
};

// ---------------------------------------------------------------------------
// Pass 1, FMA on the CUDA cores (f32)
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// Per head dim: cache rows per tile and query heads per kv head (the
// shared memory stays within the 48 KB a block holds statically).
template <int DH>
struct Tile {
  static constexpr int TK = DH <= 128 ? 64 : 32;
  static constexpr int MAX_REP = DH <= 128 ? 16 : 12;
};

// One (split, kv head, batch row) block over rows [t_begin, t_end).
template <typename T, int DH, bool EXACT, typename Rows>
__device__ __forceinline__ void
fma_split(const T* __restrict__ q, const T* __restrict__ kc,
          const T* __restrict__ vc, int pos, const Partials pt_, int H,
          int K, int window, float scale_log2, int t_begin, int t_end,
          long long blk, const Rows rows, int dh) {
  constexpr int TK = Tile<DH>::TK;
  constexpr int MAX_REP = Tile<DH>::MAX_REP;
  constexpr int NG = THREADS / TK;          // head groups in the score phase
  constexpr bool WIDE = DH > THREADS;       // P @ V: dims per thread > 1
  constexpr int G = WIDE ? 1 : THREADS / DH;  // head groups in the PV phase
  constexpr int ACC = MAX_REP / G;
  constexpr int DPT = WIDE ? DH / THREADS : 1;
  __shared__ float qs[MAX_REP][DH];
  __shared__ float ks[TK][DH + 1];
  __shared__ float ps[MAX_REP][TK];
  __shared__ float m_s[MAX_REP];
  __shared__ float l_s[MAX_REP];
  __shared__ float alpha_s[MAX_REP];
  __shared__ long long roff[TK];      // the tile's row offsets / DH

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / K;
  const int dhr = EXACT ? DH : dh;          // the row length
  const long long q_base = ((long long)b * H + (long long)kvh * rep) * dhr;

  for (int idx = tid; idx < rep * DH; idx += THREADS) {
    const int r = idx / DH;
    const int e = idx % DH;
    qs[r][e] = EXACT || e < dh
                   ? to_f32(q[q_base + r * dhr + e]) * scale_log2
                   : 0.f;
  }
  if (tid < rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int d = tid % DH;
  const int g = tid / DH;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  float wacc[DPT][WIDE ? MAX_REP : 1];      // the wide P @ V's accumulator
  if constexpr (WIDE) {
#pragma unroll
    for (int k = 0; k < DPT; ++k)
#pragma unroll
      for (int i = 0; i < MAX_REP; ++i) wacc[k][i] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += TK) {
    __syncthreads();                       // previous tile consumed
    if constexpr (Rows::kStage) {
      if (tid < TK) roff[tid] = t0 + tid < t_end ? rows(t0 + tid) : 0;
      __syncthreads();
    }
    for (int idx = tid; idx < TK * DH; idx += THREADS) {
      const int j = idx / DH;
      const int e = idx % DH;
      const long long r = Rows::kStage ? roff[j] : rows(t0 + j);
      ks[j][e] = t0 + j < t_end && (EXACT || e < dh)
                     ? to_f32(kc[r * dhr + e])
                     : 0.f;
    }
    __syncthreads();

    // scores (log2 domain): thread (j, group) for heads group, group + NG,..
    {
      const int j = tid % TK;
      const int kp = t0 + j;
      const bool ok = kp < t_end && slot_valid(kp, pos, window);
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
        const float s1 = TK > 32 ? ps[r][lane + TK / 2] : -INFINITY;
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float p0 = 0.f, p1 = 0.f, alpha = 1.f;
        if (m_new != -INFINITY) {
          p0 = exp2f(s0 - m_new);
          p1 = exp2f(s1 - m_new);
          alpha = exp2f(m_old - m_new);
        }
        ps[r][lane] = p0;
        if constexpr (TK > 32) ps[r][lane + TK / 2] = p1;
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

    const int n = min(TK, t_end - t0);
    if constexpr (WIDE) {
      // P @ V, wide: thread t for dims t, t + THREADS, ... of every head
#pragma unroll
      for (int i = 0; i < MAX_REP; ++i) {
        if (i < rep) {
#pragma unroll
          for (int k = 0; k < DPT; ++k) wacc[k][i] *= alpha_s[i];
        }
      }
      for (int j = 0; j < n; ++j) {
        const long long r = Rows::kStage ? roff[j] : rows(t0 + j);
        float vv[DPT];
#pragma unroll
        for (int k = 0; k < DPT; ++k)
          vv[k] = EXACT || tid + k * THREADS < dh
                      ? to_f32(vc[r * dhr + tid + k * THREADS])
                      : 0.f;
#pragma unroll
        for (int i = 0; i < MAX_REP; ++i) {
          if (i < rep) {
#pragma unroll
            for (int k = 0; k < DPT; ++k) wacc[k][i] += ps[i][j] * vv[k];
          }
        }
      }
    } else if (g < G) {
      // P @ V: thread (d, group) for heads group, group + G, ...
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int r = g + G * i;
        if (r < rep) acc[i] *= alpha_s[r];
      }
      for (int j = 0; j < n; ++j) {
        const long long r = Rows::kStage ? roff[j] : rows(t0 + j);
        const float vv = EXACT || d < dh ? to_f32(vc[r * dhr + d]) : 0.f;
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const int r = g + G * i;
          if (r < rep) acc[i] += ps[r][j] * vv;
        }
      }
    }
  }
  __syncthreads();
  // the split's partials: unnormalised accumulator, max and sum
  if constexpr (WIDE) {
#pragma unroll
    for (int i = 0; i < MAX_REP; ++i) {
      if (i < rep) {
#pragma unroll
        for (int k = 0; k < DPT; ++k)
          pt_.acc(blk, rep, i, DH)[tid + k * THREADS] = wacc[k][i];
      }
    }
  } else if (g < G) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = g + G * i;
      if (r < rep) pt_.acc(blk, rep, r, DH)[d] = acc[i];
    }
  }
  if (tid < rep) {
    float* ml = pt_.ml(blk, rep, tid);
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// ---------------------------------------------------------------------------
// Pass 1, bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int CHUNK = 16;            // keys per warp step (the mma's k)
constexpr int TC_MAX_WARPS = 4;
constexpr int MAX_SPLIT = 256;       // split_len the kernels take

// Per head dim: the padded bf16 row (8 more, so ldmatrix's 8 row addresses
// fall in distinct banks), the padded f32 row of the warps' combine, and
// whether a warp keeps its q fragments in registers (dh 256 reloads them
// from shared memory: its 16 x 256 f32 accumulator takes 128 registers).
template <int DH>
struct Tc {
  static constexpr int PITCH = DH + 8;
  static constexpr int CPITCH = DH + 8;
  static constexpr int CH = DH / 8;         // 16-byte chunks per row
  static constexpr bool QREG = DH <= 128;
  // q tile, the split's row offsets, then per warp two buffers of K and V
  // chunks; the warps' combine reuses the buffers
  static constexpr int Q_BYTES = CHUNK * PITCH * 2;
  static constexpr int ROFF_BYTES = MAX_SPLIT * 8;
  static constexpr int STAGE_BYTES = 2 * 2 * CHUNK * PITCH * 2;   // a warp
  static constexpr int COMB_BYTES = CHUNK * CPITCH * 4 + 2 * CHUNK * 4;
  static constexpr int WARP_BYTES =
      STAGE_BYTES > COMB_BYTES ? STAGE_BYTES : COMB_BYTES;
  static constexpr int smem(int warps) {
    return Q_BYTES + ROFF_BYTES + warps * WARP_BYTES;
  }
};

template <int DH, bool EXACT, typename Rows>
__device__ __forceinline__ void
tc_split(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ kc,
         const __nv_bfloat16* __restrict__ vc, int pos, const Partials pt_,
         int H, int K, int window, float scale_log2, int t_begin, int t_end,
         long long blk, const Rows rows, int vb, int dh) {
  using C = Tc<DH>;
  constexpr int PITCH = C::PITCH;
  constexpr int CPITCH = C::CPITCH;
  constexpr int CH = C::CH;
  constexpr bool QREG = C::QREG;
  constexpr int DT = DH / 8;                // d n-tiles of O
  extern __shared__ __align__(16) unsigned char dsmem[];

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int W = nthr >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / K;

  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(dsmem);
  long long* roff = reinterpret_cast<long long*>(dsmem + C::Q_BYTES);
  unsigned char* wbase = dsmem + C::Q_BYTES + C::ROFF_BYTES;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(
      wbase + warp * C::WARP_BYTES);        // [2][CHUNK][PITCH]
  __nv_bfloat16* Vs = Ks + 2 * CHUNK * PITCH;

  // chunk ch (8 columns) of a row, zero past dh or for a row not there
  const int dhr = EXACT ? DH : dh;          // the row length
  auto copy16 = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int ch,
                    bool ok) {
    mma::cp_chunk<EXACT>(dst, src, ok, dh - ch * 8, vb, q);
  };

  // q rows: head kvh * rep + r for r < rep, zero rows up to 16
  const long long q_base = ((long long)b * H + (long long)kvh * rep) * dhr;
  for (int c = tid; c < CHUNK * CH; c += nthr) {
    const int r = c / CH;
    copy16(Qs + r * PITCH + (c % CH) * 8, q + q_base + (long long)r * dhr +
           (c % CH) * 8, c % CH, r < rep);
  }
  mma::cp_commit();
  if constexpr (Rows::kStage) {
    for (int i = tid; i < t_end - t_begin; i += nthr)
      roff[i] = rows(t_begin + i);
    __syncthreads();
  }

  // this warp's chunks: c = warp, warp + W, ... of the split
  const int n_chunks = (t_end - t_begin + CHUNK - 1) / CHUNK;
  const int mine = n_chunks > warp ? (n_chunks - warp + W - 1) / W : 0;
  auto load_chunk = [&](int j) {
    if (j < mine) {
      const int c0 = (warp + j * W) * CHUNK;       // offset in the split
      __nv_bfloat16* kd = Ks + (j & 1) * CHUNK * PITCH;
      __nv_bfloat16* vd = Vs + (j & 1) * CHUNK * PITCH;
      for (int c = lane; c < CHUNK * CH; c += 32) {
        const int row = c / CH;
        const int ch = c % CH;
        const bool ok = t_begin + c0 + row < t_end;
        long long r = 0;
        if (ok)
          r = Rows::kStage ? roff[c0 + row] : rows(t_begin + c0 + row);
        copy16(kd + row * PITCH + ch * 8, kc + r * dhr + ch * 8, ch, ok);
        copy16(vd + row * PITCH + ch * 8, vc + r * dhr + ch * 8, ch, ok);
      }
    }
    mma::cp_commit();                       // empty groups keep the count
  };
  load_chunk(0);
  load_chunk(1);
  mma::cp_wait<1>();                        // q and chunk 0
  __syncthreads();                          // q written by every thread

  // ldmatrix lane roles: matrix j = lane / 8, row lane % 8 of it
  const int lj = lane >> 3;
  const int lr = lane & 7;
  const __nv_bfloat16* q_lane =
      Qs + ((lj & 1) * 8 + lr) * PITCH + (lj >> 1) * 8;
  uint32_t qf[QREG ? DH / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      mma::ldmatrix_x4(qf[kk], q_lane + kk * 16);
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;   // rows g, g + 8 (log2 domain)
  float l_a = 0.f, l_b = 0.f;               // this thread's part of the sum

  for (int j = 0; j < mine; ++j) {
    if (j > 0) mma::cp_wait<1>();           // chunk j (j + 1 may be pending)
    __syncwarp();
    const int k0 = t_begin + (warp + j * W) * CHUNK;
    const __nv_bfloat16* kt = Ks + (j & 1) * CHUNK * PITCH;
    const __nv_bfloat16* vt = Vs + (j & 1) * CHUNK * PITCH;
    // S = Q K^T, 16 x 16 in f32
    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        mma::ldmatrix_x4(qa, q_lane + kk * 16);
      }
      uint32_t kb[4];
      mma::ldmatrix_x4(kb, kt + ((lj >> 1) * 8 + lr) * PITCH + kk * 16 +
                               (lj & 1) * 8);
      mma::mma_bf16(sc[0], qa, kb[0], kb[1]);
      mma::mma_bf16(sc[1], qa, kb[2], kb[3]);
    }
    // scale into the log2 domain, mask, row max over the quad
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + i * 8 + 2 * t + (e & 1);
        const bool ok = kp < t_end && slot_valid(kp, pos, window);
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
    float p[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[i][e] = exp2f(sc[i][e] - (e >= 2 ? base_b : base_a));
        if (e >= 2) l_b += p[i][e];
        else l_a += p[i][e];
      }
    const uint32_t pa[4] = {mma::pack_bf16(p[0][0], p[0][1]),
                            mma::pack_bf16(p[0][2], p[0][3]),
                            mma::pack_bf16(p[1][0], p[1][1]),
                            mma::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t vb[4];
      mma::ldmatrix_x4_trans(vb, vt + ((lj & 1) * 8 + lr) * PITCH + dp * 16 +
                                     (lj >> 1) * 8);
      mma::mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
      mma::mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();                           // buffer j & 1 consumed
    load_chunk(j + 2);
  }
  mma::cp_wait<0>();

  // the row sums over the quad; then the warps' statistics, combined in
  // warp order through shared memory (the stage buffers, now free)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  __syncthreads();
  float* cacc = reinterpret_cast<float*>(wbase + warp * C::WARP_BYTES);
  float* cm = cacc + CHUNK * CPITCH;
  float* cl = cm + CHUNK;
  if (g < rep) {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<float2*>(cacc + g * CPITCH + i * 8 + 2 * t) =
          make_float2(acc[i][0], acc[i][1]);
    if (t == 0) {
      cm[g] = m_a;
      cl[g] = l_a;
    }
  }
  if (g + 8 < rep) {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<float2*>(cacc + (g + 8) * CPITCH + i * 8 + 2 * t) =
          make_float2(acc[i][2], acc[i][3]);
    if (t == 0) {
      cm[g + 8] = m_b;
      cl[g + 8] = l_b;
    }
  }
  __syncthreads();
  auto wacc = [&](int w) {
    return reinterpret_cast<const float*>(wbase + w * C::WARP_BYTES);
  };
  for (int i = tid; i < rep * (DH / 4); i += nthr) {
    const int r = i / (DH / 4);
    const int d = (i % (DH / 4)) * 4;
    float mx = -INFINITY;
    for (int w = 0; w < W; ++w)
      mx = fmaxf(mx, wacc(w)[CHUNK * CPITCH + r]);
    const float base = mx == -INFINITY ? 0.f : mx;
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < W; ++w) {
      const float* cw = wacc(w);
      const float f = exp2f(cw[CHUNK * CPITCH + r] - base);
      l += cw[CHUNK * CPITCH + CHUNK + r] * f;
      const float4 x =
          *reinterpret_cast<const float4*>(cw + r * CPITCH + d);
      a.x += x.x * f;
      a.y += x.y * f;
      a.z += x.z * f;
      a.w += x.w * f;
    }
    *reinterpret_cast<float4*>(pt_.acc(blk, rep, r, DH) + d) = a;
    if (d == 0) {
      float* ml = pt_.ml(blk, rep, r);
      ml[0] = mx;
      ml[1] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// The kernels: pass 1 (slotted and paged share the bodies), pass 2
// ---------------------------------------------------------------------------

// Row addressing of one block (built after the early exit).
struct SlotArgs {
  int S_max;
  __device__ __forceinline__ SlotRows rows(int b, int K, int kvh) const {
    return SlotRows{((long long)b * K + kvh) * S_max};
  }
  __host__ __device__ int extent() const { return S_max; }
};

struct PageArgs {
  const int* tables;
  int NP, pt;
  __device__ __forceinline__ PageRows rows(int b, int K, int kvh) const {
    return PageRows{tables + (long long)b * NP, K, kvh, pt};
  }
  __host__ __device__ int extent() const { return NP * pt; }
};

// o for the rep heads of (b, kvh), from the row's ns splits merged in split
// order (the max first, then the rescaled sums added split by split); 0 for
// a head with no valid key.  Partials are read through L2 (__ldcg): other
// SMs wrote them.
template <typename T, int DH, bool EXACT>
__device__ __forceinline__ void
merge_rows(const float* __restrict__ part, long long acc_total,
           T* __restrict__ o, int b, int kvh, int H, int K, int ns, int NS,
           int dh) {
  const int rep = H / K;
  const long long blk0 = ((long long)b * K + kvh) * NS;
  const long long split_ml = 2LL * rep;     // ml stride from split to split
  const long long split_acc = (long long)rep * DH;
  for (int i = threadIdx.x; i < rep * (DH / 4); i += blockDim.x) {
    const int r = i / (DH / 4);
    const int d = (i % (DH / 4)) * 4;
    if (!EXACT && d >= dh) continue;        // padding columns: not stored
    const float* ml = part + acc_total + (blk0 * rep + r) * 2;
    const float* ap = part + (blk0 * rep + r) * DH + d;
    // one pass, split by split: the running max, and the sum and the
    // accumulator rescaled to it; unrolled so that the loads of several
    // splits are in flight at once
    float mx = -INFINITY;
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < ns; ++s) {
      const float ms = __ldcg(ml + s * split_ml);
      const float ls = __ldcg(ml + s * split_ml + 1);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(ap + s * split_acc));
      const float mn = fmaxf(mx, ms);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float fa = exp2f(mx - base);
      const float fb = exp2f(ms - base);
      l = l * fa + ls * fb;
      a.x = a.x * fa + x.x * fb;
      a.y = a.y * fa + x.y * fb;
      a.z = a.z * fa + x.z * fb;
      a.w = a.w * fa + x.w * fb;
      mx = mn;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* out = o + ((long long)b * H + (long long)kvh * rep + r) *
                     (EXACT ? DH : dh) + d;
    put(out, a.x * inv);
    if (EXACT || d + 1 < dh) put(out + 1, a.y * inv);
    if (EXACT || d + 2 < dh) put(out + 2, a.z * inv);
    if (EXACT || d + 3 < dh) put(out + 3, a.w * inv);
  }
}

// The body a dtype runs: bf16 on the tensor cores, f32 FMA.
template <typename T>
struct OnTc {
  static constexpr bool value = false;
};
template <>
struct OnTc<__nv_bfloat16> {
  static constexpr bool value = true;
};

// grid (NS, K, B): the splits' partials; merge_kernel merges them
template <typename T, int DH, bool EXACT, typename Args>
__global__ void __launch_bounds__(OnTc<T>::value ? 32 * TC_MAX_WARPS
                                                 : THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ pos_arr,
             float* __restrict__ part, long long acc_total, int H, int K,
             int window, float scale_log2, int L, const Args args, int vb,
             int dh) {
  // the merge may launch now; it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;");
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int pos = pos_arr[b];
  const int n_keys = n_keys_of(pos, args.extent(), window);
  const int t_begin = blockIdx.x * L;
  if (t_begin >= n_keys) return;            // before any table or cache read
  const int t_end = min(t_begin + L, n_keys);
  const long long blk = ((long long)b * K + kvh) * gridDim.x + blockIdx.x;
  const Partials pt_{part, acc_total};
  if constexpr (OnTc<T>::value)
    tc_split<DH, EXACT>(q, kc, vc, pos, pt_, H, K, window, scale_log2,
                        t_begin, t_end, blk, args.rows(b, K, kvh), vb, dh);
  else
    fma_split<T, DH, EXACT>(q, kc, vc, pos, pt_, H, K, window, scale_log2,
                            t_begin, t_end, blk, args.rows(b, K, kvh), dh);
}

// grid (K, B): the merge as a programmatic dependent of split_kernel
template <typename T, int DH, bool EXACT>
__global__ void __launch_bounds__(1024)
merge_kernel(const float* __restrict__ part, long long acc_total,
             const int* __restrict__ pos_arr, T* __restrict__ o, int H, int K,
             int S_ext, int window, int L, int NS, int dh) {
  const int ns = (n_keys_of(pos_arr[blockIdx.y], S_ext, window) + L - 1) / L;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  merge_rows<T, DH, EXACT>(part, acc_total, o, blockIdx.y, blockIdx.x, H, K,
                           ns, NS, dh);
}

template <typename T, int DH, bool EXACT, typename Args>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* o, void* part, int B, int H, int K, int dh, int window,
           float scale, int L, const Args& args, int vb, cudaStream_t s) {
  constexpr bool TC = OnTc<T>::value;
  const int S_ext = args.extent();
  const int NS = (S_ext + L - 1) / L;
  const int rep = H / K;
  const long long acc_total = (long long)B * K * NS * rep * DH;
  const float scale_log2 = scale * LOG2E;
  const int warps = L / CHUNK < TC_MAX_WARPS ? L / CHUNK : TC_MAX_WARPS;
  const int threads = TC ? 32 * warps : THREADS;
  const int smem = TC ? Tc<DH>::smem(warps) : 0;
  if constexpr (TC) {
    static bool opted_in = false;           // above 48 KB: opt in once
    if (!opted_in) {
      cudaError_t e = cudaFuncSetAttribute(
          split_kernel<T, DH, EXACT, Args>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          Tc<DH>::smem(TC_MAX_WARPS));
      if (e != cudaSuccess) return (int)e;
      opted_in = true;
    }
  }
  split_kernel<T, DH, EXACT, Args><<<dim3(NS, K, B), threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<float*>(part), acc_total, H, K, window, scale_log2, L, args,
      vb, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  const int items = rep * (DH / 4);
  cfg.gridDim = dim3(K, B);
  cfg.blockDim = dim3(items < 1024 ? (items + 31) / 32 * 32 : 1024);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, merge_kernel<T, DH, EXACT>, static_cast<const float*>(part),
      acc_total,
      static_cast<const int*>(pos), static_cast<T*>(o), H, K, S_ext, window,
      L, NS, dh);
}

template <typename Args>
int dispatch(const void* q, const void* kc, const void* vc, const void* pos,
             void* o, void* part, int B, int H, int K, int dh, int dtype,
             int window, float scale, int L, const Args& args,
             cudaStream_t s) {
  // the padded head dim of the instance (flash_attention.py::padded_dim)
  const int dp = dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
  if (B <= 0 || K <= 0 || H % K != 0 || args.extent() <= 0 || L <= 0 ||
      L % CHUNK != 0 || L > MAX_SPLIT || B > 65535 || K > 65535 ||
      dtype < 0 || dtype > 1 || dh < 1 || dh > 256 ||
      H / K > (dp <= 128 ? Tile<128>::MAX_REP : Tile<256>::MAX_REP))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  // copy width: the base addresses and the byte length of a row
  const int vb = mma::copy_width(
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kc) |
      reinterpret_cast<uintptr_t>(vc) |
      (unsigned long long)dh * (dtype == 0 ? 4 : 2));
  // the EXACT instances: the true dh is the instance's, and bf16 rows take
  // 16-byte copies (f32 loads element by element either way)
  const bool exact = dh == dp && (dtype == 0 || vb == 16);
#define REPRO_DA(DP)                                                        \
  if (dp == DP) {                                                           \
    if (dtype == 0)                                                         \
      return exact ? launch<float, DP, true>(q, kc, vc, pos, o, part, B, H, \
                                             K, dh, window, scale, L, args, \
                                             vb, s)                         \
                   : launch<float, DP, false>(q, kc, vc, pos, o, part, B,   \
                                              H, K, dh, window, scale, L,   \
                                              args, vb, s);                 \
    if (exact)                                                              \
      return launch<bf, DP, true>(q, kc, vc, pos, o, part, B, H, K, dh,     \
                                  window, scale, L, args, vb, s);           \
    return launch<bf, DP, false>(q, kc, vc, pos, o, part, B, H, K, dh,      \
                                 window, scale, L, args, vb, s);            \
  }
  REPRO_DA(32);
  REPRO_DA(64);
  REPRO_DA(128);
  REPRO_DA(256);
#undef REPRO_DA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, dh), caches (B, K, S_max, dh), o (B, H, dh), all contiguous, dh
// in [1, 256]; pos (B,) int32; part f32 scratch of B K NS rep (DP + 2)
// floats, DP the padded head dim and NS = ceil(S_max / split_len).  dtype: 0 = float32, 1 = bfloat16; split_len from
// decode_attention.py::plan (a multiple of 16, at most 256).  Two launches:
// the splits, then their merge.  Returns the first CUDA error.
extern "C" int repro_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* pos,
                                      void* o, void* part, int B, int H,
                                      int K, int S_max, int dh, int dtype,
                                      int window, float scale, int split_len,
                                      void* stream) {
  return dispatch(q, kc, vc, pos, o, part, B, H, K, dh, dtype, window, scale,
                  split_len, SlotArgs{S_max},
                  static_cast<cudaStream_t>(stream));
}

// q (B, H, dh), pools (P, K, pt, dh), o (B, H, dh), all contiguous; tables
// (B, NP) and pos (B,) int32, every table entry a page id in [0, P); part as
// above with S_max = NP pt.  Returns the first CUDA error.
extern "C" int repro_decode_attention_paged(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* pos, void* o, void* part, int B, int H, int K, int NP, int pt,
    int dh, int dtype, int window, float scale, int split_len, void* stream) {
  if (NP <= 0 || pt <= 0 || (long long)NP * pt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, kp, vp, pos, o, part, B, H, K, dh, dtype, window, scale,
                  split_len, PageArgs{static_cast<const int*>(tables), NP, pt},
                  static_cast<cudaStream_t>(stream));
}
