// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan on Hopper.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel behind
// ops.ssd_scan), which runs in every SSD block of a Mamba-2 forward and
// cold-start E (src/repro/models/ssm.py:98).
//
// Per (batch, head) the recurrence is h_t = exp(dt_t A) h_{t-1} +
// dt_t x_t B_t^T, y_t = h_t C_t, with h (dp, N) in f32.  The chunked form
// computes, per chunk of L steps with cum_i = sum_{k<=i} dt_k A:
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i h_prev                          (intra + inter)
//   h    = exp(cum_L) h_prev + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T
//
// What bounds it on an H100: at the path's shape (x (1, 48, 128, 64) bf16,
// N 128) the bytes are 1.73 MB (0.52 us at 3.35 TB/s) and the operations of
// the sequential recurrence 5 S dp N a head, 3.76 us at the f32 rate; the
// chunked form does more (C B^T is L x L x N a chunk) but on the tensor
// cores that is far below either.  So latency and parallelism set the
// time: the first design ran one block per (batch, head), 48 blocks on 132
// SMs, every multiply-add reading both operands from shared memory, 0.24 ms.
//
// What the design does:
//  * More blocks: a block owns P columns of dp (a slice of the state, P x N)
//    of one (batch, head), so the path's shape runs 48 x 64 / P blocks (192
//    at P = 16).  Each block recomputes the chunk's masked, decayed C B^T,
//    which is cheap on the tensor cores; y's columns and the state's rows
//    split cleanly over the slices.
//  * bf16 x: the three products run as mma.sync m16n8k16 (bf16 in, f32
//    accumulate): C B^T (L x L over N), the intra-chunk (C B^T o L)(dt x),
//    and the state update (w dt x)^T B.  B and C are rounded to bf16 as they
//    are staged, dt x likewise; the masked, decayed C B^T is rounded to bf16
//    in registers and fed straight back as the A operand of the intra
//    product, as flash attention feeds P.  y, which is written in bf16,
//    needs no more.  The state h stays f32 in registers across chunks, in
//    the accumulator layout of its update, and the products that feed it
//    keep about 16 bits: w dt x (w_j = exp(cum_L - cum_j)) and B go in as
//    two bf16 halves (hi = bf16(v), lo = bf16(v - hi)) and the update adds
//    hi.hi + lo.hi + hi.lo, and the inter term C h^T takes h as two halves
//    the same way.  With single bf16 operands the final state drifted 2.5e-3
//    to 3.9e-3 of max |h| from the f32 recurrence at phase 3's shapes (a CPU
//    emulation of this design), beyond phase 3's 1e-3; with the halves,
//    under 1e-5.
//  * A warp owns 16 rows i of a chunk: L / 16 warps a block.  It skips the
//    key tiles above the diagonal, applies the i >= j mask before exp
//    (above it cum_i - cum_j > 0 could overflow), and updates its own 128 /
//    (L / 16) columns of the state.
//  * The in-chunk cumulative sum of dt A is a warp scan (L / 32 steps a lane,
//    then a shuffle scan), no longer a serial loop on one thread.
//  * f32 x keeps f32 arithmetic on the CUDA cores with the same grid and
//    chunks (TF32 would not hold phase 3's 1e-4 limit): C B^T as 4 x 4
//    register tiles of the lower triangle, y and the state update as rows of
//    8 and 16 outputs a thread.
//
// What it keeps: the state starts from h0 (b, nh, dp, N) f32 when given and
// the final state is written to hS, so the same kernel serves a prefill
// that continues a cache; a ragged last chunk is zero-filled (dt = 0, x =
// 0, B = C = 0), which leaves the state as it was; chunks start at multiples
// of L from the call's first step, L fixed by ssd_scan.py::plan from (dp, N)
// alone, and a block reads only its own (batch, head), so a row's bits are
// the same at any batch size and trailing dt = 0 padding (ops.ssd_scan pads
// S to its chunk) leaves the valid steps' bits as they were.  The grid comes
// from the shapes (no host read of the data), so the call can be captured
// in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int MAX_SMEM = 232448;     // bytes of shared memory a block can use
constexpr int NMAX = 128;            // state width N the bf16 design takes

// Inclusive cumulative sum of dts[j] * a over the chunk, by warp 0: lane l
// sums its L / 32 consecutive steps, a shuffle scan adds the lanes before
// it.  The order of every addition is fixed by L.
template <int L>
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* cum, int lane) {
  constexpr int E = L / 32;
  static_assert(E >= 1 && L % 32 == 0, "chunk length");
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += dts[lane * E + e] * a;
    v[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  float before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) cum[lane * E + e] = before + v[e];
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores
// ---------------------------------------------------------------------------

// v0, v1 as bf16 hi halves at hi and the rounding left, as bf16, at lo
__device__ __forceinline__ void split_store(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, float v0,
                                            float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = mma::pack_bf16(
      v0 - __bfloat162float(h.x), v1 - __bfloat162float(h.y));
}

// One configuration: chunk length L (L / 16 warps, 16 rows each) and P dp
// columns a block.
template <int L, int P>
struct Tc {
  static constexpr int W = L / 16;
  static constexpr int THREADS = 32 * W;
  static constexpr int NPITCH = NMAX + 8;    // bf16 row of B, C, h (+16 B)
  static constexpr int PPITCH = P + 8;       // bf16 row of dt x, w dt x
  static constexpr int NT = NMAX / 8 / W;    // state n-tiles a warp owns
  static constexpr int MT = P / 16;          // state m-tiles (16 p rows)
  static constexpr int PT = P / 8;           // y n-tiles (8 p columns)
  static_assert(L % 32 == 0 && L <= 128 && P % 16 == 0 && NT % 2 == 0,
                "tile shape");
  // B hi and lo, C (L x NPITCH), h hi and lo (P x NPITCH), dt x, w dt x hi
  // and lo (L x PPITCH), all bf16; then dt, cum (L) f32
  static constexpr int B_OFF = 0;
  static constexpr int BLO_OFF = B_OFF + L * NPITCH * 2;
  static constexpr int C_OFF = BLO_OFF + L * NPITCH * 2;
  static constexpr int HHI_OFF = C_OFF + L * NPITCH * 2;
  static constexpr int HLO_OFF = HHI_OFF + P * NPITCH * 2;
  static constexpr int XS_OFF = HLO_OFF + P * NPITCH * 2;
  static constexpr int XW_OFF = XS_OFF + L * PPITCH * 2;
  static constexpr int XWLO_OFF = XW_OFF + L * PPITCH * 2;
  static constexpr int DT_OFF = XWLO_OFF + L * PPITCH * 2;
  static constexpr int CUM_OFF = DT_OFF + L * 4;
  static constexpr int SMEM = CUM_OFF + L * 4;
};

template <int L, int P>
__global__ void __launch_bounds__(Tc<L, P>::THREADS)
ssd_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
              float* __restrict__ hS, int nh, int S, int dp, int N) {
  using C = Tc<L, P>;
  constexpr int NPITCH = C::NPITCH;
  constexpr int PPITCH = C::PPITCH;
  constexpr int NT = C::NT;
  constexpr int MT = C::MT;
  constexpr int PT = C::PT;
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  __nv_bfloat16* Bs =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::B_OFF);
  __nv_bfloat16* Blo =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::BLO_OFF);
  __nv_bfloat16* Cs =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::C_OFF);
  __nv_bfloat16* Hhi =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::HHI_OFF);
  __nv_bfloat16* Hlo =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::HLO_OFF);
  __nv_bfloat16* Xs =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::XS_OFF);
  __nv_bfloat16* Xw =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::XW_OFF);
  __nv_bfloat16* Xwlo =
      reinterpret_cast<__nv_bfloat16*>(ssd_smem + C::XWLO_OFF);
  float* dts = reinterpret_cast<float*>(ssd_smem + C::DT_OFF);
  float* cum = reinterpret_cast<float*>(ssd_smem + C::CUM_OFF);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lj = lane >> 3;                  // ldmatrix: matrix lane / 8
  const int lr = lane & 7;                   // and its row lane % 8
  const int p0 = blockIdx.x * P;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * nh + h;
  const float a_h = A[h];
  const __nv_bfloat16* xr = x + bh * S * dp;
  const float* dtr = dt + bh * S;
  const float* br = Bm + (long long)b * S * N;
  const float* cr = Cm + (long long)b * S * N;
  __nv_bfloat16* yr = y + bh * S * dp;
  const bool nvec = (N & 3) == 0 &&          // float4 rows of B and C
                    ((reinterpret_cast<uintptr_t>(Bm) |
                      reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;

  // the state slice, f32, in the accumulator layout of its update: hreg[m]
  // [nt][e] is row p = 16 m + g (+ 8 for e >= 2), column n = 8 (warp NT +
  // nt) + 2 t + (e & 1)
  float hreg[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * m + g + (e >= 2 ? 8 : 0);
        const int n = 8 * (warp * NT + nt) + 2 * t + (e & 1);
        hreg[m][nt][e] = h0 != nullptr && p < dp && n < N
                             ? h0[(bh * dp + p) * N + n]
                             : 0.f;
      }

  for (int t0 = 0; t0 < S; t0 += L) {
    const int nv = min(L, S - t0);           // valid steps of the chunk
    __syncthreads();                         // the previous chunk consumed
    // B (hi and lo halves) and C rows as bf16, zero past nv and past N
    for (int idx = tid; idx < L * (NMAX / 4); idx += C::THREADS) {
      const int j = idx / (NMAX / 4);
      const int c = (idx % (NMAX / 4)) * 4;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 cv = bv;
      if (j < nv && c < N) {
        const long long o = (long long)(t0 + j) * N + c;
        if (nvec) {
          bv = *reinterpret_cast<const float4*>(br + o);
          cv = *reinterpret_cast<const float4*>(cr + o);
        } else {
          float* bp = &bv.x;
          float* cp = &cv.x;
          for (int e = 0; e < 4 && c + e < N; ++e) {
            bp[e] = br[o + e];
            cp[e] = cr[o + e];
          }
        }
      }
      split_store(Bs + j * NPITCH + c, Blo + j * NPITCH + c, bv.x, bv.y);
      split_store(Bs + j * NPITCH + c + 2, Blo + j * NPITCH + c + 2, bv.z,
                  bv.w);
      uint32_t* cd = reinterpret_cast<uint32_t*>(Cs + j * NPITCH + c);
      cd[0] = mma::pack_bf16(cv.x, cv.y);
      cd[1] = mma::pack_bf16(cv.z, cv.w);
    }
    if (tid < L) dts[tid] = tid < nv ? dtr[t0 + tid] : 0.f;
    // the state before this chunk, as bf16 hi and lo halves in (p, n) rows
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * m + g + 8 * r;
          const int n = 8 * (warp * NT + nt) + 2 * t;
          split_store(Hhi + p * NPITCH + n, Hlo + p * NPITCH + n,
                      hreg[m][nt][2 * r], hreg[m][nt][2 * r + 1]);
        }
    __syncthreads();
    if (warp == 0) chunk_cumsum<L>(dts, a_h, cum, lane);
    __syncthreads();
    const float cum_last = cum[L - 1];
    // dt x and w dt x of this block's columns
    for (int idx = tid; idx < L * P; idx += C::THREADS) {
      const int j = idx / P;
      const int p = idx % P;
      const float xv = j < nv && p0 + p < dp
                           ? __bfloat162float(xr[(long long)(t0 + j) * dp +
                                                 p0 + p])
                           : 0.f;
      const float v = dts[j] * xv;
      const float w = expf(cum_last - cum[j]) * v;
      const __nv_bfloat16 whi = __float2bfloat16_rn(w);
      Xs[j * PPITCH + p] = __float2bfloat16_rn(v);
      Xw[j * PPITCH + p] = whi;
      Xwlo[j * PPITCH + p] = __float2bfloat16_rn(w - __bfloat162float(whi));
    }
    __syncthreads();

    // ---- this warp's rows i0 .. i0 + 15 -----------------------------------
    const int i0 = 16 * warp;
    const int ia = i0 + g;
    const int ib = ia + 8;
    const float cum_a = cum[ia];
    const float cum_b = cum[ib];
    // C rows as A fragments (k = n), kept for the inter term
    uint32_t cf[NMAX / 16][4];
#pragma unroll
    for (int kk = 0; kk < NMAX / 16; ++kk)
      mma::ldmatrix_x4(cf[kk], Cs + (i0 + (lj & 1) * 8 + lr) * NPITCH +
                                   kk * 16 + (lj >> 1) * 8);
    // G = C B^T over the key tiles at or below the diagonal
    float gs[L / 8][4];
#pragma unroll
    for (int i = 0; i < L / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[i][e] = 0.f;
#pragma unroll
    for (int np = 0; np < L / 16; ++np) {
      if (np > warp) continue;
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk) {
        uint32_t kb[4];
        mma::ldmatrix_x4(kb, Bs + (np * 16 + (lj >> 1) * 8 + lr) * NPITCH +
                                 kk * 16 + (lj & 1) * 8);
        mma::mma_bf16(gs[2 * np], cf[kk], kb[0], kb[1]);
        mma::mma_bf16(gs[2 * np + 1], cf[kk], kb[2], kb[3]);
      }
    }
    // the i >= j mask, then the decay exp(cum_i - cum_j)
#pragma unroll
    for (int jt = 0; jt < L / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jt * 8 + 2 * t + (e & 1);
        const int i = e >= 2 ? ib : ia;
        const float ci = e >= 2 ? cum_b : cum_a;
        gs[jt][e] = j <= i ? gs[jt][e] * expf(ci - cum[j]) : 0.f;
      }
    // intra: G (bf16 in registers) . dt x
    float yi[PT][4];
    float ye[PT][4];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[i][e] = ye[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < L / 16; ++kc) {
      if (kc > warp) continue;
      const uint32_t ga[4] = {mma::pack_bf16(gs[2 * kc][0], gs[2 * kc][1]),
                              mma::pack_bf16(gs[2 * kc][2], gs[2 * kc][3]),
                              mma::pack_bf16(gs[2 * kc + 1][0],
                                             gs[2 * kc + 1][1]),
                              mma::pack_bf16(gs[2 * kc + 1][2],
                                             gs[2 * kc + 1][3])};
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        uint32_t vb[4];
        mma::ldmatrix_x4_trans(vb, Xs + (kc * 16 + (lj & 1) * 8 + lr) *
                                            PPITCH + pp * 16 + (lj >> 1) * 8);
        mma::mma_bf16(yi[2 * pp], ga, vb[0], vb[1]);
        mma::mma_bf16(yi[2 * pp + 1], ga, vb[2], vb[3]);
      }
    }
    // inter: C . (h_hi + h_lo)^T
#pragma unroll
    for (int kk = 0; kk < NMAX / 16; ++kk)
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        uint32_t hb[4];
        const int off =
            (pp * 16 + (lj >> 1) * 8 + lr) * NPITCH + kk * 16 + (lj & 1) * 8;
        mma::ldmatrix_x4(hb, Hhi + off);
        mma::mma_bf16(ye[2 * pp], cf[kk], hb[0], hb[1]);
        mma::mma_bf16(ye[2 * pp + 1], cf[kk], hb[2], hb[3]);
        mma::ldmatrix_x4(hb, Hlo + off);
        mma::mma_bf16(ye[2 * pp], cf[kk], hb[0], hb[1]);
        mma::mma_bf16(ye[2 * pp + 1], cf[kk], hb[2], hb[3]);
      }
    // y = intra + exp(cum_i) inter, rows below nv, columns below dp
    const float ea = expf(cum_a);
    const float eb = expf(cum_b);
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? ib : ia;
        const int p = p0 + pt * 8 + 2 * t;
        if (i >= nv || p >= dp) continue;
        const float ef = r ? eb : ea;
        const float v0 = yi[pt][2 * r] + ef * ye[pt][2 * r];
        const float v1 = yi[pt][2 * r + 1] + ef * ye[pt][2 * r + 1];
        __nv_bfloat16* o = yr + (long long)(t0 + i) * dp + p;
        if (p + 1 < dp && (dp & 1) == 0) {
          *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (p + 1 < dp) o[1] = __float2bfloat16_rn(v1);
        }
      }

    // ---- the state: h = exp(cum_L) h + (w dt x)^T B, this warp's columns,
    // as hi.hi + lo.hi + hi.lo
    const float total = expf(cum_last);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hreg[m][nt][e] *= total;
#pragma unroll
    for (int kc = 0; kc < L / 16; ++kc)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t xa[4], xl[4];
        const int xoff =
            (kc * 16 + (lj >> 1) * 8 + lr) * PPITCH + m * 16 + (lj & 1) * 8;
        mma::ldmatrix_x4_trans(xa, Xw + xoff);
        mma::ldmatrix_x4_trans(xl, Xwlo + xoff);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vb[4], vl[4];
          const int boff = (kc * 16 + (lj & 1) * 8 + lr) * NPITCH +
                           warp * NT * 8 + np * 16 + (lj >> 1) * 8;
          mma::ldmatrix_x4_trans(vb, Bs + boff);
          mma::ldmatrix_x4_trans(vl, Blo + boff);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float* acc = hreg[m][2 * np + q];
            mma::mma_bf16(acc, xa, vb[2 * q], vb[2 * q + 1]);
            mma::mma_bf16(acc, xl, vb[2 * q], vb[2 * q + 1]);
            mma::mma_bf16(acc, xa, vl[2 * q], vl[2 * q + 1]);
          }
        }
      }
  }

  if (hS != nullptr) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + 16 * m + g + (e >= 2 ? 8 : 0);
          const int n = 8 * (warp * NT + nt) + 2 * t + (e & 1);
          if (p < dp && n < N) hS[(bh * dp + p) * N + n] = hreg[m][nt][e];
        }
  }
}

// ---------------------------------------------------------------------------
// f32 x: the CUDA cores, the same grid and chunks
// ---------------------------------------------------------------------------

constexpr int F_L = 64;               // chunk length of the f32 design
constexpr int F_P = 16;               // dp columns a block
constexpr int F_THREADS = 128;

// floats of shared memory at state width N
__host__ __device__ __forceinline__ long long f32_smem_floats(int N) {
  return 2LL * F_L * (N + 1) + (long long)F_P * (N + 1) + F_L * F_P +
         F_L * (F_L + 1) + 4LL * F_L + 4;
}

__global__ void __launch_bounds__(F_THREADS)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hS, int nh, int S,
               int dp, int N) {
  constexpr int L = F_L;
  constexpr int P = F_P;
  extern __shared__ float fsm[];
  const int NP = N + 1;                      // padded rows of B, C and h
  float* bs = fsm;                           // (L, N + 1)
  float* cs = bs + L * NP;                   // (L, N + 1)
  float* hs = cs + L * NP;                   // (P, N + 1): the state slice
  float* xs = hs + P * NP;                   // (L, P): dt_j x_j
  float* gs = xs + L * P;                    // (L, L + 1)
  float* dts = gs + L * (L + 1);             // (L,)
  float* cum = dts + L;                      // (L,)
  float* ecum = cum + L;                     // (L,) exp(cum_i)
  float* wrem = ecum + L;                    // (L,) exp(cum_last - cum_j)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * nh + h;
  const float a_h = A[h];
  const float* xr = x + bh * S * dp;
  const float* dtr = dt + bh * S;
  const float* br = Bm + (long long)b * S * N;
  const float* cr = Cm + (long long)b * S * N;
  float* yr = y + bh * S * dp;

  for (int idx = tid; idx < P * N; idx += F_THREADS) {
    const int p = idx / N;
    const int c = idx % N;
    hs[p * NP + c] = h0 != nullptr && p0 + p < dp
                         ? h0[(bh * dp + p0 + p) * N + c]
                         : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += L) {
    const int nv = min(L, S - t0);
    __syncthreads();                         // the previous chunk consumed
    for (int idx = tid; idx < L * N; idx += F_THREADS) {
      const int j = idx / N;
      const int c = idx % N;
      const bool ok = j < nv;
      bs[j * NP + c] = ok ? br[(long long)(t0 + j) * N + c] : 0.f;
      cs[j * NP + c] = ok ? cr[(long long)(t0 + j) * N + c] : 0.f;
    }
    if (tid < L) dts[tid] = tid < nv ? dtr[t0 + tid] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum<L>(dts, a_h, cum, tid);
    __syncthreads();
    const float cum_last = cum[L - 1];
    if (tid < L) {
      ecum[tid] = expf(cum[tid]);
      wrem[tid] = expf(cum_last - cum[tid]);
    }
    for (int idx = tid; idx < L * P; idx += F_THREADS) {
      const int j = idx / P;
      const int p = idx % P;
      xs[idx] = j < nv && p0 + p < dp
                    ? dts[j] * xr[(long long)(t0 + j) * dp + p0 + p]
                    : 0.f;
    }
    // G = C B^T masked and decayed, 4 x 4 tiles at or below the diagonal
    constexpr int TL = L / 4;
    for (int tile = tid; tile < TL * (TL + 1) / 2; tile += F_THREADS) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
      const int tj = tile - ti * (ti + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      const float* ci = cs + 4 * ti * NP;
      const float* bj = bs + 4 * tj * NP;
      for (int c = 0; c < N; ++c) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = ci[u * NP + c];
          bv[u] = bj[u * NP + c];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += cv[u] * bv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = 4 * ti + u;
          const int j = 4 * tj + v;
          gs[i * (L + 1) + j] =
              j <= i ? acc[u][v] * expf(cum[i] - cum[j]) : 0.f;
        }
    }
    __syncthreads();
    // y rows, 8 columns a thread: intra + exp(cum_i) C_i h_prev
    for (int idx = tid; idx < L * (P / 8); idx += F_THREADS) {
      const int i = idx / (P / 8);
      const int pc = (idx % (P / 8)) * 8;
      float intra[8], inter[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) intra[v] = inter[v] = 0.f;
      const float* gi = gs + i * (L + 1);
      for (int j = 0; j <= i; ++j) {
        const float gv = gi[j];
#pragma unroll
        for (int v = 0; v < 8; ++v) intra[v] += gv * xs[j * P + pc + v];
      }
      const float* ci = cs + i * NP;
      for (int c = 0; c < N; ++c) {
        const float cv = ci[c];
#pragma unroll
        for (int v = 0; v < 8; ++v) inter[v] += cv * hs[(pc + v) * NP + c];
      }
      if (i < nv) {
#pragma unroll
        for (int v = 0; v < 8; ++v)
          if (p0 + pc + v < dp)
            yr[(long long)(t0 + i) * dp + p0 + pc + v] =
                intra[v] + ecum[i] * inter[v];
      }
    }
    __syncthreads();                         // h_prev read
    // h = exp(cum_last) h_prev + sum_j wrem_j dt_j x_j B_j^T, 16 columns a
    // thread
    const float tot = expf(cum_last);
    for (int idx = tid; idx < P * ((N + 15) / 16); idx += F_THREADS) {
      const int p = idx / ((N + 15) / 16);
      const int c0 = (idx % ((N + 15) / 16)) * 16;
      float s[16];
#pragma unroll
      for (int v = 0; v < 16; ++v) s[v] = 0.f;
      for (int j = 0; j < L; ++j) {
        const float wx = wrem[j] * xs[j * P + p];
        const float* bj = bs + j * NP + c0;
#pragma unroll
        for (int v = 0; v < 16; ++v)
          if (c0 + v < N) s[v] += wx * bj[v];
      }
#pragma unroll
      for (int v = 0; v < 16; ++v)
        if (c0 + v < N) {
          float* hv = hs + p * NP + c0 + v;
          *hv = tot * *hv + s[v];
        }
    }
  }
  __syncthreads();
  if (hS != nullptr)
    for (int idx = tid; idx < P * N; idx += F_THREADS) {
      const int p = idx / N;
      if (p0 + p < dp)
        hS[(bh * dp + p0 + p) * N + idx % N] = hs[p * NP + idx % N];
    }
}

template <int L, int P>
int launch_tc(const void* x, const float* dt, const float* A, const float* Bm,
              const float* Cm, const float* h0, void* y, float* hS, int b,
              int nh, int S, int dp, int N, cudaStream_t s) {
  using C = Tc<L, P>;
  static bool attr_set = false;             // idempotent, so a race is benign
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_kernel<L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((dp + P - 1) / P, nh, b);
  ssd_tc_kernel<L, P><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, Bm, Cm, h0,
      static_cast<__nv_bfloat16*>(y), hS, nh, S, dp, N);
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, const float* h0, void* y,
               float* hS, int b, int nh, int S, int dp, int N,
               cudaStream_t s) {
  const long long bytes = f32_smem_floats(N) * 4;
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((dp + F_P - 1) / F_P, nh, b);
  ssd_f32_kernel<<<grid, F_THREADS, bytes, s>>>(
      static_cast<const float*>(x), dt, A, Bm, Cm, h0,
      static_cast<float*>(y), hS, nh, S, dp, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (b, nh, S, dp) contiguous in one dtype (0 = float32, 1 = bfloat16);
// dt (b, nh, S), A (nh,), B and C (b, S, N) contiguous float32; h0 (b, nh,
// dp, N) float32 or null (start from 0); hS (b, nh, dp, N) float32 or null
// (the state after step S - 1).  chunk and cols are ssd_scan.py::plan's
// chunk length L and dp columns a block: bf16 takes (L, P) in {(64, 16),
// (64, 32), (64, 64), (32, 16), (128, 16)} and N <= 128; f32 takes (64, 16)
// and any N whose shared memory fits.  Returns cudaGetLastError().
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* hS, int b, int nh, int S, int dp,
                              int N, int dtype, int chunk, int cols,
                              void* stream) {
  if (b <= 0 || nh <= 0 || S <= 0 || dp <= 0 || N <= 0 || nh > 65535 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* h0f = static_cast<const float*>(h0);
  float* hSf = static_cast<float*>(hS);
  if (dtype == 0) {
    if (chunk != F_L || cols != F_P) return (int)cudaErrorInvalidValue;
    return launch_f32(x, dtf, Af, Bf, Cf, h0f, y, hSf, b, nh, S, dp, N, s);
  }
  if (dtype != 1 || N > NMAX) return (int)cudaErrorInvalidValue;
#define REPRO_SSD(LL, PP)                                                   \
  if (chunk == LL && cols == PP)                                            \
    return launch_tc<LL, PP>(x, dtf, Af, Bf, Cf, h0f, y, hSf, b, nh, S, dp, \
                             N, s)
  REPRO_SSD(64, 16);
  REPRO_SSD(64, 32);
  REPRO_SSD(64, 64);
  REPRO_SSD(32, 16);
  REPRO_SSD(128, 16);
#undef REPRO_SSD
  return (int)cudaErrorInvalidValue;
}
