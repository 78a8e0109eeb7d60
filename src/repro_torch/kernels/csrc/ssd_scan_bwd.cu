// ssd_scan_bwd: the gradient of the Mamba-2 SSD scan on Hopper, for
// training.
//
// Replaces the gradient jax.grad takes of the reference's _xla_ssd
// (src/repro/kernels/ops.py:411), the jnp form of the Pallas ssd_scan
// (src/repro/kernels/ssd_scan.py:73) that the reference trains through.
//
// Per (batch, head) the forward is h_t = a_t h_{t-1} + dt_t x_t B_t^T, a_t =
// exp(dt_t A), y_t = h_t C_t, h (dp, N) f32.  With dy = dL/dy the reverse
// state is dh_t = dy_t C_t^T + a_{t+1} dh_{t+1}, and
//   dx_t  = dt_t dh_t B_t                       (dp)
//   dB_t  = dt_t dh_t^T x_t = dt_t z_t          (N; summed over heads)
//   dC_t  = h_t^T dy_t                          (N; summed over heads)
//   ddt_t = v_t + A a_t <h_{t-1}, dh_t>,  v_t = x_t^T dh_t B_t = B_t . z_t
//   dA    = sum over batch rows and t of dt_t a_t <h_{t-1}, dh_t>.
// A reverse walk has dh_t but not h_{t-1}.  Instead of keeping the states,
// both designs use the identity (h_k = (a_{t+1} .. a_k) h_t + the inputs
// after t, summed against dh_k):
//   <h_t, dh_t> = R_t - W_{t+1},  R_t = sum_{k>=t} r_k,  r_k = dy_k . y_k
//                                 W_t = sum_{k>=t} dt_k v_k,
// so a_t <h_{t-1}, dh_t> = <h_t - dt_t x_t B_t^T, dh_t> = R_t - W_t, and
// r_k = dy_k . (h_k C_k) = C_k . dC_k.  Both sums are f32 and taken in a
// fixed order.
//
// f32 x (the first design, kept as it was): one block a (batch, head), a
// thread a column n of the state (128 threads; dp <= DPT rows of h in its
// registers), so the sums over dp (dC_t, z_t) stay in the thread.  Pass 1
// walks forward from h0 and writes dC_t (per head) and r_t; pass 2 walks
// backward with dh in the same registers and writes dB_t (per head), dx_t
// and ddt_t; the inputs of CHUNK steps are staged in shared memory at a
// time.  dx_t's sum over n is a warp's reduce-scatter (a fixed butterfly)
// and then the four warps in order; r_t and v_t likewise.  A second kernel
// sums dB and dC over the heads, and dA over the batch rows, in index order
// from the per-head partials.  Its operations bound it (12 dp N a step and
// head on the CUDA cores: 0.29 ms at mamba2-780m's training shape).
//
// bf16 x: the chunked backward on the tensor cores.  In chunks of Q steps
// (cum_i = sum_{k<=i} dt_k A in the chunk, L[i,j] = exp(cum_i - cum_j) for
// i >= j, rem_j = exp(cum_Q - cum_j), total = exp(cum_Q), xd = dt x), with
// h_prev the state at the chunk's start and g the cotangent that later
// chunks send into its last state:
//   dC   = (dy x^T o L o dt_j) B          + e^{cum} o (dy h_prev)
//   z    = (x dy^T o L^T) C               + rem o (x g)
//   dx   = dt o ((B C^T o L^T) dy         + rem o (B g^T))
//   h   <- total h + x^T (rem o dt o B),   g <- total g + dy^T (e^{cum} o C)
// (rows of every product are the chunk's steps; o scales rows or masks.)
// Three kernels, from ssd_scan.py::plan_bwd's (Q, L, P) = (128, 64, 64),
// P 32 where dp <= 32 (P changes no bits):
//  * ssd_bwd_walk: a block a (batch, head, P rows of dp) and a direction,
//    in steps of L.  Forward blocks carry h in registers and keep it at
//    every Q-step boundary; reverse blocks carry g back from the last step,
//    keep it after every chunk's last step, and compute dx as the forward
//    kernel computes y, transposed.  The states are kept every 128 steps
//    (half the bytes of 64) while the walks step by 64, so a block's shared
//    memory (114 KB) leaves room for two an SM.  The chunks' dt and cum go
//    to the scratch for the next kernel.
//  * ssd_bwd_heads: a block a (batch, chunk, SCOLS columns of the state);
//    it walks the heads in order, each head's x, dy, h_prev and g fetched
//    by cp.async while the one before computes, and keeps the head sums of
//    dC and dB in registers (so they are summed in head order, and no
//    per-head partial leaves the block).  Each warp owns 16 steps i: the
//    dy x^T tiles at or below its diagonal for dC, the x dy^T tiles at or
//    above it for z, so the warps' work is even.  Off the diagonal tiles
//    the decay is a row factor times a column factor, each at most 1 (one
//    exp a row and tile, one a column and head, not one an element).  It
//    writes r_t = C_t.dC_t and v_t = B_t.z_t of its columns.
//  * ssd_bwd_finish: a block a head, a warp a batch row: the columns' r
//    and v summed in order, R and W from the last step in tiles of 32 (a
//    fixed shuffle scan in a tile), ddt, the row's dA in a fixed tree; the
//    rows' dA added in index order.
//
// Rounding.  x and dy are bf16, so dy x^T and its transpose are exact
// products with f32 sums, and x, dy take one piece where they meet an f32
// operand: the walks put rem dt (or e^{cum}) on B (or C).  dx is written
// in bf16 and held to 2e-2 of max |dx|, so its products take single bf16
// operands (B, C, g, and B C^T o L rounded in registers, as the forward
// rounds C B^T o L).  Every other product feeds an f32 output or a carried
// state and takes its f32 operands as three bf16 pieces (hi = bf16(v), mid
// = bf16(v - hi), lo = bf16(v - hi - mid): v to about 24 bits), adding
// hi.hi, hi.mid, mid.hi, hi.lo, mid.mid and lo.hi.  Two pieces (16 bits, as
// the forward takes) hold dB, dC and ddt to 1e-5 but not dA: dA = sum_k
// D_k (r_k - dt_k v_k) with D_k = dt_1 + .. + dt_k, terms far larger than
// dA, so r and v need about f32's precision.  The CPU emulation of this
// design (tests/test_torch_ssd_bwd_design.py::test_two_pieces_do_not_hold_dA)
// at S 512 drifts 8.7e-4 of max |dA| from an f64 autograd with two pieces,
// 4.4e-5 with three, where the f32 plain version drifts 3.6e-5.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700.00 W) at
// mamba2-780m's training shape, x (8, 48, 512, 64) bf16, N 128: inputs and
// outputs 85.5 MB, 0.0255 ms at 3.35 TB/s, the least time; the chunked
// form's products (C B^T once a batch row and chunk) at the bf16 rate take
// 0.0187 ms at Q 16, 0.0261 at 64, 0.0360 at this design's 128
// (chip_smoke.py::ssd_bwd_bounds).  The design moves 217 MB of scratch
// besides (h_prev and g, b nh (S / Q) dp N f32 each, 50.3 MB, written and
// read; r, v, dt and cum 7.9 MB), against the 403 MB of per-head partials
// the f32 design writes and reads.  It runs 0.85 ms by graph replay: the
// walks 0.31, the heads pass 0.52, the finish 0.021 (ab.py --sweep).  Taking
// parts out (ab.py --ablate) shows where: in the walks dx costs 0.10 ms,
// B's and C's pieces 0.04, their loads 0.03, the state products nothing
// seen; in the heads pass the intra-chunk tiles 0.30 (of which the five
// products past hi.hi 0.10 and the diagonal tiles' exps 0.09), h_prev's
// and g's pieces 0.025, the inter-chunk products 0.014 (PERF.md).
//
// Determinism: no float atomics; every sum has a fixed order; a batch row's
// dx, ddt, dB and dC come from blocks of that row alone (dA sums the rows);
// the grids come from the shapes and the plan (never b or S), so the call
// can be captured in a CUDA graph.  A ragged last chunk is zero-filled (dt
// = 0, x = dy = B = C = 0), which leaves the states and the valid steps as
// they were.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 x: the CUDA cores, a block a (batch, head)
// ---------------------------------------------------------------------------


constexpr int THREADS = 128;          // a thread a column n: N <= 128
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;             // steps staged in shared memory at once
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Reduce-scatter of v[0 .. C) over the warp's 32 lanes, lane offsets OFF,
// OFF / 2, .. 1: at each level a lane keeps half of its values (the upper
// half where its bit OFF is set) and adds its partner's copy of that half.
// At the end a lane holds max(C / 32, 1) sums, rows base.. of the original
// v; where C < 32, lanes that differ only in the low bits hold the same.
template <int C, int OFF>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* v, int lane, int& base) {
    if constexpr (C >= 2) {
      constexpr int H = C / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += H;
      if constexpr (OFF > 1) ReduceScatter<H, OFF / 2>::run(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      if constexpr (OFF > 1) ReduceScatter<1, OFF / 2>::run(v, lane, base);
    }
  }
};

// One instance: DPT rows of dp (dp <= DPT) a thread.
template <typename T, int DPT>
struct Smem {
  float x[CHUNK][DPT];
  float dy[CHUNK][DPT];
  float b[CHUNK][THREADS];
  float c[CHUNK][THREADS];
  float dt[CHUNK];
  float dx[WARPS][CHUNK][DPT];        // the warps' partial sums of dx
  float red[WARPS][CHUNK];            // the warps' partial r_t or v_t
};

// Stage steps t0 .. t0 + CHUNK - 1 of this (batch, head): zero past S, past
// dp and past N.
template <typename T, int DPT>
__device__ __forceinline__ void stage(Smem<T, DPT>& sm, const T* xr,
                                      const T* dyr, const float* br,
                                      const float* cr, const float* dtr,
                                      int t0, int S, int dp, int N, int tid) {
  for (int idx = tid; idx < CHUNK * DPT; idx += THREADS) {
    const int i = idx / DPT;
    const int p = idx % DPT;
    const bool ok = t0 + i < S && p < dp;
    const long long o = (long long)(t0 + i) * dp + p;
    sm.x[i][p] = ok ? to_f32(xr[o]) : 0.f;
    sm.dy[i][p] = ok ? to_f32(dyr[o]) : 0.f;
  }
  for (int idx = tid; idx < CHUNK * THREADS; idx += THREADS) {
    const int i = idx / THREADS;
    const int n = idx % THREADS;
    const bool ok = t0 + i < S && n < N;
    const long long o = (long long)(t0 + i) * N + n;
    sm.b[i][n] = ok ? br[o] : 0.f;
    sm.c[i][n] = ok ? cr[o] : 0.f;
  }
  if (tid < CHUNK) sm.dt[tid] = t0 + tid < S ? dtr[t0 + tid] : 0.f;
}

template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ h0,
               const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dB_h,
               float* __restrict__ dC_h, float* __restrict__ dA_h, int nh,
               int S, int dp, int N) {
  static_assert(DPT % 4 == 0 && DPT >= 4, "rows a thread");
  __shared__ __align__(16) Smem<T, DPT> sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = tid;                           // this thread's column
  const long long bh = blockIdx.x;             // b * nh + h
  const int h = (int)(bh % nh);
  const long long b = bh / nh;
  const float a_h = A[h];
  const T* xr = x + bh * S * dp;
  const T* dyr = dy + bh * S * dp;
  T* dxr = dx + bh * S * dp;
  const float* dtr = dt + bh * S;
  float* ddtr = ddt + bh * S;
  const float* br = Bm + b * S * N;
  const float* cr = Cm + b * S * N;
  float* dbr = dB_h + bh * S * N;
  float* dcr = dC_h + bh * S * N;

  // pass 1, forward: h, then dC_t = h_t^T dy_t and r_t = C_t . dC_t
  float st[DPT];
#pragma unroll
  for (int p = 0; p < DPT; ++p)
    st[p] = h0 != nullptr && p < dp && n < N ? h0[(bh * dp + p) * N + n]
                                             : 0.f;
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    __syncthreads();                           // the previous chunk read
    stage(sm, xr, dyr, br, cr, dtr, t0, S, dp, N, tid);
    __syncthreads();
    const int nv = min(CHUNK, S - t0);
    for (int i = 0; i < nv; ++i) {
      const float a = expf(sm.dt[i] * a_h);
      const float ub = sm.dt[i] * sm.b[i][n];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < DPT; p += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(&sm.x[i][p]);
        const float4 gv = *reinterpret_cast<const float4*>(&sm.dy[i][p]);
        st[p] = fmaf(a, st[p], xv.x * ub);
        st[p + 1] = fmaf(a, st[p + 1], xv.y * ub);
        st[p + 2] = fmaf(a, st[p + 2], xv.z * ub);
        st[p + 3] = fmaf(a, st[p + 3], xv.w * ub);
        acc[0] = fmaf(st[p], gv.x, acc[0]);
        acc[1] = fmaf(st[p + 1], gv.y, acc[1]);
        acc[2] = fmaf(st[p + 2], gv.z, acc[2]);
        acc[3] = fmaf(st[p + 3], gv.w, acc[3]);
      }
      const float dc = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      if (n < N) dcr[(long long)(t0 + i) * N + n] = dc;
      const float r = warp_sum(sm.c[i][n] * dc);
      if (lane == 0) sm.red[warp][i] = r;
    }
    __syncthreads();
    if (tid < nv) {                            // r_t, kept in ddt until pass 2
      float r = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) r += sm.red[w][tid];
      ddtr[t0 + tid] = r;
    }
  }

  // pass 2, backward: dh in the same registers
#pragma unroll
  for (int p = 0; p < DPT; ++p) st[p] = 0.f;
  float a_next = 0.f;                          // a_{t+1}, 0 past the end
  float R = 0.f, Wsum = 0.f, dA = 0.f;         // thread 0's running sums
  const int last = ((S - 1) / CHUNK) * CHUNK;
  for (int t0 = last; t0 >= 0; t0 -= CHUNK) {
    __syncthreads();                           // the previous chunk read
    stage(sm, xr, dyr, br, cr, dtr, t0, S, dp, N, tid);
    __syncthreads();
    const int nv = min(CHUNK, S - t0);
    for (int i = nv - 1; i >= 0; --i) {
      const float cn = sm.c[i][n];
      const float bn = sm.b[i][n];
      float part[DPT];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < DPT; p += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(&sm.x[i][p]);
        const float4 gv = *reinterpret_cast<const float4*>(&sm.dy[i][p]);
        st[p] = fmaf(a_next, st[p], gv.x * cn);
        st[p + 1] = fmaf(a_next, st[p + 1], gv.y * cn);
        st[p + 2] = fmaf(a_next, st[p + 2], gv.z * cn);
        st[p + 3] = fmaf(a_next, st[p + 3], gv.w * cn);
        acc[0] = fmaf(st[p], xv.x, acc[0]);
        acc[1] = fmaf(st[p + 1], xv.y, acc[1]);
        acc[2] = fmaf(st[p + 2], xv.z, acc[2]);
        acc[3] = fmaf(st[p + 3], xv.w, acc[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[p + e] = st[p + e] * bn;
      }
      const float z = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      if (n < N) dbr[(long long)(t0 + i) * N + n] = sm.dt[i] * z;
      const float v = warp_sum(bn * z);
      if (lane == 0) sm.red[warp][i] = v;
      int base = 0;
      ReduceScatter<DPT, 16>::run(part, lane, base);
      constexpr int KEEP = DPT >= 32 ? DPT / 32 : 1;
      constexpr int DUP = DPT >= 32 ? 0 : 32 / DPT - 1;
      if ((lane & DUP) == 0) {
#pragma unroll
        for (int j = 0; j < KEEP; ++j) sm.dx[warp][i][base + j] = part[j];
      }
      a_next = expf(sm.dt[i] * a_h);
    }
    __syncthreads();
    // dx_t = dt_t (the warps' sums in order)
    for (int idx = tid; idx < nv * dp; idx += THREADS) {
      const int i = idx / dp;
      const int p = idx % dp;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += sm.dx[w][i][p];
      put(dxr + (long long)(t0 + i) * dp + p, sm.dt[i] * s);
    }
    if (tid == 0) {                            // ddt and dA, in reverse order
      for (int i = nv - 1; i >= 0; --i) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) v += sm.red[w][i];
        const float d = sm.dt[i];
        R += ddtr[t0 + i];
        Wsum = fmaf(d, v, Wsum);
        const float sd = R - Wsum;
        ddtr[t0 + i] = fmaf(a_h, sd, v);
        dA = fmaf(d, sd, dA);
      }
    }
  }
  if (tid == 0) dA_h[bh] = dA;
}

// dB[b, t, n] = sum over heads of dB_h[b, h, t, n] in head order, dC
// likewise; block 0 also sums dA[h] over the batch rows in order.
__global__ void __launch_bounds__(REDUCE_THREADS)
ssd_bwd_reduce(const float* __restrict__ dB_h, const float* __restrict__ dC_h,
               const float* __restrict__ dA_h, float* __restrict__ dB,
               float* __restrict__ dC, float* __restrict__ dA, int bsz,
               int nh, int S, int N) {
  const long long per = (long long)S * N;
  const long long total = (long long)bsz * per;
  for (long long idx = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * REDUCE_THREADS) {
    const long long b = idx / per;
    const long long r = idx % per;
    const float* pb = dB_h + b * nh * per + r;
    const float* pc = dC_h + b * nh * per + r;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < nh; ++h) {
      sb += pb[h * per];
      sc += pc[h * per];
    }
    dB[idx] = sb;
    dC[idx] = sc;
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < nh; h += REDUCE_THREADS) {
      float s = 0.f;
      for (int b = 0; b < bsz; ++b) s += dA_h[(long long)b * nh + h];
      dA[h] = s;
    }
}

template <typename T, int DPT>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* h0, const void* dy, void* dx,
           float* ddt, float* dB_h, float* dC_h, float* dA_h, int b, int nh,
           int S, int dp, int N, cudaStream_t s) {
  ssd_bwd_kernel<T, DPT><<<(unsigned)((long long)b * nh), THREADS, 0, s>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, h0,
      static_cast<const T*>(dy), static_cast<T*>(dx), ddt, dB_h, dC_h, dA_h,
      nh, S, dp, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int rows, const void* x, const float* dt, const float* A,
             const float* Bm, const float* Cm, const float* h0,
             const void* dy, void* dx, float* ddt, float* dB_h, float* dC_h,
             float* dA_h, int b, int nh, int S, int dp, int N,
             cudaStream_t s) {
  switch (rows) {
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, h0, dy, dx, ddt, dB_h,
                                  dC_h, dA_h, b, nh, S, dp, N, s);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, h0, dy, dx, ddt, dB_h,
                                  dC_h, dA_h, b, nh, S, dp, N, s);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, h0, dy, dx, ddt, dB_h,
                                  dC_h, dA_h, b, nh, S, dp, N, s);
  }
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// bf16 x: the chunked backward on the tensor cores
// ---------------------------------------------------------------------------

constexpr int NMAX = 128;            // state width N the bf16 design takes
constexpr int DPMAX = 64;            // head dim dp the bf16 design takes
constexpr int SCOLS = 32;            // state columns a block of the heads pass
constexpr int FIN_WARPS = 8;         // batch rows a finish block at once
constexpr int MAX_SMEM = 232448;     // bytes of shared memory a block can use

// shared memory of a walk block: B and C rows (5 L x (NMAX + 8) bf16: the
// forward walk's rem dt B in three pieces, the reverse walk's B hi, C hi and
// e^{cum} C in three pieces), g hi (P x (NMAX + 8)), x or dy (L x (P + 8)),
// dt and cum (2 L f32)
__host__ __device__ constexpr int walk_smem_bytes(int L, int P) {
  return (5 * L + P) * (NMAX + 8) * 2 + L * (P + 8) * 2 + 2 * L * 4;
}
// shared memory of a heads block: two buffers of x and dy rows (L x (DPMAX
// + 8) bf16), of h_prev and g (DPMAX x SCOLS f32) and of dt and cum (L
// f32); the decay's two column factors (L f32 each); h_prev and g in three
// pieces (DPMAX x (SCOLS + 8) bf16), the
// chunk's B and C columns in three pieces (L x (SCOLS + 8) bf16)
__host__ __device__ constexpr int heads_smem_bytes(int L) {
  return 4 * L * (DPMAX + 8) * 2 + 4 * DPMAX * SCOLS * 4 + 6 * L * 4 +
         6 * DPMAX * (SCOLS + 8) * 2 + 6 * L * (SCOLS + 8) * 2;
}

// Inclusive cumulative sum of dts[j] * a over the chunk, by warp 0: lane l
// sums its L / 32 consecutive steps, a shuffle scan adds the lanes before
// it (the forward kernel's order).
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

// v0, v1 as three bf16 pieces each, hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid) (both differences exact in f32), a pair to a register
// (the lower column in the low half)
__device__ __forceinline__ void split3_pair(float v0, float v1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h);
  const float r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// four consecutive f32 to three piece rows of bf16 at hi, mid, lo
__device__ __forceinline__ void split3_store4(__nv_bfloat16* hi,
                                              __nv_bfloat16* mid,
                                              __nv_bfloat16* lo, float4 v) {
  uint32_t h[2], m[2], l[2];
  split3_pair(v.x, v.y, h[0], m[0], l[0]);
  split3_pair(v.z, v.w, h[1], m[1], l[1]);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h[0], h[1]);
  *reinterpret_cast<uint2*>(mid) = make_uint2(m[0], m[1]);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l[0], l[1]);
}
// c0 += a . (columns 0-7 of b), c1 += a . (columns 8-15 of b), a and b as
// three pieces (b's from ldmatrix_x4_trans: registers 0, 1 then 2, 3), the
// two sums' terms interleaved
__device__ __forceinline__ void mma3x2(float c0[4], float c1[4],
                                       const uint32_t a[3][4],
                                       const uint32_t b0[4],
                                       const uint32_t b1[4],
                                       const uint32_t b2[4]) {
  mma::mma_bf16(c0, a[0], b0[0], b0[1]);     // hi.hi
  mma::mma_bf16(c1, a[0], b0[2], b0[3]);
  mma::mma_bf16(c0, a[0], b1[0], b1[1]);     // hi.mid
  mma::mma_bf16(c1, a[0], b1[2], b1[3]);
  mma::mma_bf16(c0, a[1], b0[0], b0[1]);     // mid.hi
  mma::mma_bf16(c1, a[1], b0[2], b0[3]);
  mma::mma_bf16(c0, a[0], b2[0], b2[1]);     // hi.lo
  mma::mma_bf16(c1, a[0], b2[2], b2[3]);
  mma::mma_bf16(c0, a[1], b1[0], b1[1]);     // mid.mid
  mma::mma_bf16(c1, a[1], b1[2], b1[3]);
  mma::mma_bf16(c0, a[2], b0[0], b0[1]);     // lo.hi
  mma::mma_bf16(c1, a[2], b0[2], b0[3]);
}
// the C fragment pairs of two 8-column tiles (16 x 16) as the three-piece
// A fragment of one 16-deep k tile
__device__ __forceinline__ void frag3(const float f0[4], const float f1[4],
                                      uint32_t a[3][4]) {
  split3_pair(f0[0], f0[1], a[0][0], a[1][0], a[2][0]);
  split3_pair(f0[2], f0[3], a[0][1], a[1][1], a[2][1]);
  split3_pair(f1[0], f1[1], a[0][2], a[1][2], a[2][2]);
  split3_pair(f1[2], f1[3], a[0][3], a[1][3], a[2][3]);
}

__device__ __forceinline__ float4 load4(const float* p, int n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  float* e = &v.x;
  for (int i = 0; i < 4 && i < n; ++i) e[i] = p[i];
  return v;
}

// One walk configuration: steps of L (L / 16 warps, 16 steps each) and P
// rows of dp a block.
template <int L, int P>
struct Walk {
  static constexpr int W = L / 16;
  static constexpr int THREADS = 32 * W;
  static constexpr int NPITCH = NMAX + 8;    // bf16 row of B, C, g
  static constexpr int PPITCH = P + 8;       // bf16 row of x or dy
  static constexpr int NT = NMAX / 8 / W;    // state n-tiles a warp owns
  static constexpr int MT = P / 16;          // state m-tiles (16 p rows)
  static constexpr int PT = P / 8;           // dx n-tiles (8 p columns)
  static_assert(L % 32 == 0 && L <= 128 && P % 16 == 0 && NT % 2 == 0,
                "tile shape");
  static constexpr int SMEM = walk_smem_bytes(L, P);
  static_assert(SMEM <= MAX_SMEM, "walk shared memory");
};

template <int L, int P>
__global__ void __launch_bounds__(Walk<L, P>::THREADS)
ssd_bwd_walk(const __nv_bfloat16* __restrict__ x,
             const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ Bm, const float* __restrict__ Cm,
             const float* __restrict__ h0,
             const __nv_bfloat16* __restrict__ dy,
             __nv_bfloat16* __restrict__ dx, float* __restrict__ hs,
             float* __restrict__ gs, float* __restrict__ dtc, int nh, int S,
             int dp, int N, int npad, int Q, int vb) {
  using K = Walk<L, P>;
  constexpr int NPITCH = K::NPITCH;
  constexpr int PPITCH = K::PPITCH;
  constexpr int NT = K::NT;
  constexpr int MT = K::MT;
  constexpr int PT = K::PT;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  // R0 B hi (reverse, for dx) or B' hi (forward); R1 B' mid or C hi; R2 B'
  // lo or C' hi; R3, R4 C' mid and lo.  B' = rem dt B, C' = e^{cum} C.
  __nv_bfloat16* R0 = reinterpret_cast<__nv_bfloat16*>(walk_smem);
  __nv_bfloat16* R1 = R0 + L * NPITCH;
  __nv_bfloat16* R2 = R1 + L * NPITCH;
  __nv_bfloat16* R3 = R2 + L * NPITCH;
  __nv_bfloat16* R4 = R3 + L * NPITCH;
  __nv_bfloat16* Gh = R4 + L * NPITCH;       // g hi (P x NPITCH)
  __nv_bfloat16* XY = Gh + P * NPITCH;       // x or dy (L x PPITCH)
  float* dts = reinterpret_cast<float*>(XY + L * PPITCH);
  float* cum = dts + L;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lj = lane >> 3;                  // ldmatrix: matrix lane / 8
  const int lr = lane & 7;                   // and its row lane % 8
  const int slices = (dp + P - 1) / P;
  const bool rev = (int)blockIdx.x >= slices;
  const int p0 = (rev ? (int)blockIdx.x - slices : (int)blockIdx.x) * P;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * nh + h;
  const int keep = Q / L;                    // walk steps a kept state
  const int nq = (S + Q - 1) / Q;            // kept states
  const int ns = (S + L - 1) / L;            // walk steps
  const float a_h = A[h];
  const __nv_bfloat16* xr = x + bh * S * dp;
  const __nv_bfloat16* dyr = dy + bh * S * dp;
  __nv_bfloat16* dxr = dx + bh * S * dp;
  const float* dtr = dt + bh * S;
  const float* br = Bm + (long long)b * S * N;
  const float* cr = Cm + (long long)b * S * N;
  const long long one = (long long)dp * npad;        // one state
  float* so = (rev ? gs : hs) + bh * nq * one;
  float* dto = dtc + bh * nq * Q;                    // dt, cum of the Q steps
  float* cumo = dtc + ((long long)gridDim.z * nh + bh) * nq * Q;
  const bool nvec = (N & 3) == 0 &&          // float4 rows of B and C
                    ((reinterpret_cast<uintptr_t>(Bm) |
                      reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;

  // h (forward) or g (reverse), f32 in the accumulator layout of its update:
  // st[m][nt][e] is row p = 16 m + g (+ 8 for e >= 2) of the slice, column
  // n = 8 (warp NT + nt) + 2 t + (e & 1)
  float st[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * m + g + (e >= 2 ? 8 : 0);
        const int n = 8 * (warp * NT + nt) + 2 * t + (e & 1);
        st[m][nt][e] = !rev && h0 != nullptr && p < dp && n < N
                           ? h0[(bh * dp + p) * N + n]
                           : 0.f;
      }
  float base = 0.f;                          // cum of the Q steps so far

  for (int it = 0; it < ns; ++it) {
    const int c = rev ? ns - 1 - it : it;
    const int t0 = c * L;
    const int nv = min(L, S - t0);           // valid steps
    __syncthreads();                         // the previous steps consumed
    if (tid < L) dts[tid] = tid < nv ? dtr[t0 + tid] : 0.f;
    // this block's columns of x (forward) or dy (reverse), zero past nv, dp
    const __nv_bfloat16* src = rev ? dyr : xr;
    for (int idx = tid; idx < L * (P / 8); idx += K::THREADS) {
      const int j = idx / (P / 8);
      const int c8 = (idx % (P / 8)) * 8;
      mma::cp_chunk<false>(XY + j * PPITCH + c8,
                           src + (long long)(t0 + j) * dp + p0 + c8, j < nv,
                           dp - p0 - c8, vb, x);
    }
    mma::cp_commit();
    // the kept state: h before the first of its Q steps, g after the last
    const bool save = rev ? (c % keep == keep - 1 || c == ns - 1)
                          : c % keep == 0;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * m + g + 8 * r;
          const int n = 8 * (warp * NT + nt) + 2 * t;
          const float v0 = st[m][nt][2 * r];
          const float v1 = st[m][nt][2 * r + 1];
          if (save && p0 + p < dp && n < npad)
            *reinterpret_cast<float2*>(so + (c / keep) * one +
                                       (long long)(p0 + p) * npad + n) =
                make_float2(v0, v1);
          if (rev)
            *reinterpret_cast<uint32_t*>(Gh + p * NPITCH + n) =
                mma::pack_bf16(v0, v1);
        }
    mma::cp_wait<0>();
    __syncthreads();
    if (warp == 0) chunk_cumsum<L>(dts, a_h, cum, lane);
    __syncthreads();
    const float cum_last = cum[L - 1];
    if (!rev && p0 == 0) {                   // dt and cum of the Q steps
      if (c % keep == 0) base = 0.f;
      for (int idx = tid; idx < L; idx += K::THREADS) {
        dto[(long long)c * L + idx] = dts[idx];
        cumo[(long long)c * L + idx] = base + cum[idx];
      }
      // a last kept state shorter than Q: dt 0 and cum held past S
      if (c == ns - 1)
        for (int idx = (c + 1) * L + tid; idx < nq * Q; idx += K::THREADS) {
          dto[idx] = 0.f;
          cumo[idx] = base + cum_last;
        }
      base += cum_last;
    }
    // B' = rem dt B in three pieces (forward); B hi, C hi and C' = e^{cum}
    // C in three pieces (reverse); zero past nv and past N.  A thread's 16
    // float4 of each in two rounds of 8 loads, then their stores.
    static_assert(L * (NMAX / 4) == 16 * K::THREADS, "float4 a thread");
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float4 bv[8], cv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = tid + (8 * half + u) * K::THREADS;
        const int j = idx / (NMAX / 4);
        const int cc = (idx % (NMAX / 4)) * 4;
        bv[u] = cv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < nv && cc < N) {
          const long long o = (long long)(t0 + j) * N + cc;
          if (nvec) {
            bv[u] = *reinterpret_cast<const float4*>(br + o);
            if (rev) cv[u] = *reinterpret_cast<const float4*>(cr + o);
          } else {
            bv[u] = load4(br + o, N - cc);
            if (rev) cv[u] = load4(cr + o, N - cc);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = tid + (8 * half + u) * K::THREADS;
        const int j = idx / (NMAX / 4);
        const int so4 = j * NPITCH + (idx % (NMAX / 4)) * 4;
        const float4 b4 = bv[u];
        const float4 c4 = cv[u];
        if (!rev) {
          const float w = expf(cum_last - cum[j]) * dts[j];
          split3_store4(R0 + so4, R1 + so4, R2 + so4,
                        make_float4(w * b4.x, w * b4.y, w * b4.z, w * b4.w));
        } else {
          const float w = expf(cum[j]);
          *reinterpret_cast<uint2*>(R0 + so4) = make_uint2(
              mma::pack_bf16(b4.x, b4.y), mma::pack_bf16(b4.z, b4.w));
          *reinterpret_cast<uint2*>(R1 + so4) = make_uint2(
              mma::pack_bf16(c4.x, c4.y), mma::pack_bf16(c4.z, c4.w));
          split3_store4(R2 + so4, R3 + so4, R4 + so4,
                        make_float4(w * c4.x, w * c4.y, w * c4.z, w * c4.w));
        }
      }
    }
    __syncthreads();

    if (rev) {
      // ---- dx of this warp's steps i0 .. i0 + 15 -------------------------
      const int i0 = 16 * warp;
      const int ia = i0 + g;
      const int ib = ia + 8;
      const float cum_a = cum[ia];
      const float cum_b = cum[ib];
      // B rows as A fragments (k = n)
      uint32_t bfr[NMAX / 16][4];
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk)
        mma::ldmatrix_x4(bfr[kk], R0 + (i0 + (lj & 1) * 8 + lr) * NPITCH +
                                      kk * 16 + (lj >> 1) * 8);
      // B C^T over the tiles at or above the diagonal
      float gq[L / 8][4];
#pragma unroll
      for (int i = 0; i < L / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) gq[i][e] = 0.f;
#pragma unroll
      for (int np = 0; np < L / 16; ++np) {
        if (np < warp) continue;
#pragma unroll
        for (int kk = 0; kk < NMAX / 16; ++kk) {
          uint32_t kb[4];
          mma::ldmatrix_x4(kb, R1 + (np * 16 + (lj >> 1) * 8 + lr) * NPITCH +
                                   kk * 16 + (lj & 1) * 8);
          mma::mma_bf16(gq[2 * np], bfr[kk], kb[0], kb[1]);
          mma::mma_bf16(gq[2 * np + 1], bfr[kk], kb[2], kb[3]);
        }
      }
      // the k >= i mask, then the decay exp(cum_k - cum_i)
#pragma unroll
      for (int kt = 0; kt < L / 8; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kt * 8 + 2 * t + (e & 1);
          const int i = e >= 2 ? ib : ia;
          const float ci = e >= 2 ? cum_b : cum_a;
          gq[kt][e] = k >= i ? gq[kt][e] * expf(cum[k] - ci) : 0.f;
        }
      float di[PT][4];
      float de[PT][4];
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) di[i][e] = de[i][e] = 0.f;
      // intra: (B C^T o L^T) (bf16 in registers) . dy
#pragma unroll
      for (int kc = 0; kc < L / 16; ++kc) {
        if (kc < warp) continue;
        const uint32_t ga[4] = {mma::pack_bf16(gq[2 * kc][0], gq[2 * kc][1]),
                                mma::pack_bf16(gq[2 * kc][2], gq[2 * kc][3]),
                                mma::pack_bf16(gq[2 * kc + 1][0],
                                               gq[2 * kc + 1][1]),
                                mma::pack_bf16(gq[2 * kc + 1][2],
                                               gq[2 * kc + 1][3])};
#pragma unroll
        for (int pp = 0; pp < PT / 2; ++pp) {
          uint32_t vb[4];
          mma::ldmatrix_x4_trans(vb, XY + (kc * 16 + (lj & 1) * 8 + lr) *
                                              PPITCH + pp * 16 + (lj >> 1) * 8);
          mma::mma_bf16(di[2 * pp], ga, vb[0], vb[1]);
          mma::mma_bf16(di[2 * pp + 1], ga, vb[2], vb[3]);
        }
      }
      // inter: B . g_hi^T
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk)
#pragma unroll
        for (int pp = 0; pp < PT / 2; ++pp) {
          uint32_t hb[4];
          mma::ldmatrix_x4(hb, Gh + (pp * 16 + (lj >> 1) * 8 + lr) * NPITCH +
                                   kk * 16 + (lj & 1) * 8);
          mma::mma_bf16(de[2 * pp], bfr[kk], hb[0], hb[1]);
          mma::mma_bf16(de[2 * pp + 1], bfr[kk], hb[2], hb[3]);
        }
      // dx = dt_i (intra + rem_i inter), rows below nv, columns below dp
      const float ra = expf(cum_last - cum_a);
      const float rb = expf(cum_last - cum_b);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r ? ib : ia;
          const int p = p0 + pt * 8 + 2 * t;
          if (i >= nv || p >= dp) continue;
          const float rf = r ? rb : ra;
          const float d = dts[i];
          const float v0 = d * (di[pt][2 * r] + rf * de[pt][2 * r]);
          const float v1 = d * (di[pt][2 * r + 1] + rf * de[pt][2 * r + 1]);
          __nv_bfloat16* o = dxr + (long long)(t0 + i) * dp + p;
          if (p + 1 < dp && (dp & 1) == 0) {
            *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(v0, v1);
          } else {
            o[0] = __float2bfloat16_rn(v0);
            if (p + 1 < dp) o[1] = __float2bfloat16_rn(v1);
          }
        }
    }

    // ---- the state: st = total st + (x or dy)^T (B' or C'), this warp's
    // columns; x and dy are exact in bf16, B' and C' in three pieces
    const float total = expf(cum_last);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[m][nt][e] *= total;
    const __nv_bfloat16* V0 = rev ? R2 : R0;
    const __nv_bfloat16* V1 = rev ? R3 : R1;
    const __nv_bfloat16* V2 = rev ? R4 : R2;
#pragma unroll
    for (int kc = 0; kc < L / 16; ++kc)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t v[3][4];
        const int boff = (kc * 16 + (lj & 1) * 8 + lr) * NPITCH +
                         warp * NT * 8 + np * 16 + (lj >> 1) * 8;
        mma::ldmatrix_x4_trans(v[0], V0 + boff);
        mma::ldmatrix_x4_trans(v[1], V1 + boff);
        mma::ldmatrix_x4_trans(v[2], V2 + boff);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t xa[4];
          mma::ldmatrix_x4_trans(xa, XY + (kc * 16 + (lj >> 1) * 8 + lr) *
                                              PPITCH + m * 16 + (lj & 1) * 8);
#pragma unroll
          for (int pc = 0; pc < 3; ++pc)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma::mma_bf16(st[m][2 * np + q], xa, v[pc][2 * q],
                            v[pc][2 * q + 1]);
        }
      }
  }
}

// One heads-pass configuration: chunk length L, a warp a 16-step row tile
// on the block's SCOLS state columns.
template <int L>
struct Heads {
  static constexpr int RT = L / 16;          // row tiles
  static constexpr int THREADS = 32 * RT;
  static constexpr int DPITCH = DPMAX + 8;   // bf16 row of x, dy
  static constexpr int SPITCH = SCOLS + 8;   // bf16 row of h, g, B, C pieces
  static constexpr int NT = SCOLS / 8;       // n-tiles of a warp's columns
  static constexpr int DK = DPMAX / 16;      // k tiles over dp
  static_assert(L % 32 == 0 && L <= 128 && NT % 2 == 0, "tile shape");
  // two buffers of x, dy rows, h_prev and g (f32), dt and cum; the column
  // factors of the decay; then the pieces of h_prev, g, B and C
  static constexpr int XS = 0;
  static constexpr int YS = XS + 2 * L * DPITCH * 2;
  static constexpr int HF = YS + 2 * L * DPITCH * 2;
  static constexpr int GF = HF + 2 * DPMAX * SCOLS * 4;
  static constexpr int DT = GF + 2 * DPMAX * SCOLS * 4;
  static constexpr int CUM = DT + 2 * L * 4;
  static constexpr int COLF = CUM + 2 * L * 4;
  static constexpr int H3 = COLF + 2 * L * 4;
  static constexpr int G3 = H3 + 3 * DPMAX * SPITCH * 2;
  static constexpr int B3 = G3 + 3 * DPMAX * SPITCH * 2;
  static constexpr int C3 = B3 + 3 * L * SPITCH * 2;
  static constexpr int SMEM = C3 + 3 * L * SPITCH * 2;
  static_assert(SMEM == heads_smem_bytes(L) && SMEM <= MAX_SMEM,
                "heads shared memory");
};

// The masked, decayed products of one 16 x 16 tile, as the three-piece A
// fragment: rows i of this warp's tile, columns j of tile jt.  LOWER: dy_i .
// x_j exp(cum_i - cum_j) dt_j for j <= i (dC); else x_i . dy_j exp(cum_j -
// cum_i) for j >= i (z).  Two sums over alternate k tiles of dp (shorter
// chains), then added.  Off the diagonal the decay is a row factor rf (one
// a row: exp(cum_i - cum_e), e the tile's last column, for dC; exp(cum_s -
// cum_i), s its first, for z) times a column factor colf[j] (exp(cum_e -
// cum_j) dt_j, or exp(cum_j - cum_s)), each at most 1; on it, one exp an
// element after the mask.
template <bool LOWER, int DPITCH, int DK>
__device__ __forceinline__ void decayed_tile(
    const uint32_t (&ra)[DK][4], const __nv_bfloat16* cols, int jt, int dpk,
    bool diag, const float* cumv, const float* dtv, const float* colf,
    int ia, int ib, float cum_a, float cum_b, float rfa, float rfb, int lane,
    uint32_t a3[3][4]) {
  const int t = lane & 3;
  const int lj = lane >> 3;
  const int lr = lane & 7;
  float mm[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    if (kk < dpk) {
      uint32_t kb[4];
      mma::ldmatrix_x4(kb, cols + (jt * 16 + (lj >> 1) * 8 + lr) * DPITCH +
                               kk * 16 + (lj & 1) * 8);
      mma::mma_bf16(mm[2 * (kk & 1)], ra[kk], kb[0], kb[1]);
      mma::mma_bf16(mm[2 * (kk & 1) + 1], ra[kk], kb[2], kb[3]);
    }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = mm[q][e] + mm[2 + q][e];
      const int j = jt * 16 + q * 8 + 2 * t + (e & 1);
      const int i = e >= 2 ? ib : ia;
      if (!diag) {
        mm[q][e] = v * (e >= 2 ? rfb : rfa) * colf[j];
      } else {
        const float ci = e >= 2 ? cum_b : cum_a;
        if (LOWER)
          mm[q][e] = j <= i ? v * expf(ci - cumv[j]) * dtv[j] : 0.f;
        else
          mm[q][e] = j >= i ? v * expf(cumv[j] - ci) : 0.f;
      }
    }
  frag3(mm[0], mm[1], a3);
}

template <int L>
__global__ void __launch_bounds__(Heads<L>::THREADS)
ssd_bwd_heads(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              const __nv_bfloat16* __restrict__ dy,
              const float* __restrict__ hs, const float* __restrict__ gs,
              const float* __restrict__ dtc, float* __restrict__ dB,
              float* __restrict__ dC, float* __restrict__ rs,
              float* __restrict__ vs, int nh, int S, int dp, int N,
              int npad, int vb) {
  using K = Heads<L>;
  constexpr int RT = K::RT;
  constexpr int DPITCH = K::DPITCH;
  constexpr int SPITCH = K::SPITCH;
  constexpr int NT = K::NT;
  constexpr int DK = K::DK;
  extern __shared__ __align__(16) unsigned char heads_smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(heads_smem + K::XS);
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(heads_smem + K::YS);
  float* Hf = reinterpret_cast<float*>(heads_smem + K::HF);
  float* Gf = reinterpret_cast<float*>(heads_smem + K::GF);
  float* DTs = reinterpret_cast<float*>(heads_smem + K::DT);
  float* CUMs = reinterpret_cast<float*>(heads_smem + K::CUM);
  float* dcol = reinterpret_cast<float*>(heads_smem + K::COLF);
  float* zcol = dcol + L;
  __nv_bfloat16* H3 = reinterpret_cast<__nv_bfloat16*>(heads_smem + K::H3);
  __nv_bfloat16* G3 = reinterpret_cast<__nv_bfloat16*>(heads_smem + K::G3);
  __nv_bfloat16* B3 = reinterpret_cast<__nv_bfloat16*>(heads_smem + K::B3);
  __nv_bfloat16* C3 = reinterpret_cast<__nv_bfloat16*>(heads_smem + K::C3);
  constexpr int HP = DPMAX * SPITCH;         // one piece of h_prev or g
  constexpr int BP = L * SPITCH;             // one piece of B or C

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rt = warp;                       // this warp's row tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lj = lane >> 3;
  const int lr = lane & 7;
  const int sl = blockIdx.x;                 // the block's state columns
  const int n0 = sl * SCOLS;
  const int nrv = gridDim.x;                 // r, v column blocks
  const int c = blockIdx.y;                  // the chunk
  const int b = blockIdx.z;
  const int nc = (S + L - 1) / L;
  const int t0 = c * L;
  const int nv = min(L, S - t0);
  const int dpk = (dp + 15) / 16;            // k tiles over dp that are used
  const long long half = (long long)gridDim.z * nh * nc * L;
  const long long one = (long long)dp * npad;

  // the chunk's B and C columns n0 .. n0 + SCOLS in three pieces, zero past
  // nv and past N
  for (int idx = tid; idx < L * (SCOLS / 4); idx += K::THREADS) {
    const int j = idx / (SCOLS / 4);
    const int cc = (idx % (SCOLS / 4)) * 4;
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 cv = bv;
    if (j < nv && n0 + cc < N) {
      const long long o = ((long long)b * S + t0 + j) * N + n0 + cc;
      bv = load4(Bm + o, N - n0 - cc);
      cv = load4(Cm + o, N - n0 - cc);
    }
    const int so4 = j * SPITCH + cc;
    split3_store4(B3 + so4, B3 + BP + so4, B3 + 2 * BP + so4, bv);
    split3_store4(C3 + so4, C3 + BP + so4, C3 + 2 * BP + so4, cv);
  }

  // head hh's x and dy rows, h_prev and g columns, dt and cum into buffer
  // buf, by cp.async (one commit group)
  auto fetch = [&](int hh, int buf) {
    const long long bhh = (long long)b * nh + hh;
    const __nv_bfloat16* xr = x + (bhh * S + t0) * dp;
    const __nv_bfloat16* yr = dy + (bhh * S + t0) * dp;
    __nv_bfloat16* xd = Xs + buf * L * DPITCH;
    __nv_bfloat16* yd = Ys + buf * L * DPITCH;
    for (int idx = tid; idx < L * (DPMAX / 8); idx += K::THREADS) {
      const int j = idx / (DPMAX / 8);
      const int c8 = (idx % (DPMAX / 8)) * 8;
      if (c8 >= dpk * 16) continue;          // k tiles past dp: never read
      const bool ok = j < nv && c8 < dp;
      mma::cp_chunk<false>(xd + j * DPITCH + c8, xr + (long long)j * dp + c8,
                           ok, dp - c8, vb, x);
      mma::cp_chunk<false>(yd + j * DPITCH + c8, yr + (long long)j * dp + c8,
                           ok, dp - c8, vb, dy);
    }
    const float* hsrc = hs + (bhh * nc + c) * one + n0;
    const float* gsrc = gs + (bhh * nc + c) * one + n0;
    for (int idx = tid; idx < DPMAX * (SCOLS / 4); idx += K::THREADS) {
      const int p = idx / (SCOLS / 4);
      const int c4 = (idx % (SCOLS / 4)) * 4;
      if (p >= dpk * 16) continue;
      const bool ok = p < dp;
      const long long o = (long long)p * npad + c4;
      mma::cp_async16(Hf + (buf * DPMAX + p) * SCOLS + c4,
                      ok ? hsrc + o : hs, ok ? 16 : 0);
      mma::cp_async16(Gf + (buf * DPMAX + p) * SCOLS + c4,
                      ok ? gsrc + o : gs, ok ? 16 : 0);
    }
    const float* dsrc = dtc + (bhh * nc + c) * L;
    for (int idx = tid; idx < L / 4; idx += K::THREADS) {
      mma::cp_async16(DTs + buf * L + 4 * idx, dsrc + 4 * idx, 16);
      mma::cp_async16(CUMs + buf * L + 4 * idx, dsrc + half + 4 * idx, 16);
    }
    mma::cp_commit();
  };

  // this warp's steps i0 .. i0 + 15
  const int i0 = 16 * rt;
  const int ia = i0 + g;
  const int ib = ia + 8;
  // the head sums of dC and dB, in head order
  float dcs[NT][4], dbs[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dcs[i][e] = dbs[i][e] = 0.f;

  fetch(0, 0);
  for (int hh = 0; hh < nh; ++hh) {
    const int buf = hh & 1;
    __syncthreads();                         // head hh - 1 consumed
    if (hh + 1 < nh) {
      fetch(hh + 1, buf ^ 1);
      mma::cp_wait<1>();
    } else {
      mma::cp_wait<0>();
    }
    __syncthreads();                         // head hh's rows arrived
    // h_prev and g in three pieces
    for (int idx = tid; idx < DPMAX * (SCOLS / 4); idx += K::THREADS) {
      const int p = idx / (SCOLS / 4);
      const int c4 = (idx % (SCOLS / 4)) * 4;
      if (p >= dpk * 16) continue;
      const int so4 = p * SPITCH + c4;
      const float4 hv = *reinterpret_cast<const float4*>(
          Hf + (buf * DPMAX + p) * SCOLS + c4);
      const float4 gv = *reinterpret_cast<const float4*>(
          Gf + (buf * DPMAX + p) * SCOLS + c4);
      split3_store4(H3 + so4, H3 + HP + so4, H3 + 2 * HP + so4, hv);
      split3_store4(G3 + so4, G3 + HP + so4, G3 + 2 * HP + so4, gv);
    }
    // the decay's column factors: exp(cum_e - cum_j) dt_j, e the last step
    // of j's tile (dC), and exp(cum_j - cum_s), s its first (z)
    if (tid < L) {
      const float* cumb = CUMs + buf * L;
      const int s0 = tid & ~15;
      dcol[tid] = expf(cumb[s0 + 15] - cumb[tid]) * DTs[buf * L + tid];
      zcol[tid] = expf(cumb[tid] - cumb[s0]);
    }
    __syncthreads();
    const __nv_bfloat16* Xc = Xs + buf * L * DPITCH;
    const __nv_bfloat16* Yc = Ys + buf * L * DPITCH;
    const float* dtv = DTs + buf * L;
    const float* cumv = CUMs + buf * L;
    const float cum_a = cumv[ia];
    const float cum_b = cumv[ib];
    const float cum_last = cumv[L - 1];
    const long long row = ((long long)b * nh + hh) * S + t0;
    const int aoff = (i0 + (lj & 1) * 8 + lr) * DPITCH + (lj >> 1) * 8;
    // the piece offset of a 16-column pair in a k tile of 16 rows
    const int boff = ((lj & 1) * 8 + lr) * SPITCH + (lj >> 1) * 8;

    // ---- dC_i = sum_{j<=i} L[i,j] dt_j (dy_i . x_j) B_j + e^{cum_i} h^T dy_i
    {
      uint32_t ya[DK][4];                    // dy rows as A fragments (k = p)
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        if (kk < dpk) mma::ldmatrix_x4(ya[kk], Yc + aoff + kk * 16);
      float di[NT][4] = {}, de[NT][4] = {};
#pragma unroll
      for (int jt = 0; jt < RT; ++jt) {
        if (jt > rt) continue;
        const float ce = cumv[jt * 16 + 15];
        uint32_t a3[3][4];
        decayed_tile<true, DPITCH, DK>(ya, Xc, jt, dpk, jt == rt, cumv, dtv,
                                       dcol, ia, ib, cum_a, cum_b,
                                       expf(cum_a - ce), expf(cum_b - ce),
                                       lane, a3);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t v0[4], v1[4], v2[4];
          const int off = jt * 16 * SPITCH + np * 16 + boff;
          mma::ldmatrix_x4_trans(v0, B3 + off);
          mma::ldmatrix_x4_trans(v1, B3 + BP + off);
          mma::ldmatrix_x4_trans(v2, B3 + 2 * BP + off);
          mma3x2(di[2 * np], di[2 * np + 1], a3, v0, v1, v2);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        if (kk < dpk) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int off = kk * 16 * SPITCH + np * 16 + boff;
#pragma unroll
            for (int pc = 0; pc < 3; ++pc) {
              uint32_t hb[4];
              mma::ldmatrix_x4_trans(hb, H3 + pc * HP + off);
              mma::mma_bf16(de[2 * np], ya[kk], hb[0], hb[1]);
              mma::mma_bf16(de[2 * np + 1], ya[kk], hb[2], hb[3]);
            }
          }
        }
      // dC of this head into the sum; r_i = C_i . dC_i over these columns
      const float ea = expf(cum_a);
      const float eb = expf(cum_b);
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool up = e >= 2;
          const int i = up ? ib : ia;
          const int off = i * SPITCH + nt * 8 + 2 * t + (e & 1);
          const float v = di[nt][e] + (up ? eb : ea) * de[nt][e];
          dcs[nt][e] += v;
          const float cv = (__bfloat162float(C3[off]) +
                            __bfloat162float(C3[BP + off])) +
                           __bfloat162float(C3[2 * BP + off]);
          if (up)
            rb = fmaf(cv, v, rb);
          else
            ra = fmaf(cv, v, ra);
        }
      ra += __shfl_xor_sync(0xffffffffu, ra, 1);
      ra += __shfl_xor_sync(0xffffffffu, ra, 2);
      rb += __shfl_xor_sync(0xffffffffu, rb, 1);
      rb += __shfl_xor_sync(0xffffffffu, rb, 2);
      if (t == 0 && ia < nv) rs[(row + ia) * nrv + sl] = ra;
      if (t == 0 && ib < nv) rs[(row + ib) * nrv + sl] = rb;
    }

    // ---- z_i = sum_{k>=i} L[k,i] (x_i . dy_k) C_k + rem_i g^T x_i
    {
      uint32_t xa[DK][4];                    // x rows as A fragments (k = p)
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        if (kk < dpk) mma::ldmatrix_x4(xa[kk], Xc + aoff + kk * 16);
      float di[NT][4] = {}, de[NT][4] = {};
#pragma unroll
      for (int kt = 0; kt < RT; ++kt) {
        if (kt < rt) continue;
        const float cs = cumv[kt * 16];
        uint32_t a3[3][4];
        decayed_tile<false, DPITCH, DK>(xa, Yc, kt, dpk, kt == rt, cumv, dtv,
                                        zcol, ia, ib, cum_a, cum_b,
                                        expf(cs - cum_a), expf(cs - cum_b),
                                        lane, a3);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t v0[4], v1[4], v2[4];
          const int off = kt * 16 * SPITCH + np * 16 + boff;
          mma::ldmatrix_x4_trans(v0, C3 + off);
          mma::ldmatrix_x4_trans(v1, C3 + BP + off);
          mma::ldmatrix_x4_trans(v2, C3 + 2 * BP + off);
          mma3x2(di[2 * np], di[2 * np + 1], a3, v0, v1, v2);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        if (kk < dpk) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int off = kk * 16 * SPITCH + np * 16 + boff;
#pragma unroll
            for (int pc = 0; pc < 3; ++pc) {
              uint32_t gb[4];
              mma::ldmatrix_x4_trans(gb, G3 + pc * HP + off);
              mma::mma_bf16(de[2 * np], xa[kk], gb[0], gb[1]);
              mma::mma_bf16(de[2 * np + 1], xa[kk], gb[2], gb[3]);
            }
          }
        }
      // dt_i z_i into the sum of dB; v_i = B_i . z_i over these columns
      const float qa = expf(cum_last - cum_a);
      const float qb = expf(cum_last - cum_b);
      const float da = dtv[ia];
      const float db = dtv[ib];
      float va = 0.f, vb2 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool up = e >= 2;
          const int i = up ? ib : ia;
          const int off = i * SPITCH + nt * 8 + 2 * t + (e & 1);
          const float z = di[nt][e] + (up ? qb : qa) * de[nt][e];
          dbs[nt][e] += (up ? db : da) * z;
          const float bv = (__bfloat162float(B3[off]) +
                            __bfloat162float(B3[BP + off])) +
                           __bfloat162float(B3[2 * BP + off]);
          if (up)
            vb2 = fmaf(bv, z, vb2);
          else
            va = fmaf(bv, z, va);
        }
      va += __shfl_xor_sync(0xffffffffu, va, 1);
      va += __shfl_xor_sync(0xffffffffu, va, 2);
      vb2 += __shfl_xor_sync(0xffffffffu, vb2, 1);
      vb2 += __shfl_xor_sync(0xffffffffu, vb2, 2);
      if (t == 0 && ia < nv) vs[(row + ia) * nrv + sl] = va;
      if (t == 0 && ib < nv) vs[(row + ib) * nrv + sl] = vb2;
    }
  }

  // the head sums, rows below nv and columns below N
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >= 2 ? ib : ia;
      const int n = n0 + nt * 8 + 2 * t + (e & 1);
      if (i >= nv || n >= N) continue;
      const long long o = ((long long)b * S + t0 + i) * N + n;
      dC[o] = dcs[nt][e];
      dB[o] = dbs[nt][e];
    }
}

// ddt and dA from the columns' r and v: a block a head, a warp a batch row
// (FIN_WARPS rows at once); S in tiles of 32 steps from the last, a lane a
// step, the suffix sums in a tile a fixed shuffle scan.
__global__ void __launch_bounds__(32 * FIN_WARPS)
ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ rs, const float* __restrict__ vs,
               float* __restrict__ ddt, float* __restrict__ dA, int bsz,
               int nh, int S, int nsl) {
  __shared__ float part[FIN_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.x;
  const float a_h = A[h];
  const int tiles = (S + 31) / 32;
  float total = 0.f;                         // thread 0: the rows' dA
  for (int b0 = 0; b0 < bsz; b0 += FIN_WARPS) {
    const int b = b0 + warp;
    float dA_b = 0.f;
    if (b < bsz) {                           // uniform over the warp
      const long long bh = (long long)b * nh + h;
      const float* rr = rs + bh * S * nsl;
      const float* vv = vs + bh * S * nsl;
      const float* dtr = dt + bh * S;
      // step k's r (its columns summed in order), v and dt
      auto fetch = [&](int k, float& r, float& v, float& d) {
        r = v = d = 0.f;
        if (k < S) {
          for (int q = 0; q < nsl; ++q) {
            r += rr[(long long)k * nsl + q];
            v += vv[(long long)k * nsl + q];
          }
          d = dtr[k];
        }
      };
      float R = 0.f, Wt = 0.f;               // the sums past this tile
      float dA_l = 0.f;
      float r, v, d;
      fetch((tiles - 1) * 32 + lane, r, v, d);
      for (int tl = tiles - 1; tl >= 0; --tl) {
        float rn = 0.f, vn = 0.f, dn = 0.f;  // the next tile, in flight
        if (tl > 0) fetch((tl - 1) * 32 + lane, rn, vn, dn);
        float rsum = r, wsum = d * v;        // suffix sums over the lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float ro = __shfl_down_sync(0xffffffffu, rsum, off);
          const float wo = __shfl_down_sync(0xffffffffu, wsum, off);
          if (lane + off < 32) {
            rsum += ro;
            wsum += wo;
          }
        }
        const int k = tl * 32 + lane;
        const float sd = (R + rsum) - (Wt + wsum);
        if (k < S) {
          ddt[bh * S + k] = fmaf(a_h, sd, v);
          dA_l = fmaf(d, sd, dA_l);
        }
        R += __shfl_sync(0xffffffffu, rsum, 0);
        Wt += __shfl_sync(0xffffffffu, wsum, 0);
        r = rn;
        v = vn;
        d = dn;
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        dA_l += __shfl_down_sync(0xffffffffu, dA_l, off);
      dA_b = dA_l;
    }
    if (lane == 0) part[warp] = dA_b;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < FIN_WARPS && b0 + w < bsz; ++w) total += part[w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dA[h] = total;
}

template <int L, int P>
int launch_walk(const void* x, const float* dt, const float* A,
                const float* Bm, const float* Cm, const float* h0,
                const void* dy, void* dx, float* hs, float* gs, float* dtc,
                int b, int nh, int S, int dp, int N, int npad, int Q,
                cudaStream_t s) {
  using K = Walk<L, P>;
  static bool attr_set = false;             // idempotent, so a race is benign
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_walk<L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int vb = mma::copy_width(reinterpret_cast<uintptr_t>(x) |
                                 reinterpret_cast<uintptr_t>(dy) |
                                 (unsigned long long)dp * 2);
  dim3 grid(2 * ((dp + P - 1) / P), nh, b);
  ssd_bwd_walk<L, P><<<grid, K::THREADS, K::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, Bm, Cm, h0,
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
      hs, gs, dtc, nh, S, dp, N, npad, Q, vb);
  return (int)cudaGetLastError();
}

template <int L>
int launch_heads(const void* x, const float* Bm, const float* Cm,
                 const void* dy, const float* hs, const float* gs,
                 const float* dtc, float* dB, float* dC, float* rs,
                 float* vs, int b, int nh, int S, int dp, int N, int npad,
                 cudaStream_t s) {
  using K = Heads<L>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_heads<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int vb = mma::copy_width(reinterpret_cast<uintptr_t>(x) |
                                 reinterpret_cast<uintptr_t>(dy) |
                                 (unsigned long long)dp * 2);
  dim3 grid(npad / SCOLS, (S + L - 1) / L, b);
  ssd_bwd_heads<L><<<grid, K::THREADS, K::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x), Bm, Cm,
      static_cast<const __nv_bfloat16*>(dy), hs, gs, dtc, dB, dC, rs, vs, nh,
      S, dp, N, npad, vb);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx (b, nh, S, dp) contiguous float32; dt, ddt (b, nh, S), A, dA
// (nh,), B, C, dB, dC (b, S, N) contiguous float32; h0 (b, nh, dp, N)
// float32 or null (the forward started from 0); dB_h, dC_h (b, nh, S, N)
// and dA_h (b, nh) float32 scratch for the per-head partials.  rows is
// ssd_scan.py::bwd_rows(dp): 16, 32 or 64, at least dp; N <= 128.  dtype
// must be 0 (float32): bf16 runs repro_ssd_scan_bwd_tc.  Writes dx, ddt,
// dA, dB, dC.  Returns cudaGetLastError().
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* h0,
                                  const void* dy, void* dx, void* ddt,
                                  void* dA, void* dB, void* dC, void* dB_h,
                                  void* dC_h, void* dA_h, int b, int nh,
                                  int S, int dp, int N, int dtype, int rows,
                                  void* stream) {
  if (b <= 0 || nh <= 0 || S <= 0 || dp <= 0 || dp > rows || N <= 0 ||
      N > THREADS || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dBh = static_cast<float*>(dB_h);
  float* dCh = static_cast<float*>(dC_h);
  float* dAh = static_cast<float*>(dA_h);
  const int rc = dispatch<float>(
      rows, x, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(h0), dy, dx, static_cast<float*>(ddt), dBh,
      dCh, dAh, b, nh, S, dp, N, s);
  if (rc != 0) return rc;
  const long long total = (long long)b * S * N;
  long long blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 4096) blocks = 4096;
  ssd_bwd_reduce<<<(unsigned)blocks, REDUCE_THREADS, 0, s>>>(
      dBh, dCh, dAh, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), b, nh, S, N);
  return (int)cudaGetLastError();
}

// The bf16 design.  x, dy, dx (b, nh, S, dp) contiguous bfloat16; dt, ddt,
// A, dA, B, C, dB, dC, h0 as above; dp <= 64, N <= 128.  chunk, walk and
// cols are ssd_scan.py::plan_bwd's Q (the kept states' and the heads pass's
// steps), L (the walks' steps) and P (rows of dp a walk block): (Q, L, P)
// in {(128, 64, 64), (128, 64, 32), (64, 64, 64)}.  npad is
// N rounded up to SCOLS (32).  Scratch, float32: hs and gs (b, nh,
// ceil(S / Q), dp, npad), the kept states; dtc (2, b, nh, ceil(S / Q) Q),
// dt and cum of the Q steps; rs and vs (b, nh, S, npad / SCOLS), r and v by
// columns.  Writes dx, ddt, dA, dB, dC in three launches.  Returns
// cudaGetLastError().
extern "C" int repro_ssd_scan_bwd_tc(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* h0, const void* dy, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* hs, void* gs, void* dtc, void* rs,
    void* vs, int b, int nh, int S, int dp, int N, int chunk, int walk,
    int cols, int npad, void* stream) {
  if (b <= 0 || nh <= 0 || S <= 0 || dp <= 0 || dp > DPMAX || N <= 0 ||
      N > NMAX || npad < N || npad > NMAX || npad % SCOLS != 0 ||
      b > 65535 || nh > 65535 || (S + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* h0f = static_cast<const float*>(h0);
  float* hsf = static_cast<float*>(hs);
  float* gsf = static_cast<float*>(gs);
  float* dtcf = static_cast<float*>(dtc);
  float* rsf = static_cast<float*>(rs);
  float* vsf = static_cast<float*>(vs);
  int rc = (int)cudaErrorInvalidValue;
#define REPRO_SSD_WALK(QQ, LL, PP)                                           \
  if (chunk == QQ && walk == LL && cols == PP)                               \
    rc = launch_walk<LL, PP>(x, dtf, Af, Bf, Cf, h0f, dy, dx, hsf, gsf,      \
                             dtcf, b, nh, S, dp, N, npad, QQ, s)
  REPRO_SSD_WALK(128, 64, 64);
  REPRO_SSD_WALK(128, 64, 32);
  REPRO_SSD_WALK(64, 64, 64);
#undef REPRO_SSD_WALK
  if (rc != 0) return rc;
  if (chunk == 128)
    rc = launch_heads<128>(x, Bf, Cf, dy, hsf, gsf, dtcf,
                           static_cast<float*>(dB), static_cast<float*>(dC),
                           rsf, vsf, b, nh, S, dp, N, npad, s);
  else
    rc = launch_heads<64>(x, Bf, Cf, dy, hsf, gsf, dtcf,
                          static_cast<float*>(dB), static_cast<float*>(dC),
                          rsf, vsf, b, nh, S, dp, N, npad, s);
  if (rc != 0) return rc;
  ssd_bwd_finish<<<nh, 32 * FIN_WARPS, 0, s>>>(
      dtf, Af, rsf, vsf, static_cast<float*>(ddt), static_cast<float*>(dA), b,
      nh, S, npad / SCOLS);
  return (int)cudaGetLastError();
}
