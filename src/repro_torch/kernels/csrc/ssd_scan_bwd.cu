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
// the kernel uses the identity (h_k = (a_{t+1} .. a_k) h_t + the inputs
// after t, summed against dh_k):
//   <h_t, dh_t> = R_t - W_{t+1},  R_t = sum_{k>=t} r_k,  r_k = dy_k . y_k
//                                 W_t = sum_{k>=t} dt_k v_k,
// so a_t <h_{t-1}, dh_t> = <h_t - dt_t x_t B_t^T, dh_t> = R_t - W_t, and
// r_k = dy_k . (h_k C_k) = C_k . dC_k comes from the forward walk.  Both
// sums are f32 and taken in a fixed order.
//
// What bounds it on an H100: at mamba2-780m's training shape (x (8, 48,
// 512, 64) bf16, N 128) the bytes are about 81 MB (x, dy and dx; the B, C,
// dB and dC rows; 0.024 ms) and the operations about 12 dp N a step and
// head (the state's recompute 5, the reverse state, z and dx 7), 1.9e10,
// 0.29 ms at the f32 rate outside the tensor cores.  This first design
// stays on the CUDA cores, so operations bound it.
//
// What the design does: one block a (batch, head), a thread a column n of
// the state (128 threads; dp <= DPT rows of h in its registers), so the
// sums over dp (dC_t, z_t) stay in the thread.  Pass 1 walks forward from
// h0 and writes dC_t (per head) and r_t; pass 2 walks backward with dh in
// the same registers and writes dB_t (per head), dx_t and ddt_t; the inputs
// of CHUNK steps are staged in shared memory at a time.  dx_t's sum over n
// is a warp's reduce-scatter (a fixed butterfly) and then the four warps in
// order; r_t and v_t likewise.  A second kernel sums dB and dC over the
// heads, and dA over the batch rows, in index order from the per-head
// partials.  No float atomics: a repeated call gives the same bits, and a
// row's bits do not depend on the other rows of the batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // a thread a column n: N <= 128
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;             // steps staged in shared memory at once
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace

// x, dy, dx (b, nh, S, dp) contiguous in one dtype (0 = float32, 1 =
// bfloat16); dt, ddt (b, nh, S), A, dA (nh,), B, C, dB, dC (b, S, N)
// contiguous float32; h0 (b, nh, dp, N) float32 or null (the forward started
// from 0); dB_h, dC_h (b, nh, S, N) and dA_h (b, nh) float32 scratch for the
// per-head partials.  rows is ssd_scan.py::bwd_rows(dp): 16, 32 or 64, at
// least dp; N <= 128.  Writes dx, ddt, dA, dB, dC.  Returns
// cudaGetLastError().
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* h0,
                                  const void* dy, void* dx, void* ddt,
                                  void* dA, void* dB, void* dC, void* dB_h,
                                  void* dC_h, void* dA_h, int b, int nh,
                                  int S, int dp, int N, int dtype, int rows,
                                  void* stream) {
  if (b <= 0 || nh <= 0 || S <= 0 || dp <= 0 || dp > rows || N <= 0 ||
      N > THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* h0f = static_cast<const float*>(h0);
  float* ddtf = static_cast<float*>(ddt);
  float* dBh = static_cast<float*>(dB_h);
  float* dCh = static_cast<float*>(dC_h);
  float* dAh = static_cast<float*>(dA_h);
  int rc;
  if (dtype == 0)
    rc = dispatch<float>(rows, x, dtf, Af, Bf, Cf, h0f, dy, dx, ddtf, dBh,
                         dCh, dAh, b, nh, S, dp, N, s);
  else if (dtype == 1)
    rc = dispatch<__nv_bfloat16>(rows, x, dtf, Af, Bf, Cf, h0f, dy, dx, ddtf,
                                 dBh, dCh, dAh, b, nh, S, dp, N, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  const long long total = (long long)b * S * N;
  long long blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 4096) blocks = 4096;
  ssd_bwd_reduce<<<(unsigned)blocks, REDUCE_THREADS, 0, s>>>(
      dBh, dCh, dAh, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), b, nh, S, N);
  return (int)cudaGetLastError();
}
