// quant_matmul: w8a16 matrix product with the dequantization fused, on
// Hopper.
//
// Replaces src/repro/kernels/quant_matmul.py::quant_matmul (the Pallas
// kernel behind ops.quant_matmul), which runs every weight projection and the
// LM head of an int8-resident (compute_quant) model: 7 per layer plus the
// head in every forward, prefill and decode step (src/repro/quant.py:103-115).
//
// What it computes: out (M, N) = x (M, K) . (w (K, N) int8 * scale (N,) f32),
// summed in f32 and written in the output type
// (src/repro/kernels/ref.py:214-227).  No dequantized copy of the weight
// exists in global memory; the int8 weight is read as it lies, (K, N)
// row-major.
//
// What bounds it on an H100: at decode (M = 1 .. a few rows) it is a GEMV
// and the bound is the int8 weight bytes (the smollm-360m head, 960 x 49152,
// is 47.2 MB or 14.1 us at 3.35 TB/s); at a 128-token prefill the 2 M K N
// operations count too (629 MFLOP for 960 x 2560, 0.64 us at the bf16
// tensor-core peak, against 0.73 us of bytes).
//
// bf16 x: tensor cores, fed by cp.async.
//  * Exact products, scale last.  |w| <= 127 is exact in bf16, so each
//    product x . w is exact in f32; the sum over k runs on the tensor cores
//    (mma.sync m16n8k16, bf16 in, f32 accumulate) and scale[n] multiplies
//    the f32 sum once, in the epilogue.  In exact arithmetic that is the
//    reference's x . (w * s).
//  * Operands swapped: out^T = w^T . x^T, so the weight's N fills the
//    instruction's 16 rows and the (few) rows of x its 8 columns.  A warp
//    owns 32 weight columns (two 16-row A tiles), a block of 4 warps 128
//    columns and BM rows of x: 8 up to 16 rows (decode), else 32.
//  * The int8 weight tile (64 k-rows x 128 columns a stage at decode, 32 at
//    prefill) and the x tile come in by cp.async, 16 bytes a thread, through
//    a ring of 4 stages.  ldmatrix.trans, reading int8 pairs as b16, hands
//    each thread the k-rows 2t, 2t+1 (and 2t+8, 2t+9) of columns 2g, 2g+1;
//    one byte permute per column makes a word of its 4 k, and the exact
//    byte-permute conversion of mma.cuh (no cvt) turns it into the two
//    bf16 pairs of the A fragment.  A-tile row g is column 16i + 2g, row
//    g + 8 column 16i + 2g + 1, so c[0] and c[2] are neighbours in the
//    output and leave as one paired store.  Rows are padded by 16 bytes,
//    so ldmatrix's row addresses fall in distinct banks.
//  * A fixed split over K, chosen from (K, N) alone by quant_matmul.py::plan
//    (slices of slice_k, a multiple of 16): each slice is summed by its own
//    chain of mma from zero, and the slice sums are added in slice order.
//    When the (N, M) tiles alone leave SMs idle (decode: 960 x 320 has 3
//    column tiles), each slice runs in its own block and writes an f32
//    partial to a scratch the wrapper allocates; a second small pass adds
//    them in slice order, times the scale, launched as a programmatic
//    dependent so its launch overlaps the product's tail.  Otherwise one
//    block adds its slices in the same order itself.  No atomics.  (Adding
//    the partials in a thread-block cluster instead was slower on the card;
//    see PERF.md.)
//
// Row independence: an output element depends only on its row of x, its
// column of w and the plan; the instruction, the k order within a slice and
// the slices are fixed by (K, N), and M only decides how many row tiles run
// and whether slices run in one block or in many (the same additions in the
// same order).  So a row's result is the same at B = 1 and at B = n_slots,
// which the continuous-batching scheduler needs.
//
// f32 x keeps the first design (plain FMA, full f32; TF32 would not hold
// the card-vs-CPU checks): one block of 256 threads owns 4 rows and a column
// tile, each thread 8 neighbouring columns, each weight element dequantized
// in registers (float(w) * scale[n], the reference's own rounding), k-group g
// adding k = g, g + KG, ... in increasing order and the groups added in
// group order.
//
// M, K and N are ragged: both designs mask their own edges.  A weight or x
// that is not 16-byte aligned by rows is staged by plain loads instead of
// cp.async (never on the model's path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// o[0] = a and, where `two`, o[1] = b: one paired store where `vec` (o is
// then aligned to the pair)
__device__ __forceinline__ void put2(float* o, float a, float b, bool vec,
                                     bool two) {
  if (vec) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    o[0] = a;
    if (two) o[1] = b;
  }
}
__device__ __forceinline__ void put2(__nv_bfloat16* o, float a, float b,
                                     bool vec, bool two) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16_rn(a);
    if (two) o[1] = __float2bfloat16_rn(b);
  }
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps
constexpr int KSTEP = 16;         // k per mma

// One configuration of the tensor-core kernel: BM rows of x and TILE_N
// weight columns per block (32 a warp), SR k-rows per cp.async stage, ST
// stages in the ring.
template <int BM_, int SR_, int ST_>
struct Cfg {
  static constexpr int BM = BM_, SR = SR_, ST = ST_;
  static constexpr int TILE_N = 128;
  static constexpr int WPITCH = TILE_N + 16;     // bytes per weight row
  static constexpr int XPITCH = SR + 8;          // bf16 per x row
  static constexpr int W_STAGE = SR * WPITCH;    // bytes
  static constexpr int X_STAGE = BM * XPITCH * 2;
  static constexpr int SMEM = ST * (W_STAGE + X_STAGE);
  static_assert(SR % KSTEP == 0 && BM % 8 == 0, "tile shape");
  static_assert(SMEM <= 48 * 1024, "dynamic shared memory without opt-in");
};

template <typename C>
__device__ __forceinline__ void tc_load(unsigned char* smem, int slot, int k0,
                                        int ke,
                                        const __nv_bfloat16* __restrict__ x,
                                        const int8_t* __restrict__ w, int M,
                                        int K, int N, int m0, int n0,
                                        bool wvec, bool xvec) {
  int8_t* ws = reinterpret_cast<int8_t*>(smem) + slot * C::W_STAGE;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      smem + C::ST * C::W_STAGE + slot * C::X_STAGE);
  // weight: SR rows of TILE_N bytes; a thread keeps one 16-byte column
  // chunk and walks rows 128 / WCH apart
  constexpr int WCH = C::TILE_N / 16;            // 16-byte chunks per row
  constexpr int RSTEP = TC_THREADS / WCH;
  static_assert(TC_THREADS % WCH == 0 && C::SR % RSTEP == 0, "loader");
  const int ch = threadIdx.x % WCH;
  const int gn = n0 + ch * 16;
  const int8_t* src = w + (long long)(k0 + threadIdx.x / WCH) * N + gn;
  int8_t* dst = ws + (threadIdx.x / WCH) * C::WPITCH + ch * 16;
#pragma unroll
  for (int r = 0; r < C::SR / RSTEP; ++r) {
    const int gk = k0 + threadIdx.x / WCH + r * RSTEP;
    if (wvec) {
      const bool ok = gk < ke && gn < N;
      mma::cp_async16(dst, ok ? src : w, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (gk < ke && gn + e < N) ? src[e] : (int8_t)0;
    }
    src += (long long)RSTEP * N;
    dst += RSTEP * C::WPITCH;
  }
  constexpr int XCH = C::SR / 8;                 // 16-byte chunks per row
  for (int c = threadIdx.x; c < C::BM * XCH; c += TC_THREADS) {
    const int row = c / XCH;
    const int xc = c % XCH;
    const int gm = m0 + row;
    const int gk = k0 + xc * 8;
    __nv_bfloat16* xd = xs + row * C::XPITCH + xc * 8;
    if (xvec) {
      const bool ok = gm < M && gk < ke;
      mma::cp_async16(xd, ok ? x + (long long)gm * K + gk : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        xd[e] = (gm < M && gk + e < ke) ? x[(long long)gm * K + gk + e]
                                        : __float2bfloat16_rn(0.f);
    }
  }
}

// grid: (N / TILE_N column tiles, M / BM row tiles, k groups).  With one k
// group a block adds all n_slices slices in order and writes out; with
// n_slices groups block z sums slice z into part[z] (M, N) f32.
template <typename C, typename TO>
__global__ void __launch_bounds__(TC_THREADS)
qmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ w, const float* __restrict__ scale,
              TO* __restrict__ out, float* __restrict__ part, int M, int K,
              int N, int slice_k, int n_slices, int wvec, int xvec) {
  constexpr int MT = C::BM / 8;              // 8-row B tiles
  constexpr int ST = C::ST;
  constexpr int KS = C::SR / KSTEP;          // mma steps per stage
  extern __shared__ __align__(16) unsigned char smem[];
  // the reduce pass (if any) may launch now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * C::TILE_N;
  const int m0 = blockIdx.y * C::BM;
  const bool split = gridDim.z > 1;
  const int s_begin = split ? blockIdx.z : 0;
  const int s_end = split ? blockIdx.z + 1 : n_slices;
  const int kb = s_begin * slice_k;
  const int ke = min(K, s_end * slice_k);
  const int nsteps = (ke - kb + KSTEP - 1) / KSTEP;     // mma steps
  const int nstages = (ke - kb + C::SR - 1) / C::SR;
  const int sps = slice_k / KSTEP;                     // steps per slice

  float acc[2][MT][4];
  float tot[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nstages)
      tc_load<C>(smem, s, kb + s * C::SR, ke, x, w, M, K, N, m0, n0, wvec,
                 xvec);
    mma::cp_commit();
  }

  // ldmatrix lane roles: matrix j = lane / 8, its row lane % 8.  Weight
  // (.trans, int8 pairs as b16): matrices (k 0-7 | 8-15) x (n 0-15 | 16-31)
  // of a strip; x: matrices (m 0-7 | 8-15) x (k 0-7 | 8-15)
  const int lj = lane >> 3;
  const int lr = lane & 7;
  const int w_lane = ((lj & 1) * 8 + lr) * C::WPITCH + (lj >> 1) * 16 +
                     warp * 32;
  const int x_lane = ((lj >> 1) * 8 + lr) * C::XPITCH + (lj & 1) * 8;

  int step = 0;                              // mma steps done
  int left = sps;                            // steps left in this slice
  bool first = true;                         // in the block's first slice
  for (int st = 0; st < nstages; ++st) {
    mma::cp_wait<ST - 2>();
    __syncthreads();                         // stage st landed; st-1 consumed
    {
      const int nxt = st + ST - 1;
      if (nxt < nstages)
        tc_load<C>(smem, nxt % ST, kb + nxt * C::SR, ke, x, w, M, K, N, m0,
                   n0, wvec, xvec);
      mma::cp_commit();
    }
    const int slot = st % ST;
    const unsigned char* ws = smem + slot * C::W_STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + ST * C::W_STAGE + slot * C::X_STAGE);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (step >= nsteps) break;
      // B fragments: x rows 8j + g, k 2t, 2t+1 and 2t+8, 2t+9
      uint32_t b[MT][2];
      if constexpr (MT == 1) {
        const __nv_bfloat16* xr = xs + g * C::XPITCH + ks * KSTEP;
        b[0][0] = *reinterpret_cast<const uint32_t*>(xr + 2 * t);
        b[0][1] = *reinterpret_cast<const uint32_t*>(xr + 2 * t + 8);
      } else {
#pragma unroll
        for (int j = 0; j < MT; j += 2) {
          uint32_t r[4];
          mma::ldmatrix_x4(r, xs + j * 8 * C::XPITCH + x_lane + ks * KSTEP);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
      }
      // r[0] = k 2t, 2t+1 of columns 2g, 2g+1 (bytes k2t.n, k2t.n+1,
      // k2t+1.n, k2t+1.n+1); r[1] the same at k + 8; r[2], r[3] columns
      // 16 + 2g, 16 + 2g + 1
      uint32_t r[4];
      mma::ldmatrix_x4_trans(r, ws + ks * KSTEP * C::WPITCH + w_lane);
      // one word per column: (k 2t, 2t+1, 2t+8, 2t+9)
      uint32_t lo[4], hi[4];
      mma::i8x4_to_bf16x4(__byte_perm(r[0], r[1], 0x6420), lo[0], hi[0]);
      mma::i8x4_to_bf16x4(__byte_perm(r[0], r[1], 0x7531), lo[1], hi[1]);
      mma::i8x4_to_bf16x4(__byte_perm(r[2], r[3], 0x6420), lo[2], hi[2]);
      mma::i8x4_to_bf16x4(__byte_perm(r[2], r[3], 0x7531), lo[3], hi[3]);
      // A tile i: row g = column 16i + 2g, row g + 8 = column 16i + 2g + 1
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        mma::mma_bf16(acc[0][j], a0, b[j][0], b[j][1]);
        mma::mma_bf16(acc[1][j], a1, b[j][0], b[j][1]);
      }
      ++step;
      if (--left == 0 || step == nsteps) {       // a slice is complete
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[i][j][e] = first ? acc[i][j][e] : tot[i][j][e] + acc[i][j][e];
              acc[i][j][e] = 0.f;
            }
        first = false;
        left = sps;
      }
    }
  }
  mma::cp_wait<0>();

  // c[0], c[2] of tile i, B tile j: x row 8j + 2t, weight columns n and
  // n + 1 (n = 32 warp + 16i + 2g), side by side in the output; c[1], c[3]
  // the same at row 8j + 2t + 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + warp * 32 + 16 * i + 2 * g;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const bool vec = two && (N & 1) == 0;
    const float s0 = split ? 0.f : __ldg(scale + n);
    const float s1 = split || !two ? 0.f : __ldg(scale + n + 1);
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * t + h;
        if (m >= M) continue;
        const float v0 = tot[i][j][h];
        const float v1 = tot[i][j][h + 2];
        if (split)
          put2(part + ((long long)blockIdx.z * M + m) * N + n, v0, v1, vec,
               two);
        else
          put2(out + (long long)m * N + n, v0 * s0, v1 * s1, vec, two);
      }
  }
}

// out = (part[0] + part[1] + ... in slice order) * scale[n], VEC elements
// a thread (4 where N % 4 == 0: one float4 of each partial).  Launched as a
// programmatic dependent of the product kernel, so its launch overlaps the
// product's tail; griddepcontrol.wait holds it until the partials are
// complete and visible.
template <typename TO, int VEC>
__global__ void __launch_bounds__(256)
qmm_reduce_kernel(const float* __restrict__ part,
                  const float* __restrict__ scale, TO* __restrict__ out,
                  long long MN, int N, int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * VEC;
  if (i >= MN) return;
  if constexpr (VEC == 4) {
    float4 a = *reinterpret_cast<const float4*>(part + i);
    for (int z = 1; z < splits; ++z) {
      const float4 b = *reinterpret_cast<const float4*>(part + z * MN + i);
      a.x = a.x + b.x;
      a.y = a.y + b.y;
      a.z = a.z + b.z;
      a.w = a.w + b.w;
    }
    const float4 sc =
        *reinterpret_cast<const float4*>(scale + (int)(i % N));
    put2(out + i, a.x * sc.x, a.y * sc.y, true, true);
    put2(out + i + 2, a.z * sc.z, a.w * sc.w, true, true);
  } else {
    float a = part[i];
    for (int z = 1; z < splits; ++z) a = a + part[z * MN + i];
    put(out + i, a * __ldg(scale + (int)(i % N)));
  }
}

template <typename TO>
int launch_reduce(const float* part, const float* scale, TO* out, int M,
                  int N, int splits, cudaStream_t s) {
  const long long mn = (long long)M * N;
  const bool vec =
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(scale) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((unsigned)((mn / (vec ? 4 : 1) + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = vec ? cudaLaunchKernelEx(&cfg, qmm_reduce_kernel<TO, 4>,
                                           part, scale, out, mn, N, splits)
                      : cudaLaunchKernelEx(&cfg, qmm_reduce_kernel<TO, 1>,
                                           part, scale, out, mn, N, splits);
  return (int)e;
}

template <typename C, typename TO>
int run_tc(const void* x, const void* w, const void* scale, void* out,
           void* part, int M, int K, int N, int slice_k, int n_slices,
           int groups, bool wvec, bool xvec, cudaStream_t s) {
  dim3 grid((N + C::TILE_N - 1) / C::TILE_N, (M + C::BM - 1) / C::BM,
            groups);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  qmm_tc_kernel<C, TO><<<grid, TC_THREADS, C::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<TO*>(out),
      static_cast<float*>(part), M, K, N, slice_k, n_slices, wvec, xvec);
  return (int)cudaGetLastError();
}

// bm (quant_matmul.py::launch_shape) picks the tile: 8 rows with 64 k-rows
// a stage at decode, 32 rows with 32 k-rows a stage at prefill
template <typename TO>
int launch_tc(const void* x, const void* w, const void* scale, void* out,
              void* part, int M, int K, int N, int slice_k, int n_slices,
              int bm, int groups, cudaStream_t s) {
  if (slice_k <= 0 || slice_k % KSTEP ||
      (long long)(n_slices - 1) * slice_k >= K ||
      (long long)n_slices * slice_k < K || (groups != 1 && groups != n_slices)
      || (groups > 1 && part == nullptr) || groups > 65535)
    return (int)cudaErrorInvalidValue;
  const bool wvec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool xvec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  int rc;
  if (bm == 8)
    rc = run_tc<Cfg<8, 64, 4>, TO>(x, w, scale, out, part, M, K, N, slice_k,
                                   n_slices, groups, wvec, xvec, s);
  else if (bm == 32)
    rc = run_tc<Cfg<32, 32, 4>, TO>(x, w, scale, out, part, M, K, N, slice_k,
                                    n_slices, groups, wvec, xvec, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0 || groups == 1) return rc;
  return launch_reduce<TO>(static_cast<const float*>(part),
                           static_cast<const float*>(scale),
                           static_cast<TO*>(out), M, N, groups, s);
}

// ---------------------------------------------------------------------------
// f32 x: FMA on the CUDA cores (the first design)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int BM = 4;         // rows of x per block
constexpr int VN = 8;         // columns per thread
constexpr int TKC = 256;      // k staged in shared memory per pass

template <typename TO, int CT, bool VEC>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, TO* __restrict__ out, int M,
           int K, int N) {
  constexpr int KG = THREADS / CT;     // k-groups
  constexpr int BN = CT * VN;          // columns per block
  static_assert(TKC % KG == 0, "k-groups must divide the staged chunk");
  __shared__ float xs[BM][TKC];
  __shared__ float red[KG][BM][BN];

  const int tid = threadIdx.x;
  const int c = tid % CT;
  const int g = tid / CT;
  const int n0 = blockIdx.x * BN + c * VN;
  const int m0 = blockIdx.y * BM;

  float s[VN];
#pragma unroll
  for (int v = 0; v < VN; ++v) s[v] = n0 + v < N ? __ldg(scale + n0 + v) : 0.f;
  float acc[BM][VN];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < VN; ++v) acc[m][v] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TKC) {
    const int kc = min(TKC, K - k0);
    __syncthreads();                     // previous chunk consumed
    for (int i = tid; i < BM * TKC; i += THREADS) {
      const int m = i / TKC;
      const int kk = i % TKC;
      xs[m][kk] = (m0 + m < M && kk < kc)
                      ? x[(long long)(m0 + m) * K + k0 + kk]
                      : 0.f;
    }
    __syncthreads();
    if (n0 < N) {
#pragma unroll 4
      for (int kk = g; kk < kc; kk += KG) {
        const int8_t* wr = w + (long long)(k0 + kk) * N + n0;
        float wf[VN];
        if (VEC) {
          const int2 raw = __ldg(reinterpret_cast<const int2*>(wr));
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int v = 0; v < VN; ++v) wf[v] = (float)b[v] * s[v];
        } else {
#pragma unroll
          for (int v = 0; v < VN; ++v)
            wf[v] = n0 + v < N ? (float)wr[v] * s[v] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int v = 0; v < VN; ++v) acc[m][v] = fmaf(xv, wf[v], acc[m][v]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < VN; ++v) red[g][m][c * VN + v] = acc[m][v];
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN;
    const int nn = i % BN;
    const int n = blockIdx.x * BN + nn;
    if (m0 + m < M && n < N) {
      float t = 0.f;
#pragma unroll
      for (int gg = 0; gg < KG; ++gg) t += red[gg][m][nn];
      put(out + (long long)(m0 + m) * N + n, t);
    }
  }
}

template <typename TO, int CT>
int launch_ct(const void* x, const void* w, const void* scale, void* out,
              int M, int K, int N, bool vec, cudaStream_t s) {
  dim3 grid((N + CT * VN - 1) / (CT * VN), (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  TO* op = static_cast<TO*>(out);
  if (vec)
    qmm_kernel<TO, CT, true><<<grid, THREADS, 0, s>>>(xp, wp, sp, op, M, K,
                                                       N);
  else
    qmm_kernel<TO, CT, false><<<grid, THREADS, 0, s>>>(xp, wp, sp, op, M, K,
                                                        N);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_fma(const void* x, const void* w, const void* scale, void* out,
               int M, int K, int N, cudaStream_t s) {
  const bool vec =
      N % VN == 0 && (reinterpret_cast<uintptr_t>(w) & (VN - 1)) == 0;
  if (N >= 8192) return launch_ct<TO, 32>(x, w, scale, out, M, K, N, vec, s);
  return launch_ct<TO, 8>(x, w, scale, out, M, K, N, vec, s);
}

}  // namespace

// x (M, K), w (K, N) int8, scale (N,) f32, out (M, N), all contiguous.
// x_kind / out_kind: 0 = float32, 1 = bfloat16.  bf16 x runs on the tensor
// cores with the plan of quant_matmul.py::plan: slices of slice_k (n_slices
// of them cover K), bm rows of x per block (8 or 32) and groups = 1 (one
// block adds all slices) or n_slices (one block per slice, partials in
// part, n_slices x M x N f32).  f32 x runs the FMA design and ignores the
// plan.  Returns cudaGetLastError().
extern "C" int repro_quant_matmul(const void* x, const void* w,
                                  const void* scale, void* out, void* part,
                                  int M, int K, int N, int x_kind,
                                  int out_kind, int slice_k, int n_slices,
                                  int bm, int groups, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0 && out_kind == 0)
    return launch_fma<float>(x, w, scale, out, M, K, N, s);
  if (x_kind == 0 && out_kind == 1)
    return launch_fma<__nv_bfloat16>(x, w, scale, out, M, K, N, s);
  if (x_kind == 1 && out_kind == 0)
    return launch_tc<float>(x, w, scale, out, part, M, K, N, slice_k,
                            n_slices, bm, groups, s);
  if (x_kind == 1 && out_kind == 1)
    return launch_tc<__nv_bfloat16>(x, w, scale, out, part, M, K, N,
                                    slice_k, n_slices, bm, groups, s);
  return (int)cudaErrorInvalidValue;
}
