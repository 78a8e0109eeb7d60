// quant_matmul: w8a16 matrix product with the dequantization fused, on
// Hopper.
//
// Replaces src/repro/kernels/quant_matmul.py::quant_matmul (the Pallas
// kernel behind ops.quant_matmul), which runs every weight projection and the
// LM head of an int8-resident (compute_quant) model: 7 per layer plus the
// head in every forward, prefill and decode step (src/repro/quant.py:103-115).
//
// What it computes: out (M, N) = x (M, K) . (w (K, N) int8 as f32 * scale (N,)
// f32), the f32 products summed in f32 and written in the output type
// (src/repro/kernels/ref.py:214-227).  Each weight element is dequantized in
// registers (float(w) * scale[n], the reference's own rounding); no
// dequantized copy of the weight exists in global memory.
//
// What bounds it on an H100: at decode (M = 1 .. a few rows) it is a GEMV and
// the bound is the int8 weight bytes (the smollm-360m head, 960 x 49152, is
// 47.2 MB or 14.1 us at 3.35 TB/s); at a 128-token prefill the 2*M*K*N
// operations start to count.  This first kernel runs plain FMA on the CUDA
// cores (no mma.sync, wgmma or TMA).
//
// What the design does: one block of 256 threads owns BM = 4 rows and a
// column tile.  Its threads are CT column threads by 256 / CT k-groups: each
// thread holds VN = 8 neighbouring columns, so a k-row of the row-major int8
// weight is read as 8 bytes a thread, neighbouring threads on neighbouring
// addresses (one 8-byte load where N % 8 == 0 and the pointer is aligned,
// else bounded byte loads).  The x rows of the tile are staged in shared
// memory as f32, 256 k at a time.  CT is 32 for wide weights (the head) and 8
// for narrow ones, so a 960-column projection still spreads over 15 blocks.
// M, K and N are ragged: the kernel masks its own edges, nothing is padded.
//
// Row independence: every output element is summed in one fixed order that
// does not depend on M or on where its row sits in the tile: k-group g adds
// its k = g, g + KG, ... in increasing order (KG = 256 / CT, fixed by N), and
// the KG partial sums are then added in group order.  So a row's result is the
// same at B = 1 and B = n_slots, which the continuous-batching scheduler
// needs.  (cuBLAS and PyTorch's reductions make no such promise.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 4;         // rows of x per block
constexpr int VN = 8;         // columns per thread
constexpr int TKC = 256;      // k staged in shared memory per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TX, typename TO, int CT, bool VEC>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
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
                      ? to_f32(x[(long long)(m0 + m) * K + k0 + kk])
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

template <typename TX, typename TO, int CT>
int launch_ct(const void* x, const void* w, const void* scale, void* out,
              int M, int K, int N, bool vec, cudaStream_t s) {
  dim3 grid((N + CT * VN - 1) / (CT * VN), (M + BM - 1) / BM);
  const TX* xp = static_cast<const TX*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  TO* op = static_cast<TO*>(out);
  if (vec)
    qmm_kernel<TX, TO, CT, true><<<grid, THREADS, 0, s>>>(xp, wp, sp, op, M,
                                                           K, N);
  else
    qmm_kernel<TX, TO, CT, false><<<grid, THREADS, 0, s>>>(xp, wp, sp, op, M,
                                                            K, N);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K, int N, cudaStream_t s) {
  const bool vec =
      N % VN == 0 && (reinterpret_cast<uintptr_t>(w) & (VN - 1)) == 0;
  if (N >= 8192)
    return launch_ct<TX, TO, 32>(x, w, scale, out, M, K, N, vec, s);
  return launch_ct<TX, TO, 8>(x, w, scale, out, M, K, N, vec, s);
}

}  // namespace

// x (M, K), w (K, N) int8, scale (N,) f32, out (M, N), all contiguous.
// x_kind / out_kind: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int repro_quant_matmul(const void* x, const void* w,
                                  const void* scale, void* out, int M, int K,
                                  int N, int x_kind, int out_kind,
                                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0 && out_kind == 0)
    return launch<float, float>(x, w, scale, out, M, K, N, s);
  if (x_kind == 0 && out_kind == 1)
    return launch<float, __nv_bfloat16>(x, w, scale, out, M, K, N, s);
  if (x_kind == 1 && out_kind == 0)
    return launch<__nv_bfloat16, float>(x, w, scale, out, M, K, N, s);
  if (x_kind == 1 && out_kind == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, out, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
