// mma.cuh: the Hopper building blocks shared by the tensor-core kernels
// (quant_matmul.cu, flash_attention.cu, decode_attention.cu, ssd_scan.cu):
// asynchronous copies into shared memory (16 bytes, or 8 where a row is
// aligned only so far), ldmatrix fragment loads, the bf16 m16n8k16
// tensor-core product with f32 accumulate, and int8 -> bf16 conversion by
// byte permutes.
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a[0] = rows g,   cols 2t, 2t+1
//                           a[1] = rows g+8, cols 2t, 2t+1
//                           a[2] = rows g,   cols 2t+8, 2t+9
//                           a[3] = rows g+8, cols 2t+8, 2t+9
//   B (16 x 8, "col"):      b[0] = rows 2t, 2t+1,   col g
//                           b[1] = rows 2t+8, 2t+9, col g
//   C (16 x 8, f32):        c[0], c[1] = row g,   cols 2t, 2t+1
//                           c[2], c[3] = row g+8, cols 2t, 2t+1
// Each 32-bit register of A and B holds two bf16, the lower column (A) or
// row (B) in its low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes < 16 zero-fills the
// rest (0: the whole chunk, and nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 8 bytes global -> shared (through L1: .cg takes 16 bytes only),
// zero-filling past src_bytes as cp_async16 does
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The widest copy (16 or 8 bytes; 0: element by element) that every
// source address can take: `bits` ORs the base addresses and the byte
// strides of the rows a kernel reads.
__host__ __device__ __forceinline__ int copy_width(unsigned long long bits) {
  return (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8 : 0;
}

// One 16-byte chunk of a bf16 row into shared memory: where `ok`, its
// first n elements (n <= 0: none) from src and the rest zero; else zeros.
// vb is copy_width() of the rows: one 16-byte copy or two of 8 (src
// aligned to vb; a copy with nothing to read takes `any`, a valid address,
// and only zero-fills), or element by element (vb 0).  So a head
// dim below the instance's padded one is read without a copy of the tensor
// and without reading past a row.  EXACT (n >= 8 and vb 16 wherever ok) is
// the one 16-byte copy and nothing else.
template <bool EXACT>
__device__ __forceinline__ void cp_chunk(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, bool ok,
                                         int n, int vb, const void* any) {
  if constexpr (EXACT) {
    cp_async16(dst, ok ? static_cast<const void*>(src) : any, ok ? 16 : 0);
    return;
  }
  n = !ok || n < 0 ? 0 : (n > 8 ? 8 : n);
  if (vb == 16) {
    cp_async16(dst, n > 0 ? static_cast<const void*>(src) : any, 2 * n);
  } else if (vb == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = n - 4 * h;
      const int bytes = m <= 0 ? 0 : (m >= 4 ? 8 : 2 * m);
      cp_async8(dst + 4 * h,
                bytes ? static_cast<const void*>(src + 4 * h) : any, bytes);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < n ? src[e] : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8j .. 8j+7 give the row addresses of
// matrix j, and register j receives matrix j in the A/B fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// the same, each matrix transposed (for a B operand stored row-major K x N)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 (bytes 0..3 of q) -> two registers of bf16 pairs, exactly:
// lo = (byte 0, byte 1), hi = (byte 2, byte 3).  Each byte, offset by 128
// to an unsigned one, is permuted into the mantissa of 2^23 (0x4B000000),
// so the f32 reads 2^23 + 128 + b; one subtraction leaves b, and since
// |b| <= 128 the top half of that f32 is b in bf16, no rounding.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t q, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) -
                   8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) -
                   8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) -
                   8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

}  // namespace mma
