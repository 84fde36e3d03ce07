// Split-f32 (3xTF32) products on the tensor cores and the cp.async copies
// that feed them, shared by the f32 attention backward (attention_f32.cu)
// and the sigmoid-loss backward (sigmoid_loss.cu).
//
// Each f32 operand x is split into hi = tf32(x) and lo = tf32(x − hi), both
// rounded as cvt.rna.tf32.f32 rounds, and a product adds lo·hi, hi·lo, then
// hi·hi into an f32 accumulator (the small terms first): what is dropped,
// lo·lo and the rounding of lo, is about 2^-22 of each term.

#pragma once

#include <cuda_runtime.h>

namespace split_f32 {

// Asynchronous copies global -> shared; a src_bytes of 0 zero-fills.
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ inline void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ inline void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 explicit significand bits, the low 13 cleared),
// nearest with ties away from zero: bitwise what cvt.rna.tf32.f32 gives for
// finite x, in two integer operations (the conversion made the f32
// attention backward slower on the card).
__device__ inline unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 x): hi = tf32(x), lo = tf32(x − hi) (x − hi is exact).
// A NaN x reaches the products as a NaN, as in an f32 product: tf32_rna
// alone carries the card's NaN (0x7FFFFFFF, what its arithmetic makes) into
// the sign bit and gives −0. Two forms, bitwise the same for every other x
// (an infinite x: hi infinite, lo = tf32_rna(NaN) = −0), which ptxas
// allocates differently: each source takes the one with which none of its
// kernels spills. `split` rounds hi with cvt.rna.tf32.f32, which keeps a
// NaN (sigmoid_loss.cu); `split_nan_lo` rounds hi by the bits and makes lo
// the NaN (attention_f32.cu).
__device__ inline void split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ inline void split_nan_lo(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = isnan(x) ? 0x7FFFFFFFu : tf32_rna(x - __uint_as_float(hi));
}

// d += a · b: one m16n8k8 TF32 product with f32 accumulation. a: rows g and
// g + 8 at k = t, t + 4; b: k = t, t + 4 at column g; d: rows g, g + 8 at
// columns 2t, 2t + 1 (g = lane / 4, t = lane % 4).
__device__ inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace split_f32
