// Helpers shared by the attention kernels (short_attention*.cu, K1-K3, and
// flash_attention*.cu, K7): warp reductions, 16-byte asynchronous copies,
// the tile loader for one head's (s, dh) slice of a (b, s, heads·dh) tensor,
// and the mma.sync m16n8k16 bf16 product with its ldmatrix operand loads and
// fragment-layout helpers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace short_attention {

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + rows) of one head's (s, dh) slice, whose rows lie
// at stride `width` in global memory, into shared memory at row stride `ld`,
// zero-filling rows >= s and columns in [dh, dh_pad). With `vec` (dh % 8 == 0,
// width % 8 == 0 and a 16-byte aligned base) every thread issues all its
// copies before waiting on any, so their latencies overlap; the caller waits
// (cp_async_wait_all) and synchronises before reading.
__device__ inline void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int rows,
                                 int s, int width, int dh, int dh_pad, int ld, int tid,
                                 int nthreads, bool vec) {
  if (vec) {
    const int chunks = dh_pad / 8;
    for (int i = tid; i < rows * chunks; i += nthreads) {
      const int r = i / chunks, c = (i % chunks) * 8, row = row0 + r;
      const bool live = row < s && c < dh;
      cp_async16(dst + r * ld + c, live ? src + (size_t)row * width + c : src, live ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * dh_pad; i += nthreads) {
      const int r = i / dh_pad, c = i % dh_pad, row = row0 + r;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row < s && c < dh) val = src[(size_t)row * width + c];
      dst[r * ld + c] = val;
    }
  }
}

// Write the first dh columns of a warp's 16 f32 rows (shared memory, row
// stride ld) as bf16 rows [row0, min(row0 + 16, s)) of one head's slice.
// With `vec`, two bf16 per 4-byte store (even offsets).
__device__ inline void store_rows(__nv_bfloat16* dst, const float* src, int row0, int s,
                                  int width, int dh, int ld, int lane, bool vec) {
  for (int r = 0; r < 16 && row0 + r < s; ++r) {
    __nv_bfloat16* orow = dst + (size_t)(row0 + r) * width;
    const float* srow = src + r * ld;
    if (vec) {
      for (int d = 2 * lane; d < dh; d += 64)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(srow[d], srow[d + 1]);
    } else {
      for (int d = lane; d < dh; d += 32) orow[d] = __float2bfloat16(srow[d]);
    }
  }
}

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ inline void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Store four 8 × 8 b16 matrices, r[i] this lane's pair of matrix i in the
// mma fragment layout; lanes 8i .. 8i + 7 address the rows of matrix i.
__device__ inline void stsm_x4(unsigned addr, const unsigned (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a · b: one m16n8k16 bf16 product with f32 accumulation. a: rows g
// and g+8 at columns 2t, 2t+8; b: rows 2t, 2t+8 at column g; d: rows g, g+8
// at columns 2t, 2t+1 (g = lane / 4, t = lane % 4).
__device__ inline void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x by the hardware approximation (about 2 ulp in f32; flushes denormals).
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two bf16 of one head's row `row` (columns col, col+1), zero outside the
// (s, dh) slice; src is the head's slice, rows at stride width.
__device__ inline unsigned load_pair(const __nv_bfloat16* src, int row, int col, int s, int width, int dh,
                                     bool vec) {
  if (row >= s) return 0u;
  const __nv_bfloat16* p = src + (size_t)row * width;
  if (vec) return col < dh ? *reinterpret_cast<const unsigned*>(p + col) : 0u;
  const unsigned lo = col < dh ? __bfloat16_as_ushort(p[col]) : 0u;
  const unsigned hi = col + 1 < dh ? __bfloat16_as_ushort(p[col + 1]) : 0u;
  return lo | (hi << 16);
}

__device__ inline void store_pair(__nv_bfloat16* dst, int row, int col, float x, float y, int s, int width,
                                  int dh, bool vec) {
  if (row >= s) return;
  __nv_bfloat16* p = dst + (size_t)row * width;
  if (vec) {
    if (col < dh) *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(x, y);
    return;
  }
  if (col < dh) p[col] = __float2bfloat16(x);
  if (col + 1 < dh) p[col + 1] = __float2bfloat16(y);
}


}  // namespace short_attention
