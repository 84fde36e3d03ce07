// Helpers shared by the short-attention forward (short_attention.cu) and
// backward (short_attention_bwd.cu) kernels: warp reductions, 16-byte
// asynchronous copies and the tile loader for one head's (s, dh) slice of a
// (b, s, heads·dh) tensor.

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

}  // namespace short_attention
