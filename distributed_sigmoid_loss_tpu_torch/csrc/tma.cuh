// Tensor Memory Accelerator (TMA) and mbarrier helpers for the warpgroup
// bodies of K2, K3 and K7: shared-memory barriers with transaction counts,
// the 3-D bulk tensor load and store of one 64 × 64 box, the element-wise fill that
// lays a tile out as TMA's 128-byte swizzle does (for rows that are not
// 16-byte aligned), and the tensor maps over a (b, s, width) bf16 tensor.
// sm_90a only.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <stdint.h>

#include "short_attention_common.cuh"
#include "wgmma.cuh"

namespace short_attention {

constexpr int kPanel = 64;  // bf16 columns of a 128-byte swizzle panel

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 64 × 64 box of a (b, s, width) bf16 tensor map at (column, row,
// batch) into shared memory, completing on the barrier.
__device__ inline void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                                int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// One 64 × 64 box from shared memory into a (b, s, width) bf16 tensor map at
// (column, row, batch), asynchronously (bulk group); rows past s are not
// written.
__device__ inline void tma_store(const CUtensorMap* map, const void* src, int col, int row,
                                 int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

__device__ inline void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's committed bulk stores have read their shared
// memory (it may be written again).
__device__ inline void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's committed bulk stores are complete.
__device__ inline void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Element-wise fill of `rows` rows of one head's (s, DH) slice from row0 on
// (zero past s) into 64-column 128-byte-swizzled panels, as TMA lays them
// out: element (r, c) of panel c / 64 at byte r·128 + ((c/8 ⊕ r%8)·16) + c%8·2.
// One warpgroup (t = 0 .. 127) fills.
template <int DH>
__device__ inline void fill_swizzled(unsigned char* dst, const __nv_bfloat16* src, int row0,
                                     int rows, int s, int width, int t) {
  for (int i = t; i < rows * DH; i += 128) {
    const int r = i / DH, c = i % DH, cc = c % kPanel;
    const __nv_bfloat16 val =
        row0 + r < s ? src[(size_t)(row0 + r) * width + c] : __float2bfloat16(0.f);
    *reinterpret_cast<__nv_bfloat16*>(dst + (c / kPanel) * rows * 128 + r * 128 +
                                      ((((cc >> 3) ^ (r & 7))) << 4) + (cc & 7) * 2) = val;
  }
  fence_proxy_async();  // visible to wgmma
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a (b, s, width) bf16 tensor: 64 × 64 boxes, 128-byte swizzle,
// rows past s zero-filled.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int b, int s, int width) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)s * width * 2};
  const cuuint32_t box[3] = {kPanel, 64, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace short_attention
