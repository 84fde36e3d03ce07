// Fused short-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributed_sigmoid_loss_tpu/ops/
// pallas_short_attention.py::_short_attention_fwd (body _fwd_kernel): per
// (batch row, head), out = softmax(q·kᵀ·scale [causal mask]) · v, with f32
// logits and softmax, p rounded to bf16 before p·v, f32 accumulation, output
// stored in bf16.
//
// Bound on this card: at the towers' shapes the work is memory-bound. At
// ViT-B/16 vision, b=128 (s=196, h=12, dh=64) q, k, v and out are
// 4·128·196·768·2 B ≈ 154 MB, ≈ 46 µs at 3.35 TB/s, while the two products
// are 15.1 GFLOP, ≈ 15 µs at 989 TFLOP/s.
//
// Design against that bound: q, k and v are read in the towers' native
// (b, s, h·dh) layout (the head slice at stride width, no transposes) with
// asynchronous 16-byte copies whose latencies overlap, and out is written
// once. Nothing O(s²) leaves the SM: one block per (64-row q tile, head,
// batch row) holds that head's K and V in shared memory,
// each of its four warps owns 16 query rows, computes their logits with bf16
// tensor-core products (wmma m16n16k16, f32 accumulation) into its own shared
// strip, runs the f32 softmax there, overwrites the strip in place with the
// bf16 probabilities and multiplies them by V on the tensor cores. The ragged
// edge (s=196 is not a multiple of 16) is zero-padded in shared memory and
// masked out of the softmax. wgmma/TMA pipelining is later work.

#include "short_attention_common.cuh"

using namespace nvcuda;
using namespace short_attention;

namespace {

constexpr int kWarps = 4;  // each owns 16 query rows; 2 blocks per SM at s=196
constexpr int kRowsPerWarp = 16;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadTiles = 8;  // head_dim <= 128
constexpr int kSoftRows = 4;      // rows per softmax pass (divides kRowsPerWarp)

struct Geometry {
  int s_pad;    // sequence padded to the 16-row MMA tile
  int dh_pad;   // head dim padded to the 16-wide MMA tile
  int ld_kv;    // K/V/Q row stride in bf16 elements (+8 against bank conflicts)
  int ld_s;     // per-warp logits strip row stride in f32 elements
  size_t smem;  // dynamic shared memory of one block, bytes
};

__host__ __device__ inline Geometry geometry(int s, int dh) {
  Geometry g;
  g.s_pad = round_up(s, 16);
  g.dh_pad = round_up(dh, 16);
  g.ld_kv = g.dh_pad + 8;
  g.ld_s = (g.s_pad > g.dh_pad ? g.s_pad : g.dh_pad) + 4;
  g.smem = (size_t)2 * g.s_pad * g.ld_kv * sizeof(__nv_bfloat16) +
           (size_t)kWarps * kRowsPerWarp * g.ld_s * sizeof(float);
  return g;
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
short_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int s, int heads, int dh,
                           float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(s, dh);
  const int width = heads * dh;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kBlockQ + warp * kRowsPerWarp;  // this warp's first query row

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + g.s_pad * g.ld_kv;
  float* strip = reinterpret_cast<float*>(vs + g.s_pad * g.ld_kv) + warp * kRowsPerWarp * g.ld_s;

  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  load_tile(ks, k + slab, 0, g.s_pad, s, width, dh, g.dh_pad, g.ld_kv, tid, kThreads, vec);
  load_tile(vs, v + slab, 0, g.s_pad, s, width, dh, g.dh_pad, g.ld_kv, tid, kThreads, vec);
  // The warp's 16 query rows are staged in its own strip, read into
  // fragments, and the strip is then reused for the logits.
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(strip);
  load_tile(qs, q + slab, r0, kRowsPerWarp, s, width, dh, g.dh_pad, g.ld_kv, lane, 32, vec);
  cp_async_wait_all();
  __syncthreads();
  if (r0 >= s) return;  // a warp past the ragged edge has no rows (no block barrier follows)

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) wmma::load_matrix_sync(qa[t], qs + t * 16, g.ld_kv);
  __syncwarp();

  // logits (16 × s_pad, f32) = q · kᵀ
  for (int n = 0; n < g.s_pad / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, ks + n * 16 * g.ld_kv + t * 16, g.ld_kv);
      wmma::mma_sync(acc, qa[t], kb, acc);
    }
    wmma::store_matrix_sync(strip + n * 16, acc, g.ld_s, wmma::mem_row_major);
  }
  __syncwarp();

  // Row softmax in f32 (max-subtracted), written back as bf16 p over the same
  // strip: p row r occupies the first half of logits row r's bytes. Within a
  // row, the 32-key chunk at j0 overwrites logits [j0/2, j0/2 + 16), which are
  // already consumed by the max and sum passes and by this or earlier chunks.
  // kSoftRows rows go through each pass together, so their loads, exps and
  // shuffle reductions overlap, and the passes are branch-free: every read in
  // [0, s_pad) is in bounds (padded keys have finite logits), and a select
  // drops masked keys, so the shared loads pipeline instead of each waiting
  // behind a divergent branch. (Storing exp(x - max) back for the write pass
  // measured slower: the stores order the following shared loads.) exp is the
  // hardware ex2 approximation (about 2 ulp in f32, far below the bf16
  // rounding of p) and each row divides by its sum once. These passes, not
  // the products, set the kernel's time (PERF.md).
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(strip);
  const int ld_p = 2 * g.ld_s;
  for (int r = 0; r < kRowsPerWarp; r += kSoftRows) {
    int live[kSoftRows];
    float m[kSoftRows], l[kSoftRows];  // row max; row sum, then its reciprocal
#pragma unroll
    for (int i = 0; i < kSoftRows; ++i) {
      live[i] = causal ? min(r0 + r + i + 1, s) : s;  // keys [0, live) take part
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int j = lane; j < s; j += 32) {
#pragma unroll
      for (int i = 0; i < kSoftRows; ++i) {
        const float x = strip[(r + i) * g.ld_s + j] * scale;
        m[i] = fmaxf(m[i], j < live[i] ? x : -INFINITY);
      }
    }
#pragma unroll
    for (int i = 0; i < kSoftRows; ++i) m[i] = warp_max(m[i]);
    for (int j = lane; j < s; j += 32) {
#pragma unroll
      for (int i = 0; i < kSoftRows; ++i) {
        const float e = __expf(strip[(r + i) * g.ld_s + j] * scale - m[i]);
        l[i] += j < live[i] ? e : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kSoftRows; ++i) l[i] = 1.f / warp_sum(l[i]);
    for (int j0 = 0; j0 < g.s_pad; j0 += 32) {
      const int j = j0 + lane;
      const int jc = j < g.s_pad ? j : g.s_pad - 1;  // in-bounds read for the spare lanes
      float p[kSoftRows];
#pragma unroll
      for (int i = 0; i < kSoftRows; ++i) {
        const float e = __expf(strip[(r + i) * g.ld_s + jc] * scale - m[i]) * l[i];
        p[i] = j < live[i] ? e : 0.f;
      }
      __syncwarp();
      if (j < g.s_pad) {
#pragma unroll
        for (int i = 0; i < kSoftRows; ++i) pw[(r + i) * ld_p + j] = __float2bfloat16(p[i]);
      }
      __syncwarp();
    }
  }

  // out (16 × dh_pad, f32) = p · v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) wmma::fill_fragment(oacc[t], 0.f);
  for (int kt = 0; kt < g.s_pad / 16; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, pw + kt * 16, ld_p);
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, vs + kt * 16 * g.ld_kv + t * 16, g.ld_kv);
      wmma::mma_sync(oacc[t], pa, vb, oacc[t]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < DT; ++t)
    wmma::store_matrix_sync(strip + t * 16, oacc[t], g.ld_s, wmma::mem_row_major);
  __syncwarp();

  store_rows(out + slab, strip, r0, s, width, dh, g.ld_s, lane, vec);
}

template <int DT>
cudaError_t configure(const Geometry& g) {
  auto kernel = short_attention_fwd_kernel<DT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int DT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int s,
                   int heads, int dh, float scale, int causal, int vec, cudaStream_t stream) {
  const Geometry g = geometry(s, dh);
  const cudaError_t err = configure<DT>(g);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, heads, b);
  short_attention_fwd_kernel<DT><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s, heads, dh,
      scale, causal, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, bytes (mirrored by
// ops/short_attention.py::short_attention_smem_bytes).
long long short_attention_smem_bytes(int s, int dh) { return (long long)geometry(s, dh).smem; }

// q, k, v, out: (b, s, heads·dh) bf16, contiguous. Returns the cudaError_t of
// the launch (0 on success); the launch does not synchronise.
int short_attention_fwd(const void* q, const void* k, const void* v, void* out, int b, int s,
                        int heads, int dh, float scale, int causal, int vec, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || heads < 1 || heads > 65535 || dh < 1 ||
      dh > 16 * kMaxHeadTiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dh + 15) / 16) {
    case 1: return (int)launch<1>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
    case 2: return (int)launch<2>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
    case 3: return (int)launch<3>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
    case 4: return (int)launch<4>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
    case 5: return (int)launch<5>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
    case 6: return (int)launch<6>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
    case 7: return (int)launch<7>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
    default: return (int)launch<8>(q, k, v, out, b, s, heads, dh, scale, causal, vec, st);
  }
}

// Resident blocks per SM for this shape (0 with an error), for the records.
int short_attention_occupancy(int s, int dh) {
  if (s < 1 || dh < 1 || dh > 16 * kMaxHeadTiles) return 0;
  const Geometry g = geometry(s, dh);
  int blocks = 0;
  switch ((dh + 15) / 16) {
#define SA_OCC(DT)                                                                       \
  case DT:                                                                               \
    if (configure<DT>(g) != cudaSuccess ||                                               \
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, short_attention_fwd_kernel<DT>, \
                                                      kThreads, g.smem) != cudaSuccess)  \
      return 0;                                                                          \
    return blocks;
    SA_OCC(1) SA_OCC(2) SA_OCC(3) SA_OCC(4) SA_OCC(5) SA_OCC(6) SA_OCC(7)
    default: SA_OCC(8)
#undef SA_OCC
  }
}

const char* short_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
