// Fused short-sequence self-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributed_sigmoid_loss_tpu/ops/
// pallas_short_attention.py::_short_attention_bwd (body _bwd_kernel): per
// (batch row, head), by recompute from q, k, v and the output gradient do,
//   p  = softmax(q·kᵀ·scale [causal mask])        f32
//   dv = bf16(p)ᵀ · do
//   dp = do · vᵀ                                   f32
//   ds = bf16(p ⊙ (dp − rowsum(dp ⊙ p)) · scale)
//   dq = ds · k,  dk = dsᵀ · q
// with bf16 tensor-core products accumulated in f32 and bf16 outputs. The
// rowsum is JAX's rowsum(dp ⊙ p) over the f32 p, not FlashAttention's
// rowsum(do ⊙ o) over the bf16-rounded output.
//
// Bound on this card: memory. At ViT-B/16 vision, b=128 (s=196, h=12,
// dh=64), q, k, v, do read once and dq, dk, dv written once are
// 7·128·196·768·2 B ≈ 270 MB, ≈ 80.5 µs at 3.35 TB/s, while the five
// products are 5·2·128·12·196²·64 ≈ 37.8 GFLOP, ≈ 38.2 µs at 989 TFLOP/s.
// At the text tower (s=64) the bound is 88 MB, ≈ 26.3 µs.
//
// Design. The TPU kernel held one batch row's whole (s, h·dh) tiles in VMEM
// and looped over heads. Here one head's q, k, v, do at s=196 are ~100 KB in
// bf16 and f32 dk/dv accumulators for all its keys another ~100 KB, so one
// block per (b, head) does not fit 227 KB beside the logits. Two kernels
// instead, each a grid of (64-row tile, head, batch row) blocks of four
// warps that own 16 rows each and stream over the other side 16 rows at a time, as
// FlashAttention-2 does, but with no online softmax: s <= 256, so each query
// row's statistics are recomputed whole.
//   1. dq: the block holds the head's K and V in shared memory; a warp owns
//      16 query rows and makes three passes over the key tiles (row max; row
//      sum and Σ e·dp; then ds and dq += ds·k). It writes each row's max,
//      1/sum and D = rowsum(dp ⊙ p) to a small f32 buffer.
//   2. dk, dv: the block holds the head's Q and dO and those statistics; a
//      warp owns 16 key rows with dk and dv in register accumulators and
//      recomputes pᵀ and dsᵀ tile by tile, bit for bit as kernel 1 rounds them.
// Every 16×16 logits or dp tile goes through the warp's own shared scratch
// (wmma accumulators have no documented element layout), where its lanes
// apply the softmax algebra elementwise. Nothing O(s²) leaves the SM, and
// no atomics: each output element is written by one warp, so runs are
// deterministic. The ragged edge (s=196) is zero-padded in shared memory and
// masked; causal kernels skip the tiles that are masked whole. wgmma/TMA
// pipelining is later work.

#include "short_attention_common.cuh"

using namespace nvcuda;
using namespace short_attention;

namespace {

constexpr int kWarps = 4;  // each owns 16 rows (queries in kernel 1, keys in kernel 2)
constexpr int kRows = 16;
constexpr int kBlock = kWarps * kRows;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadTiles = 8;  // head_dim <= 128
constexpr int kTile = 16 * 16;    // elements of one scratch tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Geometry {
  int s_pad;          // sequence padded to the 16-row MMA tile
  int dh_pad;         // head dim padded to the 16-wide MMA tile
  int ld_kv;          // bf16 row stride of the block's operands and the staged rows
  int ld_o;           // f32 row stride of a warp's output staging
  size_t warp_bytes;  // one warp's shared region
  size_t smem;        // dynamic shared memory of one block, bytes
};

// Block layout: two (s_pad × ld_kv) bf16 operands (K, V in kernel 1; Q, dO in
// kernel 2), then four warp regions, then the row statistics (3 × s_pad f32,
// kernel 2 only). A warp region holds, in turn: its 16 staged rows of two
// operands (bf16), then four scratch tiles (logits and dp in f32, p and ds in
// bf16), then its 16 output rows (f32) for the final store.
__host__ __device__ inline Geometry geometry(int s, int dh) {
  Geometry g;
  g.s_pad = round_up(s, 16);
  g.dh_pad = round_up(dh, 16);
  g.ld_kv = g.dh_pad + 8;
  g.ld_o = g.dh_pad + 4;
  size_t staged = (size_t)2 * kRows * g.ld_kv * sizeof(__nv_bfloat16);
  size_t scratch = (size_t)2 * kTile * sizeof(float) + (size_t)2 * kTile * sizeof(__nv_bfloat16);
  size_t out = (size_t)kRows * g.ld_o * sizeof(float);
  size_t w = staged > scratch ? staged : scratch;
  w = w > out ? w : out;
  g.warp_bytes = (w + 127) / 128 * 128;
  g.smem = (size_t)2 * g.s_pad * g.ld_kv * sizeof(__nv_bfloat16) + kWarps * g.warp_bytes +
           (size_t)3 * g.s_pad * sizeof(float);
  return g;
}

// dst (16×16 f32, row stride 16) = a (16 × 16·DT) · rows[0:16]ᵀ, where rows
// are 16 bf16 rows of the block's operand at stride ld.
template <int DT>
__device__ inline void dot_rows_t(float* dst, const FragA (&a)[DT], const __nv_bfloat16* rows,
                                  int ld) {
  FragAcc acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    FragBCol b;
    wmma::load_matrix_sync(b, rows + t * 16, ld);
    wmma::mma_sync(acc, a[t], b, acc);
  }
  wmma::store_matrix_sync(dst, acc, 16, wmma::mem_row_major);
}

// acc[t] += a (16×16 bf16 tile) · rows[0:16, 16t:16t+16].
template <int DT>
__device__ inline void accumulate(FragAcc (&acc)[DT], const __nv_bfloat16* a_tile,
                                  const __nv_bfloat16* rows, int ld) {
  FragA a;
  wmma::load_matrix_sync(a, a_tile, 16);
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    FragBRow b;
    wmma::load_matrix_sync(b, rows + t * 16, ld);
    wmma::mma_sync(acc[t], a, b, acc[t]);
  }
}

template <int DT>
__device__ inline void load_frags(FragA (&a)[DT], const __nv_bfloat16* rows, int ld) {
#pragma unroll
  for (int t = 0; t < DT; ++t) wmma::load_matrix_sync(a[t], rows + t * 16, ld);
}

// Lanes and a 16×16 scratch tile: lane l takes column l % 16 of rows
// l / 16 + 2i, i = 0..7, so each access of the warp reads two whole rows,
// 32 consecutive floats with no bank conflict. A row's reduction over its
// columns is one over the 16 lanes of a half-warp.
constexpr int kSlots = 8;

__device__ inline float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Kernel 1: dq and the row statistics (max, 1/sum, D) of every query row.
template <int DT>
__global__ void __launch_bounds__(kThreads)
short_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                              int batch, int s, int heads, int dh, float scale, int causal,
                              int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(s, dh);
  const int width = heads * dh;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kBlock + warp * kRows;  // this warp's first query row

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + g.s_pad * g.ld_kv;
  unsigned char* region = smem_raw + (size_t)2 * g.s_pad * g.ld_kv * sizeof(__nv_bfloat16) +
                          warp * g.warp_bytes;
  __nv_bfloat16* qst = reinterpret_cast<__nv_bfloat16*>(region);
  __nv_bfloat16* dost = qst + kRows * g.ld_kv;

  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  load_tile(ks, k + slab, 0, g.s_pad, s, width, dh, g.dh_pad, g.ld_kv, tid, kThreads, vec);
  load_tile(vs, v + slab, 0, g.s_pad, s, width, dh, g.dh_pad, g.ld_kv, tid, kThreads, vec);
  load_tile(qst, q + slab, r0, kRows, s, width, dh, g.dh_pad, g.ld_kv, lane, 32, vec);
  load_tile(dost, dout + slab, r0, kRows, s, width, dh, g.dh_pad, g.ld_kv, lane, 32, vec);
  cp_async_wait_all();
  __syncthreads();
  if (r0 >= s) return;  // a warp past the ragged edge has no rows (no block barrier follows)

  FragA qa[DT], da[DT];
  load_frags<DT>(qa, qst, g.ld_kv);
  load_frags<DT>(da, dost, g.ld_kv);
  __syncwarp();
  // From here the region is scratch: logits tile, dp tile, ds tile.
  float* ss = reinterpret_cast<float*>(region);
  float* sp = ss + kTile;
  __nv_bfloat16* sds = reinterpret_cast<__nv_bfloat16*>(sp + kTile);

  const int c = lane & 15, rh = lane >> 4;
  int live[kSlots];  // keys [0, live) take part in row rh + 2i
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int qi = r0 + rh + 2 * i;
    live[i] = qi < s ? (causal ? qi + 1 : s) : 0;
  }
  // Causal: key tiles past the warp's last row are masked whole.
  const int ntiles = causal ? min(g.s_pad / 16, r0 / 16 + 1) : g.s_pad / 16;

  // Pass 1: row max of the scaled logits.
  float m[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) m[i] = -INFINITY;
  for (int n = 0; n < ntiles; ++n) {
    dot_rows_t<DT>(ss, qa, ks + n * 16 * g.ld_kv, g.ld_kv);
    __syncwarp();
    const int j = n * 16 + c;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      m[i] = fmaxf(m[i], j < live[i] ? ss[(rh + 2 * i) * 16 + c] * scale : -INFINITY);
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) m[i] = half_warp_max(m[i]);

  // Pass 2: row sum of e = exp(x − max) and Σ e·dp, so D = Σ p·dp = (Σ e·dp)/l.
  float l[kSlots], t[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) l[i] = t[i] = 0.f;
  for (int n = 0; n < ntiles; ++n) {
    dot_rows_t<DT>(ss, qa, ks + n * 16 * g.ld_kv, g.ld_kv);
    dot_rows_t<DT>(sp, da, vs + n * 16 * g.ld_kv, g.ld_kv);
    __syncwarp();
    const int j = n * 16 + c;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int o = (rh + 2 * i) * 16 + c;
      const float x = __expf(ss[o] * scale - m[i]);
      const float ex = j < live[i] ? x : 0.f;
      l[i] += ex;
      t[i] += ex * sp[o];
    }
    __syncwarp();
  }
  float rl[kSlots], mx[kSlots], dsum[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    // The shuffles run in every lane: the two half-warps' rows may differ in
    // liveness.
    const float lsum = half_warp_sum(l[i]), tsum = half_warp_sum(t[i]);
    rl[i] = live[i] > 0 ? 1.f / lsum : 0.f;
    mx[i] = live[i] > 0 ? m[i] : 0.f;
    dsum[i] = tsum * rl[i];
  }

  // Pass 3: ds = bf16(p·(dp − D)·scale), dq += ds · k.
  FragAcc acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int n = 0; n < ntiles; ++n) {
    dot_rows_t<DT>(ss, qa, ks + n * 16 * g.ld_kv, g.ld_kv);
    dot_rows_t<DT>(sp, da, vs + n * 16 * g.ld_kv, g.ld_kv);
    __syncwarp();
    const int j = n * 16 + c;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int o = (rh + 2 * i) * 16 + c;
      const float x = __expf(ss[o] * scale - mx[i]) * rl[i];
      const float p = j < live[i] ? x : 0.f;
      sds[o] = __float2bfloat16((p * (sp[o] - dsum[i])) * scale);
    }
    __syncwarp();
    accumulate<DT>(acc, sds, ks + n * 16 * g.ld_kv, g.ld_kv);
    __syncwarp();  // every lane has read sds before the next tile rewrites it
  }

  if (c == 0) {
    const size_t plane = (size_t)batch * heads * s;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int qi = r0 + rh + 2 * i;
      if (qi < s) {
        const size_t o = ((size_t)b * heads + h) * s + qi;
        stats[o] = mx[i];
        stats[plane + o] = rl[i];
        stats[2 * plane + o] = dsum[i];
      }
    }
  }
  float* so = reinterpret_cast<float*>(region);
#pragma unroll
  for (int i = 0; i < DT; ++i) wmma::store_matrix_sync(so + i * 16, acc[i], g.ld_o, wmma::mem_row_major);
  __syncwarp();
  store_rows(dq + slab, so, r0, s, width, dh, g.ld_o, lane, vec);
}

// Kernel 2: dk and dv. A warp owns 16 key rows; tiles are transposed (rows =
// keys, columns = queries), so a lane's column is one query and its
// statistics are three loads per tile.
template <int DT>
__global__ void __launch_bounds__(kThreads)
short_attention_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int batch, int s, int heads,
                                int dh, float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(s, dh);
  const int width = heads * dh;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kBlock + warp * kRows;  // this warp's first key row

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + g.s_pad * g.ld_kv;
  unsigned char* base = smem_raw + (size_t)2 * g.s_pad * g.ld_kv * sizeof(__nv_bfloat16);
  unsigned char* region = base + warp * g.warp_bytes;
  float* st_m = reinterpret_cast<float*>(base + kWarps * g.warp_bytes);
  float* st_rl = st_m + g.s_pad;
  float* st_d = st_rl + g.s_pad;
  __nv_bfloat16* kst = reinterpret_cast<__nv_bfloat16*>(region);
  __nv_bfloat16* vst = kst + kRows * g.ld_kv;

  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  load_tile(qs, q + slab, 0, g.s_pad, s, width, dh, g.dh_pad, g.ld_kv, tid, kThreads, vec);
  load_tile(dos, dout + slab, 0, g.s_pad, s, width, dh, g.dh_pad, g.ld_kv, tid, kThreads, vec);
  load_tile(kst, k + slab, k0, kRows, s, width, dh, g.dh_pad, g.ld_kv, lane, 32, vec);
  load_tile(vst, v + slab, k0, kRows, s, width, dh, g.dh_pad, g.ld_kv, lane, 32, vec);
  {
    // Padded query rows get zero statistics, so their p and ds are 0.
    const size_t plane = (size_t)batch * heads * s;
    const size_t o = ((size_t)b * heads + h) * s;
    for (int i = tid; i < g.s_pad; i += kThreads) {
      const bool in = i < s;
      st_m[i] = in ? stats[o + i] : 0.f;
      st_rl[i] = in ? stats[plane + o + i] : 0.f;
      st_d[i] = in ? stats[2 * plane + o + i] : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (k0 >= s) return;  // a warp past the ragged edge has no rows (no block barrier follows)

  FragA ka[DT], va[DT];
  load_frags<DT>(ka, kst, g.ld_kv);
  load_frags<DT>(va, vst, g.ld_kv);
  __syncwarp();
  float* ss = reinterpret_cast<float*>(region);
  float* sp = ss + kTile;
  __nv_bfloat16* splo = reinterpret_cast<__nv_bfloat16*>(sp + kTile);
  __nv_bfloat16* sds = splo + kTile;

  const int c = lane & 15, rh = lane >> 4;
  // Causal: query tiles before the warp's first key are masked whole.
  const int n0 = causal ? k0 / 16 : 0;
  FragAcc dka[DT], dva[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    wmma::fill_fragment(dka[i], 0.f);
    wmma::fill_fragment(dva[i], 0.f);
  }
  for (int n = n0; n < g.s_pad / 16; ++n) {
    dot_rows_t<DT>(ss, ka, qs + n * 16 * g.ld_kv, g.ld_kv);   // logitsᵀ
    dot_rows_t<DT>(sp, va, dos + n * 16 * g.ld_kv, g.ld_kv);  // dpᵀ
    __syncwarp();
    const int qi = n * 16 + c;
    const float mq = st_m[qi], rlq = st_rl[qi], dsq = st_d[qi];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = rh + 2 * i, o = r * 16 + c, kj = k0 + r;
      const bool live = kj < s && qi < s && (!causal || kj <= qi);
      const float x = __expf(ss[o] * scale - mq) * rlq;
      const float p = live ? x : 0.f;
      splo[o] = __float2bfloat16(p);
      sds[o] = __float2bfloat16((p * (sp[o] - dsq)) * scale);
    }
    __syncwarp();
    accumulate<DT>(dva, splo, dos + n * 16 * g.ld_kv, g.ld_kv);  // dv += bf16(p)ᵀ · do
    accumulate<DT>(dka, sds, qs + n * 16 * g.ld_kv, g.ld_kv);    // dk += dsᵀ · q
    __syncwarp();
  }

  float* so = reinterpret_cast<float*>(region);
#pragma unroll
  for (int i = 0; i < DT; ++i) wmma::store_matrix_sync(so + i * 16, dka[i], g.ld_o, wmma::mem_row_major);
  __syncwarp();
  store_rows(dk + slab, so, k0, s, width, dh, g.ld_o, lane, vec);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < DT; ++i) wmma::store_matrix_sync(so + i * 16, dva[i], g.ld_o, wmma::mem_row_major);
  __syncwarp();
  store_rows(dv + slab, so, k0, s, width, dh, g.ld_o, lane, vec);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, const Geometry& g) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int DT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, void* stats, int b, int s, int heads, int dh, float scale,
                   int causal, int vec, cudaStream_t stream) {
  const Geometry g = geometry(s, dh);
  cudaError_t err = configure(short_attention_bwd_dq_kernel<DT>, g);
  if (err == cudaSuccess) err = configure(short_attention_bwd_dkdv_kernel<DT>, g);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlock - 1) / kBlock, heads, b);
  using bf = __nv_bfloat16;
  short_attention_bwd_dq_kernel<DT><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<bf*>(dq), static_cast<float*>(stats), b, s, heads,
      dh, scale, causal, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  short_attention_bwd_dkdv_kernel<DT><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(stats), static_cast<bf*>(dk),
      static_cast<bf*>(dv), b, s, heads, dh, scale, causal, vec);
  return cudaGetLastError();
}

template <int DT>
int occupancy(const Geometry& g, int which) {
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    err = configure(short_attention_bwd_dq_kernel<DT>, g);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, short_attention_bwd_dq_kernel<DT>, kThreads, g.smem);
  } else {
    err = configure(short_attention_bwd_dkdv_kernel<DT>, g);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, short_attention_bwd_dkdv_kernel<DT>, kThreads, g.smem);
  }
  return err == cudaSuccess ? blocks : 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of either kernel needs, bytes (mirrored by
// ops/short_attention.py::short_attention_bwd_smem_bytes).
long long short_attention_bwd_smem_bytes(int s, int dh) { return (long long)geometry(s, dh).smem; }

// q, k, v, dout, dq, dk, dv: (b, s, heads·dh) bf16, contiguous; stats:
// 3·b·heads·s f32 scratch (row max, 1/sum, D), written by the first kernel
// and read by the second. Returns the cudaError_t of the launches (0 on
// success); they do not synchronise.
int short_attention_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, void* stats, int b, int s, int heads, int dh,
                        float scale, int causal, int vec, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || heads < 1 || heads > 65535 || dh < 1 ||
      dh > 16 * kMaxHeadTiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SAB_LAUNCH(DT) \
  return (int)launch<DT>(q, k, v, dout, dq, dk, dv, stats, b, s, heads, dh, scale, causal, vec, st);
  switch ((dh + 15) / 16) {
    case 1: SAB_LAUNCH(1)
    case 2: SAB_LAUNCH(2)
    case 3: SAB_LAUNCH(3)
    case 4: SAB_LAUNCH(4)
    case 5: SAB_LAUNCH(5)
    case 6: SAB_LAUNCH(6)
    case 7: SAB_LAUNCH(7)
    default: SAB_LAUNCH(8)
  }
#undef SAB_LAUNCH
}

// Resident blocks per SM of kernel `which` (0: dq, 1: dk/dv) at this shape
// (0 with an error), for the records.
int short_attention_bwd_occupancy(int s, int dh, int which) {
  if (s < 1 || dh < 1 || dh > 16 * kMaxHeadTiles) return 0;
  const Geometry g = geometry(s, dh);
  switch ((dh + 15) / 16) {
    case 1: return occupancy<1>(g, which);
    case 2: return occupancy<2>(g, which);
    case 3: return occupancy<3>(g, which);
    case 4: return occupancy<4>(g, which);
    case 5: return occupancy<5>(g, which);
    case 6: return occupancy<6>(g, which);
    case 7: return occupancy<7>(g, which);
    default: return occupancy<8>(g, which);
  }
}

const char* short_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
