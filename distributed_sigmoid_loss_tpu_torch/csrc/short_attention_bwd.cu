// Fused short-sequence self-attention backward for Hopper (sm_90a): K2.
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
// Two bodies, picked by shape before launch (short_attention_bwd_body);
// each is a pair of kernels, dQ then dK/dV, joined by three f32 statistics
// per query row (the dQ kernel's −max·scale·log2e, 1/sum and D), and
// neither uses atomics: every output element is written by one thread, so
// runs are bitwise repeatable. Nothing O(s²) leaves the SM.
//
// - The warpgroup body (head dim 64, 16-byte rows, s_pad <= 256: B/16's
//   vision s=196 and text s=64, L/14's s=256). One block per (head, batch
//   row) in each kernel, one or two warpgroups, no producer: one thread
//   loads the head's operands by TMA (3-D tensor maps over the native
//   (b, s, h·dh) layout, rows past s zero-filled, 128-byte swizzle) once
//   per block, and they stay resident; the products are wgmma with the
//   logits and dp in accumulator registers (mma.sync's element layout), so
//   row statistics are quad shuffles and no tile goes through scratch.
//   Seven products, not five: the dK/dV kernel recomputes the logits and
//   dp transposed (keys as M), because a 64-row warpgroup cannot hold both
//   the transposed products' A operands for every key and its own dk, dv.
//   Five would need bf16(p) and ds of the whole head in shared memory (2 ·
//   256² · 2 B at s=256) beside the four operands; seven need nothing more.
//   The two sides compute the same f32 products (the tensor cores sum the
//   same 64 exact bf16 products either way round) and the same softmax
//   arithmetic on them, from the same statistics, so p and ds agree bit for
//   bit; chip_smoke checks that through short_attention_bwd_probe.
//   dQ kernel: K and V of the head (64, 208 or 256 key rows, N) stay in
//   shared memory; warpgroup c takes query tiles c, c + 2, ... of 64 rows,
//   each by TMA into its own buffer (the next one's load starts once this
//   one's products have read it). Per tile: s = q·kᵀ, one m64·nN·k64 chain;
//   mask by key (−inf), row max and sum by quad shuffles, p = 2^(s·scale·
//   log2e − max·scale·log2e)·(1/sum) by ex2.approx and an FMA. N/2 f32 of p
//   and N/2 of dp do not both fit a thread's registers at N = 208 or 256,
//   so p is parked in shared memory (each thread its own values, 16-byte
//   stores in thread order: no bank conflicts, no barrier) while dp =
//   do·vᵀ, another m64·nN chain, fills the registers; D = Σ p·dp by quad
//   shuffles; ds = bf16((p·(dp − D))·scale) is packed straight into the
//   A-operand registers of dq = ds·k (register-A wgmma, K as the transposed
//   B). Three products.
//   dK/dV kernel: one warpgroup per (key tile of 64, head, batch row), two
//   blocks an SM (one's loads overlap the other's products). Q, dO and the
//   statistics of the head and the tile's K and V stay in shared memory;
//   the warpgroup walks the 64-query chunks: sᵀ = k·qᵀ and dpᵀ = v·doᵀ
//   (m64·n64 chains, both in flight), pᵀ from the statistics, dsᵀ, then
//   dv += bf16(pᵀ)·do and dk += dsᵀ·q as register-A wgmma. Four products.
//   A last chunk of at most 16 queries (B/16's 4 past 192) runs at n16
//   and one 16-query step, a quarter of a full chunk's work. Causal key tiles start at their diagonal chunk; the dQ
//   kernel masks causal keys but spans all N of them (its row statistics
//   need the whole row in one chain).
//   Every sequence of products is straight-line code, waited for before
//   the loop's back edge: ptxas serialises the wgmmas of a loop that keeps
//   one in flight across it or issues them in divergent branches.
// - The wmma body (every other shape K1 takes: s_pad up to 416 at head dim
//   64, head dims 72 and 128, rows not 16-byte aligned). The TPU kernel held
//   one batch row's whole (s, h·dh) tiles in VMEM and looped over heads.
//   Here one head's q, k, v, do at s=196 are ~100 KB in bf16 and f32 dk/dv
//   accumulators for all its keys another ~100 KB, so one block per (b,
//   head) does not fit 227 KB beside the logits. Two kernels instead, each
//   a grid of (64-row tile, head, batch row) blocks of four warps that own
//   16 rows each and stream over the other side 16 rows at a time, as
//   FlashAttention-2 does, but with no online softmax: s <= 256, so each
//   query row's statistics are recomputed whole.
//   1. dq: the block holds the head's K and V in shared memory; a warp owns
//      16 query rows and makes three passes over the key tiles (row max; row
//      sum and Σ e·dp; then ds and dq += ds·k). It writes each row's max,
//      1/sum and D = rowsum(dp ⊙ p) to a small f32 buffer.
//   2. dk, dv: the block holds the head's Q and dO and those statistics; a
//      warp owns 16 key rows with dk and dv in register accumulators and
//      recomputes pᵀ and dsᵀ tile by tile, bit for bit as kernel 1 rounds them.
//   Every 16×16 logits or dp tile goes through the warp's own shared scratch
//   (wmma accumulators have no documented element layout), where its lanes
//   apply the softmax algebra elementwise. The ragged edge (s=196) is
//   zero-padded in shared memory and masked; causal kernels skip the tiles
//   that are masked whole.

#include <type_traits>

#include "short_attention_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int DT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, void* stats, int b, int s, int heads, int dh, float scale,
                   int causal, int vec, cudaStream_t stream) {
  const Geometry g = geometry(s, dh);
  cudaError_t err = configure(short_attention_bwd_dq_kernel<DT>, g.smem);
  if (err == cudaSuccess) err = configure(short_attention_bwd_dkdv_kernel<DT>, g.smem);
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
    err = configure(short_attention_bwd_dq_kernel<DT>, g.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, short_attention_bwd_dq_kernel<DT>, kThreads, g.smem);
  } else {
    err = configure(short_attention_bwd_dkdv_kernel<DT>, g.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, short_attention_bwd_dkdv_kernel<DT>, kThreads, g.smem);
  }
  return err == cudaSuccess ? blocks : 0;
}

// ---- the warpgroup body: head dim 64, 16-byte rows, s_pad <= 256 ----------

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBox = 64 * 128;  // one TMA box: 64 rows of one head's 64 columns, bf16

// Keys of a row in the dQ kernel's products at this shape (64, 208 or 256,
// as K1's warpgroup body), 0 where the warpgroup body does not run (head
// dim other than 64, rows not 16-byte aligned, or s_pad > 256).
__host__ __device__ inline int wg_keys(int s, int dh, int vec) {
  const int s_pad = round_up(s, 16);
  if (dh != 64 || !vec || s < 1 || s_pad > 256) return 0;
  return s_pad <= 64 ? 64 : s_pad <= 208 ? 208 : 256;
}

// The dQ kernel at N keys: K and V over kRows rows (whole TMA boxes, those
// past s zero), then per warpgroup a Q and a dO tile and its parked p (N/2
// f32 a thread), then the barriers (K/V, and one per warpgroup's tiles).
template <int N>
struct WgDq {
  static constexpr int kRows = (N + 63) / 64 * 64;
  static constexpr int kGroups = N == 64 ? 1 : 2;  // s <= 64 has one query tile
  static constexpr int kThreads = 128 * kGroups;
  static constexpr size_t kParkBytes = (size_t)N / 2 * 128 * sizeof(float);
  static constexpr size_t kSmem = 1024 + (size_t)2 * kRows * 128 +
                                  kGroups * (2 * (size_t)kBox + kParkBytes) +
                                  (1 + kGroups) * sizeof(uint64_t);
};

// The dK/dV kernel at length s: Q and dO of the head over round_up(s, 64)
// rows, the block's K and V tiles, the three statistics of each query row,
// one barrier.
__host__ __device__ inline size_t wg_dkdv_smem(int s) {
  const int rows = round_up(s, 64);
  return 1024 + (size_t)2 * rows * 128 + 2 * (size_t)kBox + (size_t)3 * rows * sizeof(float) +
         sizeof(uint64_t);
}

__device__ inline void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The probe (short_attention_bwd_probe): four f32 planes of (b, heads, s,
// s), [query][key]: p as the dQ kernel computes it, p as the dK/dV kernel
// does, then ds (before its bf16 rounding) from each. nullptr: none. One
// accumulator quad: x[0], x[1] at (row, col), (row, col + 1) and x[2], x[3]
// at row + 8, in the dQ kernel's orientation (rows = queries); the dK/dV
// kernel's (rows = keys) is transposed.
__device__ inline void probe_quad(float* probe, int plane, size_t rows, size_t bh, int row,
                                  int col, int s, const float* x, bool transposed = false) {
  const size_t base = (plane * rows + bh * s) * s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row + 8 * (i / 2), c = col + i % 2;
    const int qi = transposed ? c : r, kj = transposed ? r : c;
    if (qi < s && kj < s) probe[base + (size_t)qi * s + kj] = x[i];
  }
}

// dQ kernel: per query tile of 64 rows, s = q·kᵀ and dp = do·vᵀ over all N
// keys, the row statistics, ds and dq = ds·k; writes dq and the statistics
// (−max·scale·log2e, 1/sum, D) of every query row < s.
template <int N>
__global__ void __launch_bounds__(WgDq<N>::kThreads, N == 64 ? 3 : 1)
short_attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap k_map,
                                    const __grid_constant__ CUtensorMap v_map,
                                    const __grid_constant__ CUtensorMap do_map,
                                    bf16* __restrict__ dq, float* __restrict__ stats,
                                    float* __restrict__ probe, int batch, int s, int heads,
                                    float scale, int causal) {
  using G = WgDq<N>;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  unsigned char* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + G::kRows * 128;
  unsigned char* tiles = vs + G::kRows * 128;  // warpgroup c: Q at tiles + 2c·kBox, dO after
  unsigned char* parks = tiles + G::kGroups * 2 * kBox;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(parks + G::kGroups * G::kParkBytes);
  uint64_t* tile_bar = kv_bar + 1;

  const int width = heads * 64;
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;
  const int w = t / 32, lane = t % 32, gq = lane >> 2, tq = lane & 3;
  const int n_qt = (s + 63) / 64;  // query tiles, and K/V boxes
  unsigned char* qt_s = tiles + c * 2 * kBox;
  unsigned char* dot_s = qt_s + kBox;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int g = 0; g < G::kGroups; ++g) mbar_init(&tile_bar[g], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // K and V rows past the last box (N = 208 at s <= 192) are zero.
  for (int i = threadIdx.x; i < (G::kRows - n_qt * 64) * 8; i += G::kThreads) {
    const int off = n_qt * kBox + i * 16;
    *reinterpret_cast<uint4*>(ks + off) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(vs + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_bar, 2 * n_qt * kBox);
    for (int x = 0; x < n_qt; ++x) {
      tma_load(ks + x * kBox, &k_map, kv_bar, h * 64, x * 64, b);
      tma_load(vs + x * kBox, &v_map, kv_bar, h * 64, x * 64, b);
    }
  }
  if (c >= n_qt) return;  // no block barrier follows
  if (t == 0) {
    mbar_expect_tx(&tile_bar[c], 2 * kBox);
    tma_load(qt_s, &q_map, &tile_bar[c], h * 64, c * 64, b);
    tma_load(dot_s, &do_map, &tile_bar[c], h * 64, c * 64, b);
  }

  const float sl = scale * kLog2e;
  const size_t bh = (size_t)b * heads + h, plane = (size_t)batch * heads * s;
  const size_t slab = (size_t)b * s * width + (size_t)h * 64;
  // This thread's parked p: float4 n (8-key tile n: row a's two values, then
  // row b's two) at park[n·128 + t].
  float4* park = reinterpret_cast<float4*>(parks + c * G::kParkBytes);
  mbar_wait(kv_bar, 0);

  for (int j = 0, qt = c; qt < n_qt; ++j, qt += G::kGroups) {
    mbar_wait(&tile_bar[c], (unsigned)j & 1u);
    const int row_a = qt * 64 + 16 * w + gq, row_b = row_a + 8;

    float sc[N / 2];  // overwritten by the first product (scale_d = 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_keys<N>(sc, sw128_desc(qt_s + kk * 32, 16), sw128_desc(ks + kk * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // Softmax in registers (row a: registers 4n, 4n+1; row b: 4n+2, 4n+3
    // of 8-key tile n). Rows past s keep every key below s live, so their
    // values stay finite; they write nothing.
    const int lim_a = causal ? min(row_a + 1, s) : s;
    const int lim_b = causal ? min(row_b + 1, s) : s;
    const int lim = min(lim_a, lim_b);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      if (8 * n + 8 > lim) {
        const int col = 8 * n + 2 * tq;
        sc[4 * n] = col < lim_a ? sc[4 * n] : -INFINITY;
        sc[4 * n + 1] = col + 1 < lim_a ? sc[4 * n + 1] : -INFINITY;
        sc[4 * n + 2] = col < lim_b ? sc[4 * n + 2] : -INFINITY;
        sc[4 * n + 3] = col + 1 < lim_b ? sc[4 * n + 3] : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    const float nm_a = -quad_max(mx_a) * sl, nm_b = -quad_max(mx_b) * sl;
    float l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      sc[4 * n] = ex2(fmaf(sc[4 * n], sl, nm_a));
      sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl, nm_a));
      sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl, nm_b));
      sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl, nm_b));
      l_a += sc[4 * n] + sc[4 * n + 1];
      l_b += sc[4 * n + 2] + sc[4 * n + 3];
    }
    const float il_a = __fdiv_rn(1.f, quad_sum(l_a)), il_b = __fdiv_rn(1.f, quad_sum(l_b));
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      sc[4 * n] *= il_a;
      sc[4 * n + 1] *= il_a;
      sc[4 * n + 2] *= il_b;
      sc[4 * n + 3] *= il_b;
      park[n * 128 + t] = make_float4(sc[4 * n], sc[4 * n + 1], sc[4 * n + 2], sc[4 * n + 3]);
      if (probe != nullptr) probe_quad(probe, 0, plane, bh, row_a, 8 * n + 2 * tq, s, &sc[4 * n]);
    }

    float dp[N / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_keys<N>(dp, sw128_desc(dot_s + kk * 32, 16), sw128_desc(vs + kk * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dp);
    if (qt + G::kGroups < n_qt) {
      // The warpgroup's next tile into the same buffers, once all four of
      // its warps' products have read them.
      named_barrier(1 + c, 128);
      if (t == 0) {
        mbar_expect_tx(&tile_bar[c], 2 * kBox);
        tma_load(qt_s, &q_map, &tile_bar[c], h * 64, (qt + G::kGroups) * 64, b);
        tma_load(dot_s, &do_map, &tile_bar[c], h * 64, (qt + G::kGroups) * 64, b);
      }
    }

    // D = Σ p·dp over the row (p = 0 on masked keys, where dp is finite).
    float d_a = 0.f, d_b = 0.f;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float4 p = park[n * 128 + t];
      d_a += p.x * dp[4 * n] + p.y * dp[4 * n + 1];
      d_b += p.z * dp[4 * n + 2] + p.w * dp[4 * n + 3];
    }
    d_a = quad_sum(d_a);
    d_b = quad_sum(d_b);

    // ds = bf16((p·(dp − D))·scale), packed as dq's A operand (16-key step
    // kk holds 8-key tiles 2kk and 2kk + 1), and dq = ds·k. At N = 256 in
    // two halves of the keys: the first half's products are retired before
    // the second half's operands are packed, so its registers and the dp it
    // consumed are free again (dp's 128 registers and all 64 of ds's spill).
    constexpr int kSteps = N / 16, kHalf = N == 256 ? kSteps / 2 : kSteps;
    unsigned da[kSteps][4];
    float dqa[32];  // overwritten by the first product (scale_d = 0)
    auto grad = [&](int n) {
      const float4 p = park[n * 128 + t];
      dp[4 * n] = (p.x * (dp[4 * n] - d_a)) * scale;
      dp[4 * n + 1] = (p.y * (dp[4 * n + 1] - d_a)) * scale;
      dp[4 * n + 2] = (p.z * (dp[4 * n + 2] - d_b)) * scale;
      dp[4 * n + 3] = (p.w * (dp[4 * n + 3] - d_b)) * scale;
      da[n / 2][2 * (n % 2)] = pack(dp[4 * n], dp[4 * n + 1]);
      da[n / 2][2 * (n % 2) + 1] = pack(dp[4 * n + 2], dp[4 * n + 3]);
      if (probe != nullptr) probe_quad(probe, 2, plane, bh, row_a, 8 * n + 2 * tq, s, &dp[4 * n]);
    };
#pragma unroll
    for (int n = 0; n < 2 * kHalf; ++n) grad(n);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHalf; ++kk)
      wgmma_rs_n64(dqa, da[kk], sw128_desc(ks + kk * 2048, 64 * 128), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dqa);
#pragma unroll
    for (int kk = 0; kk < kHalf; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(da[kk][x])::"memory");
    if constexpr (kHalf < kSteps) {
#pragma unroll
      for (int n = 2 * kHalf; n < N / 8; ++n) grad(n);
      wgmma_fence();
#pragma unroll
      for (int kk = kHalf; kk < kSteps; ++kk)
        wgmma_rs_n64(dqa, da[kk], sw128_desc(ks + kk * 2048, 64 * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dqa);
#pragma unroll
      for (int kk = kHalf; kk < kSteps; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(da[kk][x])::"memory");
    }

    if (tq == 0) {
      if (row_a < s) {
        stats[bh * s + row_a] = nm_a;
        stats[plane + bh * s + row_a] = il_a;
        stats[2 * plane + bh * s + row_a] = d_a;
      }
      if (row_b < s) {
        stats[bh * s + row_b] = nm_b;
        stats[plane + bh * s + row_b] = il_b;
        stats[2 * plane + bh * s + row_b] = d_b;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tq;
      store_pair(dq + slab, row_a, col, dqa[4 * n], dqa[4 * n + 1], s, width, 64, true);
      store_pair(dq + slab, row_b, col, dqa[4 * n + 2], dqa[4 * n + 3], s, width, 64, true);
    }
  }
}

// dK/dV kernel: one warpgroup per (key tile of 64 rows, head, batch row),
// over the 64-query chunks: sᵀ = k·qᵀ and dpᵀ = v·doᵀ, pᵀ and dsᵀ from the
// dQ kernel's statistics, dv += bf16(pᵀ)·do and dk += dsᵀ·q; writes dk and
// dv of every key < s. Two blocks share an SM, so one's loads overlap the
// other's products.
__global__ void __launch_bounds__(128, 2)
short_attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                      const __grid_constant__ CUtensorMap k_map,
                                      const __grid_constant__ CUtensorMap v_map,
                                      const __grid_constant__ CUtensorMap do_map,
                                      const float* __restrict__ stats, bf16* __restrict__ dk,
                                      bf16* __restrict__ dv, float* __restrict__ probe,
                                      int batch, int s, int heads, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int rows = round_up(s, 64), n_t = rows / 64;
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + rows * 128;
  unsigned char* kc = dos + rows * 128;
  unsigned char* vc = kc + kBox;
  float* st_nm = reinterpret_cast<float*>(vc + kBox);
  float* st_il = st_nm + rows;
  float* st_d = st_il + rows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(st_d + rows);

  const int width = heads * 64;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, w = t / 32, lane = t % 32, gq = lane >> 2, tq = lane & 3;
  const size_t bh = (size_t)b * heads + h, plane = (size_t)batch * heads * s;
  const size_t slab = (size_t)b * s * width + (size_t)h * 64;
  const float sl = scale * kLog2e;
  // Causal: query chunks before the key tile see none of its keys.
  const int i0 = causal ? kt : 0;

  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, 2 * (n_t - i0 + 1) * kBox);
    tma_load(kc, &k_map, bar, h * 64, kt * 64, b);
    tma_load(vc, &v_map, bar, h * 64, kt * 64, b);
    for (int x = i0; x < n_t; ++x) {
      tma_load(qs + x * kBox, &q_map, bar, h * 64, x * 64, b);
      tma_load(dos + x * kBox, &do_map, bar, h * 64, x * 64, b);
    }
  }
  // Query rows past s take zero statistics, so their pᵀ and dsᵀ are 0.
  for (int i = t; i < rows; i += 128) {
    const bool in = i < s;
    st_nm[i] = in ? stats[bh * s + i] : 0.f;
    st_il[i] = in ? stats[plane + bh * s + i] : 0.f;
    st_d[i] = in ? stats[2 * plane + bh * s + i] : 0.f;
  }
  __syncthreads();
  mbar_wait(bar, 0);

  // Warp w owns keys 16w .. 16w + 15 of the tile (rows a and b of the
  // accumulator layout), against query columns 8n + 2tq, 8n + 2tq + 1.
  const int k0 = kt * 64, key_a = k0 + 16 * w + gq, key_b = key_a + 8;
  auto live = [&](int key, int row) { return key < s && row < s && (!causal || key <= row); };
  float dka[32], dva[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dka[x] = dva[x] = 0.f;
  // Query chunk i: NQ 8-query tiles from q0 = 64i, products of N = 8·NQ
  // (NQ = 8, or 2 for a ragged last chunk of at most 16 queries, B/16's 4).
  auto chunk = [&](auto nq, int i) {
    constexpr int NQ = decltype(nq)::value;
    const unsigned char* qc = qs + i * kBox;
    const unsigned char* doc = dos + i * kBox;
    const int q0 = i * 64;
    float sc[4 * NQ], dp[4 * NQ];  // overwritten by their products (scale_d = 0)
    auto product = [&](float (&d)[4 * NQ], const unsigned char* a, const unsigned char* b) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NQ == 8)
          wgmma_ss_n64(d, sw128_desc(a + kk * 32, 16), sw128_desc(b + kk * 32, 16), kk > 0);
        else
          wgmma_ss_n16(d, sw128_desc(a + kk * 32, 16), sw128_desc(b + kk * 32, 16), kk > 0);
      }
      wgmma_commit();
    };
    wgmma_fence();
    product(sc, kc, qc);  // sᵀ
    product(dp, vc, doc);  // dpᵀ
    wgmma_wait<1>();  // sᵀ (dpᵀ may still run)
    fence_operands(sc);
    // pᵀ = 2^(sᵀ·scale·log2e − max·scale·log2e) · (1/sum), as the dQ kernel
    // computes p, 0 on pairs that are not live.
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int col = q0 + 8 * n + 2 * tq;
      const float2 nm = *reinterpret_cast<const float2*>(st_nm + col);
      const float2 il = *reinterpret_cast<const float2*>(st_il + col);
      sc[4 * n] = ex2(fmaf(sc[4 * n], sl, nm.x)) * il.x;
      sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl, nm.y)) * il.y;
      sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl, nm.x)) * il.x;
      sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl, nm.y)) * il.y;
    }
    if (q0 + 64 > s || k0 + 64 > s || (causal && q0 <= k0)) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = q0 + 8 * n + 2 * tq;
        sc[4 * n] = live(key_a, col) ? sc[4 * n] : 0.f;
        sc[4 * n + 1] = live(key_a, col + 1) ? sc[4 * n + 1] : 0.f;
        sc[4 * n + 2] = live(key_b, col) ? sc[4 * n + 2] : 0.f;
        sc[4 * n + 3] = live(key_b, col + 1) ? sc[4 * n + 3] : 0.f;
      }
    }
    unsigned pa[NQ / 2][4], da[NQ / 2][4];  // 16-query step kk: 8-query tiles 2kk, 2kk + 1
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      pa[n / 2][2 * (n % 2)] = pack(sc[4 * n], sc[4 * n + 1]);
      pa[n / 2][2 * (n % 2) + 1] = pack(sc[4 * n + 2], sc[4 * n + 3]);
      if (probe != nullptr)
        probe_quad(probe, 1, plane, bh, key_a, q0 + 8 * n + 2 * tq, s, &sc[4 * n], true);
    }
    wgmma_wait<0>();  // dpᵀ
    fence_operands(dp);
    // dsᵀ = bf16((pᵀ·(dpᵀ − D))·scale), D of each query column.
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 dd = *reinterpret_cast<const float2*>(st_d + q0 + 8 * n + 2 * tq);
      dp[4 * n] = (sc[4 * n] * (dp[4 * n] - dd.x)) * scale;
      dp[4 * n + 1] = (sc[4 * n + 1] * (dp[4 * n + 1] - dd.y)) * scale;
      dp[4 * n + 2] = (sc[4 * n + 2] * (dp[4 * n + 2] - dd.x)) * scale;
      dp[4 * n + 3] = (sc[4 * n + 3] * (dp[4 * n + 3] - dd.y)) * scale;
      da[n / 2][2 * (n % 2)] = pack(dp[4 * n], dp[4 * n + 1]);
      da[n / 2][2 * (n % 2) + 1] = pack(dp[4 * n + 2], dp[4 * n + 3]);
      if (probe != nullptr)
        probe_quad(probe, 3, plane, bh, key_a, q0 + 8 * n + 2 * tq, s, &dp[4 * n], true);
    }
    // dv += bf16(pᵀ)·do and dk += dsᵀ·q, dO's and Q's chunk as MN-major B.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk)
      wgmma_rs_n64(dva, pa[kk], sw128_desc(doc + kk * 2048, 64 * 128), 1);
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk)
      wgmma_rs_n64(dka, da[kk], sw128_desc(qc + kk * 2048, 64 * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(pa);
    fence_operands(da);
    fence_operands(dva);
    fence_operands(dka);
  };
  const bool tail = s - (n_t - 1) * 64 <= 16;
  for (int i = i0; i < n_t - (tail ? 1 : 0); ++i) chunk(std::integral_constant<int, 8>(), i);
  if (tail) chunk(std::integral_constant<int, 2>(), n_t - 1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tq;
    store_pair(dv + slab, key_a, col, dva[4 * n], dva[4 * n + 1], s, width, 64, true);
    store_pair(dv + slab, key_b, col, dva[4 * n + 2], dva[4 * n + 3], s, width, 64, true);
    store_pair(dk + slab, key_a, col, dka[4 * n], dka[4 * n + 1], s, width, 64, true);
    store_pair(dk + slab, key_b, col, dka[4 * n + 2], dka[4 * n + 3], s, width, 64, true);
  }
}

// Both kernels of the warpgroup body at N keys (probe: nullptr, or the four
// planes short_attention_bwd_probe describes).
template <int N>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout, void* dq,
                         void* dk, void* dv, void* stats, void* probe, int b, int s, int heads,
                         float scale, int causal, cudaStream_t stream) {
  using G = WgDq<N>;
  CUtensorMap maps[4] = {};
  const void* ptrs[4] = {q, k, v, dout};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = make_map(&maps[i], ptrs[i], b, s, heads * 64);
  if (err == cudaSuccess) err = configure(short_attention_bwd_dq_wgmma_kernel<N>, G::kSmem);
  const size_t smem_dkdv = wg_dkdv_smem(s);
  if (err == cudaSuccess) err = configure(short_attention_bwd_dkdv_wgmma_kernel, smem_dkdv);
  if (err != cudaSuccess) return err;
  short_attention_bwd_dq_wgmma_kernel<N><<<dim3(heads, b), G::kThreads, G::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dq), static_cast<float*>(stats),
      static_cast<float*>(probe), b, s, heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  short_attention_bwd_dkdv_wgmma_kernel<<<dim3((s + 63) / 64, heads, b), 128, smem_dkdv,
                                          stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(stats),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(probe), b, s, heads,
      scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_body(const void* q, const void* k, const void* v, const void* dout,
                              void* dq, void* dk, void* dv, void* stats, void* probe, int b, int s,
                              int heads, float scale, int causal, cudaStream_t stream) {
  switch (wg_keys(s, 64, 1)) {
    case 64:
      return launch_wgmma<64>(q, k, v, dout, dq, dk, dv, stats, probe, b, s, heads, scale, causal,
                              stream);
    case 208:
      return launch_wgmma<208>(q, k, v, dout, dq, dk, dv, stats, probe, b, s, heads, scale,
                               causal, stream);
    case 256:
      return launch_wgmma<256>(q, k, v, dout, dq, dk, dv, stats, probe, b, s, heads, scale,
                               causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int N>
int occupancy_wgmma(int s, int which) {
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    err = configure(short_attention_bwd_dq_wgmma_kernel<N>, WgDq<N>::kSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, short_attention_bwd_dq_wgmma_kernel<N>, WgDq<N>::kThreads, WgDq<N>::kSmem);
  } else {
    err = configure(short_attention_bwd_dkdv_wgmma_kernel, wg_dkdv_smem(s));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, short_attention_bwd_dkdv_wgmma_kernel, 128, wg_dkdv_smem(s));
  }
  return err == cudaSuccess ? blocks : 0;
}

// The dQ kernel's dynamic shared memory at this length (0 where the body
// does not run).
size_t wg_dq_smem(int s) {
  switch (wg_keys(s, 64, 1)) {
    case 64: return WgDq<64>::kSmem;
    case 208: return WgDq<208>::kSmem;
    case 256: return WgDq<256>::kSmem;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of either kernel of the wmma body needs,
// bytes (mirrored by ops/short_attention.py::short_attention_bwd_smem_bytes,
// a term of the towers' dispatch).
long long short_attention_bwd_smem_bytes(int s, int dh) { return (long long)geometry(s, dh).smem; }

// Dynamic shared memory of one block of the warpgroup body's dQ (which = 0)
// or dK/dV (1) kernel at length s, bytes; 0 where the body does not run
// (mirrored by ops/short_attention.py::short_attention_bwd_wgmma_smem_bytes).
long long short_attention_bwd_wgmma_smem_bytes(int s, int which) {
  if (!wg_keys(s, 64, 1)) return 0;
  return (long long)(which == 0 ? wg_dq_smem(s) : wg_dkdv_smem(s));
}

// The body a call takes: 1 = the warpgroup body (wgmma fed by TMA), 0 = the
// wmma body (mirrored by ops/short_attention.py::short_attention_bwd_body).
int short_attention_bwd_body(int s, int dh, int vec) { return wg_keys(s, dh, vec) ? 1 : 0; }

// q, k, v, dout, dq, dk, dv: (b, s, heads·dh) bf16, contiguous; stats:
// 3·b·heads·s f32 scratch (three statistics per query row), written by the
// first kernel and read by the second. Returns the cudaError_t of the
// launches (0 on success); they do not synchronise.
int short_attention_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, void* stats, int b, int s, int heads, int dh,
                        float scale, int causal, int vec, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || heads < 1 || heads > 65535 || dh < 1 ||
      dh > 16 * kMaxHeadTiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wg_keys(s, dh, vec))
    return (int)launch_wgmma_body(q, k, v, dout, dq, dk, dv, stats, nullptr, b, s, heads, scale,
                                  causal, st);
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

// The warpgroup body as short_attention_bwd runs it, also writing to probe
// (4·b·heads·s·s f32, zeroed by the caller) the f32 p and ds of every
// (query, key) pair below s that each kernel computes: planes 0 and 2 from
// the dQ kernel, 1 and 3 from the dK/dV kernel, each [b][head][query][key].
// For checks that the two kernels agree bit for bit; cudaErrorInvalidValue
// where the body does not run.
int short_attention_bwd_probe(const void* q, const void* k, const void* v, const void* dout,
                              void* dq, void* dk, void* dv, void* stats, void* probe, int b, int s,
                              int heads, float scale, int causal, void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || !wg_keys(s, 64, 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma_body(q, k, v, dout, dq, dk, dv, stats, probe, b, s, heads, scale,
                                causal, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of kernel `which` (0: dq, 1: dk/dv) of the body a
// call at this shape takes (0 with an error), for the records.
int short_attention_bwd_occupancy(int s, int dh, int vec, int which) {
  if (s < 1 || dh < 1 || dh > 16 * kMaxHeadTiles) return 0;
  switch (wg_keys(s, dh, vec)) {
    case 64: return occupancy_wgmma<64>(s, which);
    case 208: return occupancy_wgmma<208>(s, which);
    case 256: return occupancy_wgmma<256>(s, which);
    default: break;
  }
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
