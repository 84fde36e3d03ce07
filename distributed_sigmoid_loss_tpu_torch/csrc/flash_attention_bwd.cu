// Flash (blockwise) self-attention backward for Hopper (sm_90a): K7 dkv and
// K7 dq, with the small di pass they share.
//
// Replaces the two backward pallas_calls of jax/experimental/pallas/ops/tpu/
// flash_attention.py that distributed_sigmoid_loss_tpu/ops/flash_attention.py
// ::flash_self_attention (:72, kernel call :110) differentiates through
// (_flash_attention_bwd): the dK/dV call (body _flash_attention_dkv_kernel)
// and the dQ call (body _flash_attention_dq_kernel), keeping the upstream
// two-pass split and its rounding points. From the forward's bf16 output o
// and its f32 row statistics m and l (flash_attention.cu), per (batch row,
// head):
//   di = rowsum(f32(o) ⊙ f32(do))           the rounded output, as upstream
//   p  = exp(f32(q·kᵀ)·scale − m) · (1/l)   normalised, f32
//   dv = Σ bf16(p)ᵀ·do,  dp = do·vᵀ         f32
//   ds = ((dp − di) ⊙ p) · scale
//   dk = Σ bf16(ds)ᵀ·q,  dq = Σ bf16(ds)·k  f32 sums, bf16 at the end.
// The dkv kernel owns a 64-key tile and loops over every query tile; the dq
// kernel owns a 64-row query tile and loops over every key tile. Each output
// element is written by one thread and there are no atomics, so the
// gradients are bitwise repeatable.
//
// Bound on this card: at SigLIP-B/16 at 512 px (b=32, s=1024, h=12, dh=64)
// q, k, v, do read once and dq, dk, dv written once are 7·32·1024·768·2 B =
// 352 MB, 105 µs at 3.35 TB/s, while the five products are
// 5·2·32·12·1024²·64 = 258 GFLOP, 261 µs at 989 TFLOP/s: the tensor cores
// bound the pair. (The two-pass split computes q·kᵀ and do·vᵀ in both
// kernels: seven products, the price of no atomics.)
//
// Design. Both kernels are four warps of 16 rows, as the forward:
//   dkv: a warp owns 16 keys. K and V of the block's tile stay in shared
//   memory; query tiles (Q, dO and their m, 1/l, di) stream through a
//   two-stage cp.async ring. The warp computes sᵀ = k·qᵀ and dpᵀ = v·doᵀ
//   directly (16 keys × 64 queries in registers), so bf16(pᵀ) and bf16(dsᵀ)
//   are A operands as they stand, and do and q enter dv and dk through
//   ldmatrix.trans. Causal blocks skip the query tiles above their diagonal.
//   dq: a warp owns 16 query rows, whose m, 1/l and di stay in registers; key
//   and value tiles stream through the ring; bf16(ds) feeds ds·k with K
//   through ldmatrix.trans. Causal blocks stop at their diagonal tile.
// The ragged tail is zero-filled in shared memory and masked by index (p = 0
// there). Rounded intrinsics keep the compiler from contracting the chain
// into FMAs, so the kernels round where their plain versions do.

#include "short_attention_common.cuh"

using namespace short_attention;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;  // rows of every tile: 16 per warp, 8 mma n-tiles
constexpr int kMaxHeadDim = 128;
constexpr int kDiWarps = 8;

struct Geometry {
  int dh_pad;   // head dim padded to the 16-deep MMA step
  int ld;       // row stride of every tile, bf16 elements (+8: conflict-free ldmatrix)
  size_t smem;  // dynamic shared memory of one block of either kernel, bytes
};

// Layout: two resident tiles (dkv: K, V; dq: Q, dO), two stages of two
// streamed tiles (dkv: Q, dO; dq: K, V), then two stages of the streamed
// query tile's m, 1/l and di (dkv only), f32.
__host__ __device__ inline Geometry geometry(int dh) {
  Geometry g;
  g.dh_pad = round_up(dh, 16);
  g.ld = g.dh_pad + 8;
  g.smem = (size_t)(2 + 2 * 2) * kTile * g.ld * sizeof(bf16) + (size_t)2 * 3 * kTile * sizeof(float);
  return g;
}

// di[(b, h), row] = Σ_d f32(o) · f32(do) over one (b, row, h) row; one warp per row.
__global__ void __launch_bounds__(kDiWarps * 32)
flash_attention_di_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                          float* __restrict__ di, int rows, int s, int heads, int dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kDiWarps + warp;  // row of the (b·s·heads, dh) view
  if (row >= rows) return;
  const bf16* o = out + (size_t)row * dh;
  const bf16* g = dout + (size_t)row * dh;
  float sum = 0.f;
  for (int d = lane; d < dh; d += 32)
    sum = __fadd_rn(sum, __fmul_rn(__bfloat162float(o[d]), __bfloat162float(g[d])));
  sum = warp_sum(sum);
  if (lane == 0) {
    const int h = row % heads, bs = row / heads;
    di[((size_t)(bs / s) * heads + h) * s + bs % s] = sum;
  }
}

// Copy query tile i of Q and dO into one stage, and its rows' m, 1/l and di
// (zero past s) into the stage's row statistics.
__device__ inline void stage_query_tile(bf16* qd, float* rows, const bf16* q, const bf16* dout,
                                        const float* st_m, const float* st_l, const float* di,
                                        int i, const Geometry& g, int s, int width, int dh,
                                        int tid, bool vec) {
  const int r0 = i * kTile;
  load_tile(qd, q, r0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  load_tile(qd + kTile * g.ld, dout, r0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  for (int x = tid; x < kTile; x += kThreads) {
    const int row = r0 + x;
    const bool live = row < s;
    rows[x] = live ? st_m[row] : 0.f;
    rows[kTile + x] = live ? __fdiv_rn(1.f, st_l[row]) : 0.f;
    rows[2 * kTile + x] = live ? di[row] : 0.f;
  }
}

template <int DT>  // DT = dh_pad / 16
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ stats, const float* __restrict__ di,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int heads,
                               int dh, float scale, int causal, int vec) {
  constexpr int NT8 = 2 * DT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(dh);
  const int width = heads * dh;
  const int n_tiles = (s + kTile - 1) / kTile;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;  // causal: kt = 0 is heaviest
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, ri = lane & 7;
  const int k0 = kt * kTile;
  const int key_a = k0 + warp * 16 + gq, key_b = key_a + 8;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  const float* st_m = stats + ((size_t)b * heads + h) * 2 * s;
  const float* st_l = st_m + s;
  const float* di_bh = di + ((size_t)b * heads + h) * s;
  const int tile = kTile * g.ld;

  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + tile;
  bf16* qd = vs + tile;                                 // stage st: Q at qd + 2·st·tile, dO after
  float* rows = reinterpret_cast<float*>(qd + 4 * tile);  // stage st: rows + 3·st·kTile

  // Query tiles wholly before the key tile are masked out whole (causal).
  const int i0 = causal ? kt : 0;
  load_tile(ks, k + slab, k0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  load_tile(vs, v + slab, k0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  stage_query_tile(qd, rows, q + slab, dout + slab, st_m, st_l, di_bh, i0, g, s, width, dh, tid,
                   vec);
  cp_async_commit();

  float dka[NT8][4], dva[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = i0; i < n_tiles; ++i) {
    const int stg = (i - i0) & 1;
    if (i + 1 < n_tiles) {
      stage_query_tile(qd + 2 * (stg ^ 1) * tile, rows + 3 * (stg ^ 1) * kTile, q + slab,
                       dout + slab, st_m, st_l, di_bh, i + 1, g, s, width, dh, tid, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = qd + 2 * stg * tile;
    const bf16* dos = qs + tile;
    const float* r_m = rows + 3 * stg * kTile;
    const float* r_il = r_m + kTile;
    const float* r_di = r_il + kTile;
    const int q0 = i * kTile;

    // sᵀ = k·qᵀ: the warp's 16 keys × 64 queries.
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      unsigned ka[4];
      ldsm_x4(ka, ks + (warp * 16 + ri + (mi & 1) * 8) * g.ld + t * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        unsigned bq[4];
        ldsm_x4(bq, qs + (8 * n + ri + (mi >> 1) * 8) * g.ld + t * 16 + (mi & 1) * 8);
        mma(sc[n], ka, bq[0], bq[1]);
        mma(sc[n + 1], ka, bq[2], bq[3]);
      }
    }

    // pᵀ = exp(s·scale − m_q) · (1/l_q) on live (key, query) pairs, else 0.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_a : key_b, ql = 8 * n + 2 * tq + (e & 1), qrow = q0 + ql;
        const bool live = key < s && qrow < s && (!causal || key <= qrow);
        const float x = __fmul_rn(sc[n][e], scale);
        const float p = __fmul_rn(expf(__fsub_rn(x, r_m[ql])), r_il[ql]);
        sc[n][e] = live ? p : 0.f;
      }
    }
    unsigned pa[4][4];  // bf16(pᵀ) as the A operand, 16 queries per step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
    // dv += bf16(pᵀ)·do, dO by ldmatrix.trans.
#pragma unroll
    for (int nd = 0; nd < NT8; nd += 2) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned bd[4];
        ldsm_x4_t(bd, dos + (16 * kk + ri + (mi & 1) * 8) * g.ld + (nd + (mi >> 1)) * 8);
        mma(dva[nd], pa[kk], bd[0], bd[1]);
        mma(dva[nd + 1], pa[kk], bd[2], bd[3]);
      }
    }

    // dpᵀ = v·doᵀ.
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      unsigned va[4];
      ldsm_x4(va, vs + (warp * 16 + ri + (mi & 1) * 8) * g.ld + t * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        unsigned bd[4];
        ldsm_x4(bd, dos + (8 * n + ri + (mi >> 1) * 8) * g.ld + t * 16 + (mi & 1) * 8);
        mma(dp[n], va, bd[0], bd[1]);
        mma(dp[n + 1], va, bd[2], bd[3]);
      }
    }
    // dsᵀ = ((dpᵀ − di_q) ⊙ pᵀ) · scale, bf16 as the A operand.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * n + 2 * tq + (e & 1);
        dp[n][e] = __fmul_rn(__fmul_rn(__fsub_rn(dp[n][e], r_di[ql]), sc[n][e]), scale);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack(dp[2 * kk][0], dp[2 * kk][1]);
      pa[kk][1] = pack(dp[2 * kk][2], dp[2 * kk][3]);
      pa[kk][2] = pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      pa[kk][3] = pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dk += bf16(dsᵀ)·q, Q by ldmatrix.trans.
#pragma unroll
    for (int nd = 0; nd < NT8; nd += 2) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned bq[4];
        ldsm_x4_t(bq, qs + (16 * kk + ri + (mi & 1) * 8) * g.ld + (nd + (mi >> 1)) * 8);
        mma(dka[nd], pa[kk], bq[0], bq[1]);
        mma(dka[nd + 1], pa[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();  // the stage is refilled in the next iteration but one
  }

#pragma unroll
  for (int nd = 0; nd < NT8; ++nd) {
    const int col = nd * 8 + 2 * tq;
    store_pair(dv + slab, key_a, col, dva[nd][0], dva[nd][1], s, width, dh, vec);
    store_pair(dv + slab, key_b, col, dva[nd][2], dva[nd][3], s, width, dh, vec);
    store_pair(dk + slab, key_a, col, dka[nd][0], dka[nd][1], s, width, dh, vec);
    store_pair(dk + slab, key_b, col, dka[nd][2], dka[nd][3], s, width, dh, vec);
  }
}

template <int DT>  // DT = dh_pad / 16
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ stats, const float* __restrict__ di,
                              bf16* __restrict__ dq, int s, int heads, int dh, float scale,
                              int causal, int vec) {
  constexpr int NT8 = 2 * DT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(dh);
  const int width = heads * dh;
  const int n_tiles = (s + kTile - 1) / kTile;
  const int qt = causal ? n_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, ri = lane & 7;
  const int q0 = qt * kTile;
  const int row_a = q0 + warp * 16 + gq, row_b = row_a + 8;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  const float* st_m = stats + ((size_t)b * heads + h) * 2 * s;
  const float* st_l = st_m + s;
  const float* di_bh = di + ((size_t)b * heads + h) * s;
  const int tile = kTile * g.ld;
  const int n_visit = causal ? qt + 1 : n_tiles;

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + tile;
  bf16* kv = dos + tile;  // stage st: K at kv + 2·st·tile, V one tile after

  load_tile(qs, q + slab, q0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  load_tile(dos, dout + slab, q0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  load_tile(kv, k + slab, 0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  load_tile(kv + tile, v + slab, 0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  cp_async_commit();

  const float m_a = row_a < s ? st_m[row_a] : 0.f, m_b = row_b < s ? st_m[row_b] : 0.f;
  const float il_a = row_a < s ? __fdiv_rn(1.f, st_l[row_a]) : 0.f;
  const float il_b = row_b < s ? __fdiv_rn(1.f, st_l[row_b]) : 0.f;
  const float di_a = row_a < s ? di_bh[row_a] : 0.f, di_b = row_b < s ? di_bh[row_b] : 0.f;
  float dqa[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int j = 0; j < n_visit; ++j) {
    if (j + 1 < n_visit) {
      bf16* nk = kv + 2 * ((j + 1) & 1) * tile;
      const int r0 = (j + 1) * kTile;
      load_tile(nk, k + slab, r0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
      load_tile(nk + tile, v + slab, r0, kTile, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv + 2 * (j & 1) * tile;
    const bf16* vs = ks + tile;
    const int k0 = j * kTile;

    // s = q·kᵀ and dp = do·vᵀ: the warp's 16 rows × 64 keys.
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int a_off = (warp * 16 + ri + (mi & 1) * 8) * g.ld + t * 16 + (mi >> 1) * 8;
      unsigned qa[4], da[4];
      ldsm_x4(qa, qs + a_off);
      ldsm_x4(da, dos + a_off);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        const int b_off = (8 * n + ri + (mi >> 1) * 8) * g.ld + t * 16 + (mi & 1) * 8;
        unsigned bk[4], bv[4];
        ldsm_x4(bk, ks + b_off);
        ldsm_x4(bv, vs + b_off);
        mma(sc[n], qa, bk[0], bk[1]);
        mma(sc[n + 1], qa, bk[2], bk[3]);
        mma(dp[n], da, bv[0], bv[1]);
        mma(dp[n + 1], da, bv[2], bv[3]);
      }
    }

    // p = exp(s·scale − m) · (1/l) on live pairs (else 0), then
    // ds = ((dp − di) ⊙ p) · scale as the bf16 A operand.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b, key = k0 + 8 * n + 2 * tq + (e & 1);
        const bool live = key < s && row < s && (!causal || key <= row);
        const float x = __fmul_rn(sc[n][e], scale);
        const float p = __fmul_rn(expf(__fsub_rn(x, e < 2 ? m_a : m_b)), e < 2 ? il_a : il_b);
        const float d = __fsub_rn(dp[n][e], e < 2 ? di_a : di_b);
        dp[n][e] = live ? __fmul_rn(__fmul_rn(d, p), scale) : 0.f;
      }
    }
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack(dp[2 * kk][0], dp[2 * kk][1]);
      pa[kk][1] = pack(dp[2 * kk][2], dp[2 * kk][3]);
      pa[kk][2] = pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      pa[kk][3] = pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dq += bf16(ds)·k, K by ldmatrix.trans.
#pragma unroll
    for (int nd = 0; nd < NT8; nd += 2) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned bk[4];
        ldsm_x4_t(bk, ks + (16 * kk + ri + (mi & 1) * 8) * g.ld + (nd + (mi >> 1)) * 8);
        mma(dqa[nd], pa[kk], bk[0], bk[1]);
        mma(dqa[nd + 1], pa[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // the stage is refilled in the next iteration but one
  }

#pragma unroll
  for (int nd = 0; nd < NT8; ++nd) {
    const int col = nd * 8 + 2 * tq;
    store_pair(dq + slab, row_a, col, dqa[nd][0], dqa[nd][1], s, width, dh, vec);
    store_pair(dq + slab, row_b, col, dqa[nd][2], dqa[nd][3], s, width, dh, vec);
  }
}

template <int DT>
cudaError_t configure(const Geometry& g) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<DT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
}

template <int DT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* stats, const void* di, void* dk, void* dv, int b, int s,
                       int heads, int dh, float scale, int causal, int vec, cudaStream_t stream) {
  const Geometry g = geometry(dh);
  const cudaError_t err = configure<DT>(g);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kTile - 1) / kTile, heads, b);
  flash_attention_bwd_dkv_kernel<DT><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, heads,
      dh, scale, causal, vec);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* stats, const void* di, void* dq, int b, int s, int heads,
                      int dh, float scale, int causal, int vec, cudaStream_t stream) {
  const Geometry g = geometry(dh);
  const cudaError_t err = configure<DT>(g);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kTile - 1) / kTile, heads, b);
  flash_attention_bwd_dq_kernel<DT><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(di), static_cast<bf16*>(dq), s, heads, dh, scale, causal, vec);
  return cudaGetLastError();
}

template <int DT>
int occupancy(const Geometry& g, int which) {
  int blocks = 0;
  cudaError_t err = configure<DT>(g);
  if (err == cudaSuccess)
    err = which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, flash_attention_bwd_dkv_kernel<DT>, kThreads, g.smem)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, flash_attention_bwd_dq_kernel<DT>, kThreads, g.smem);
  return err == cudaSuccess ? blocks : 0;
}

bool takes(int b, int s, int heads, int dh) {
  return b >= 1 && b <= 65535 && s >= 1 && heads >= 1 && heads <= 65535 && dh >= 8 &&
         dh <= kMaxHeadDim && dh % 8 == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of either kernel, bytes (mirrored by
// ops/flash_attention.py::flash_attention_bwd_smem_bytes).
long long flash_attention_bwd_smem_bytes(int dh) { return (long long)geometry(dh).smem; }

// q, k, v, out, dout, dk, dv: (b, s, heads·dh) bf16, contiguous; stats:
// (b, heads, 2, s) f32 from flash_attention_fwd; di: (b, heads, s) f32,
// written here for flash_attention_bwd_dq. Two launches (di, then dk/dv);
// returns the first cudaError_t that is not 0, and does not synchronise.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* out,
                            const void* dout, const void* stats, void* di, void* dk, void* dv,
                            int b, int s, int heads, int dh, float scale, int causal, int vec,
                            void* stream) {
  if (!takes(b, s, heads, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * s * heads;
  flash_attention_di_kernel<<<(rows + kDiWarps - 1) / kDiWarps, kDiWarps * 32, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(di),
      rows, s, heads, dh);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define FA_DKV(DT) \
  case DT:         \
    return (int)launch_dkv<DT>(q, k, v, dout, stats, di, dk, dv, b, s, heads, dh, scale, causal, vec, st);
  switch (round_up(dh, 16) / 16) {
    FA_DKV(1) FA_DKV(2) FA_DKV(3) FA_DKV(4) FA_DKV(5) FA_DKV(6) FA_DKV(7) FA_DKV(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_DKV
}

// As flash_attention_bwd_dkv, for dq; di is the one it wrote. One launch.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* stats, const void* di, void* dq, int b, int s, int heads,
                           int dh, float scale, int causal, int vec, void* stream) {
  if (!takes(b, s, heads, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DQ(DT) \
  case DT:        \
    return (int)launch_dq<DT>(q, k, v, dout, stats, di, dq, b, s, heads, dh, scale, causal, vec, st);
  switch (round_up(dh, 16) / 16) {
    FA_DQ(1) FA_DQ(2) FA_DQ(3) FA_DQ(4) FA_DQ(5) FA_DQ(6) FA_DQ(7) FA_DQ(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_DQ
}

// Resident blocks per SM of the dkv (which = 0) or dq (1) kernel at this
// head dim (0 with an error), for the records.
int flash_attention_bwd_occupancy(int dh, int which) {
  if (!takes(1, 1, 1, dh)) return 0;
  const Geometry g = geometry(dh);
#define FA_OCC(DT) \
  case DT:         \
    return occupancy<DT>(g, which);
  switch (g.dh_pad / 16) {
    FA_OCC(1) FA_OCC(2) FA_OCC(3) FA_OCC(4) FA_OCC(5) FA_OCC(6) FA_OCC(7) FA_OCC(8)
    default: return 0;
  }
#undef FA_OCC
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
