// Head-batched short-sequence self-attention backward for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel distributed_sigmoid_loss_tpu/ops/
// pallas_short_attention.py::_short_attention_bwd with the body
// _bwd_kernel_batched (selected by set_bwd_batch_heads): the same function as
// the per-head backward K2 (short_attention_bwd.cu), at the same rounding
// points, per (batch row, head):
//   p  = softmax(q·kᵀ·scale [causal mask])        f32
//   dv = bf16(p)ᵀ · do
//   dp = do · vᵀ                                   f32
//   ds = bf16(p ⊙ (dp − rowsum(dp ⊙ p)) · scale)
//   dq = ds · k,  dk = dsᵀ · q
// with bf16 tensor-core products accumulated in f32 and bf16 outputs.
//
// What makes it K3 and not K2: the TPU kernel computes the chain once and
// issues each of the five products once. Every kernel here is one launch
// per backward call with one block per (head, batch row); the warpgroup
// body and the two-array kernel compute every logit, exp and dp once and
// issue five products (the in-place kernel, below, seven). K2 is two
// kernels whose second recomputes the logits and dp tile by tile: seven
// products and every exp twice.
//
// Bound on this card: memory, as K2's. At ViT-B/16 vision, b=128 (s=196,
// h=12, dh=64), q, k, v, do read once and dq, dk, dv written once are
// 7·128·196·768·2 B ≈ 270 MB, ≈ 80.5 µs at 3.35 TB/s, while the five
// products are 5·2·128·12·196²·64 ≈ 37.8 GFLOP, ≈ 38.2 µs at 989 TFLOP/s.
//
// Two bodies, picked by shape before launch (short_attention_bwd_batched_body).
//
// - The warpgroup body (head dim 64, 16-byte rows, s_pad <= 256: every
//   dh-64 shape K3 takes, B/16's vision s=196 and text s=64 and JAX's
//   longest lengths s=225..250 at width 768 and 212 at 1,024). wgmma fed by
//   TMA (3-D tensor maps over the native (b, s, h·dh) layout, rows past s
//   zero-filled, 128-byte swizzle). K and V of the head stay resident; the
//   64-row query tiles stream through a two-stage ring of Q and dO. Three
//   warpgroups, each within the 168 registers a thread of 384 may have:
//   * the producer, per query tile, does K2's dQ work at N keys (64, 208 or
//     256: the N of K2's warpgroup body): x = q·kᵀ as an m64·nN·k64 chain,
//     the softmax in registers (row statistics by quad shuffles, p =
//     2^(x·scale·log2e − max·scale·log2e)·(1/sum)), f32 p parked in shared
//     memory while dp = do·vᵀ fills the registers, D = Σ p·dp. It writes the
//     tile's bf16(p) and ds = bf16((p·(dp − D))·scale) by stmatrix into
//     panels of 64 query rows × 64 keys, laid out as TMA's 128-byte swizzle
//     (zero past N), forms dq = ds·k with the ds panels as the K-major A
//     operand and stores it by TMA through the park's first 8 KB, and
//     issues the TMA load of the next tile once both consumers are done
//     with the last one;
//   * two consumers accumulate, for every 64-key tile and over the query
//     tiles, dv += bf16(p)ᵀ·dO (one warpgroup) and dk += dsᵀ·Q (the other):
//     m64n64k16 wgmma with both operands MN-major in shared memory (the
//     panel as the transposed A, the tile's dO or Q as the transposed B),
//     four key tiles of accumulators, 128 registers, a thread. Causal key
//     tiles past the query tile's diagonal are skipped. dk and dv are
//     written once, at the end, by TMA: dv through its own panels, dk
//     through the park past the dq box.
//   One query tile after another: the producer's next logits overlap the
//   consumers' products, and the next tile's Q and dO arrive while the
//   producer works on this one. s <= 64 has one query tile: one warpgroup
//   forms all five products in turn and three blocks share an SM.
//   Every sequence of products is straight-line code, waited for before the
//   loop's back edge (ptxas serialises the wgmmas of a loop that keeps one
//   in flight across it or issues them in divergent branches). Rows past s
//   keep every key below s live, so their values stay finite; their dO and
//   Q rows are zero, so they add nothing to dv and dk, and the TMA stores
//   write no row past s. Every output goes out through a 64 × 64 box in
//   shared memory, laid out by stmatrix as TMA's swizzle: 4-byte stores
//   straight from the accumulators, eight rows a warp instruction, were
//   slower (PERF.md §6). Shared memory by the
//   keys N of the products, and the blocks an SM holds by it (228 KB, 1 KB
//   reserved a block):
//      keys  warpgroups     bytes  blocks
//        64           1    66,600       3
//       208           3   218,160       1
//       256           3   230,448       1
//   (1 KB of alignment slack; K and V over 64 or 256 rows of 128 bytes; one
//   or two stages of a Q and a dO tile; the bf16(p) and ds panels, one or
//   four of 64 × 64; the parked p, N/2 floats a producer thread; six
//   barriers, or five at one stage.)
//
// - The mma.sync kernels (every other shape K3 takes: head dims 72 and 20,
//   rows not 16-byte aligned), eight warps of 16 rows fed by ldmatrix. The
//   two-array kernel keeps the head's whole bf16(p) and ds, (s_pad × s_pad)
//   each, in shared memory beside one pair of the head's (s_pad × dh_pad)
//   operands (first K and V, then Q and dO), rows of 64 bf16 with their
//   16-byte chunks XOR-swizzled by the row:
//   Phase A, query rows: each warp owns 16 query rows. It computes its
//   16 × s_pad dp = do·vᵀ and parks it in f32 in its own rows of the bf16(p)
//   and ds arrays, keeps the 16 × s_pad logits q·kᵀ in registers, takes the
//   softmax there, reads dp back for D = rowsum(dp ⊙ p), and writes bf16(p)
//   and ds over the parked dp. Its dq = ds·k takes ds straight from
//   registers as the A operand.
//   Phase B, key rows: after a block barrier Q and dO replace K and V, and
//   each warp owns 16 key rows: dv = bf16(p)ᵀ·do and dk = dsᵀ·q, with the
//   transposes read by ldmatrix.trans from the shared arrays.
//   q and do rows of phase A are read as mma fragments straight from global
//   memory (L2). The ragged edge is zero-padded in shared memory and
//   masked; causal masks by key, and phase B skips the query tiles that are
//   masked whole.
//   The in-place kernel, for the lengths where the two (s_pad × s_pad)
//   arrays do not fit (JAX's K3 takes s <= 208 at 1,152 / 16, dh = 72, and
//   the mma.sync kernels take s up to 256 at the narrower heads), keeps ONE
//   (s_pad × s_pad) bf16 array beside three operand slots (K, V then Q, dO)
//   and the rows' (m, 1/l, D):
//     A  query rows: logits and softmax in registers, D = rowsum(p ⊙ dp)
//        with dp eight keys at a time (dO and V from shared memory), bf16(p)
//        into the array, (m, 1/l, D) saved;
//     B1 key rows: dv = bf16(p)ᵀ·dO;
//     B2 query rows: the logits and dp again, p from the saved (m, 1/l), so
//        bit-identical to A's; ds = bf16(p ⊙ (dp − D)·scale) over bf16(p) in
//        the warp's own rows, and dq = ds·k from the registers;
//     B3 Q replaces V; key rows: dk = dsᵀ·q.
//   Seven products (the logits and dp twice), so it runs only where the
//   two-array kernel does not fit: s_pad > 208, or dh too wide for two
//   arrays.
//
// In every kernel each output element is written by one thread and there are
// no atomics, so runs are bitwise repeatable.

#include "short_attention_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

using namespace short_attention;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKeyTiles = 13;  // two arrays: s <= 208, the logits of 16 rows in registers
constexpr int kMinKeyTilesInPlace = 9;   // below, two arrays fit at every dh <= 128
constexpr int kMaxKeyTilesInPlace = 16;  // in place: s <= 256
constexpr int kMaxHeadDim = 128;
constexpr int kMaxDhTiles8 = kMaxHeadDim / 8;

struct Geometry {
  int s_pad;    // sequence padded to the 16-row MMA tile
  int dh_pad;   // head dim padded to 16
  bool swizzle; // operand rows of whole 128-byte groups: XOR-swizzled chunks
  size_t smem;  // dynamic shared memory of one block, bytes
};

// Block layout: bf16(p) [s_pad][s_pad], ds [s_pad][s_pad], then two operands
// [s_pad][dh_pad] (K and V in phase A, Q and dO in phase B), all bf16.
__host__ __device__ inline Geometry geometry(int s, int dh) {
  Geometry g;
  g.s_pad = round_up(s, 16);
  g.dh_pad = round_up(dh, 16);
  g.swizzle = g.dh_pad % 64 == 0;
  g.smem = (size_t)2 * g.s_pad * g.s_pad * sizeof(bf16) +
           (size_t)2 * g.s_pad * g.dh_pad * sizeof(bf16);
  return g;
}

// The in-place variant: one [s_pad][s_pad] array (bf16(p), then ds), three
// operands [s_pad][dh_pad] (K; V then Q; dO) in bf16 and three f32 row
// statistics per query.
__host__ __device__ inline Geometry geometry_inplace(int s, int dh) {
  Geometry g = geometry(s, dh);
  g.smem = (size_t)g.s_pad * g.s_pad * sizeof(bf16) +
           (size_t)3 * g.s_pad * g.dh_pad * sizeof(bf16) + (size_t)3 * g.s_pad * sizeof(float);
  return g;
}

// Element offset of operand row r, 16-byte chunk c (8 bf16).
__device__ inline int chunk_offset(const Geometry& g, int r, int c) {
  return r * g.dh_pad + (g.swizzle ? (c ^ (r & 7)) : c) * 8;
}

// The head's whole (s, dh) slice into an operand [s_pad][dh_pad], zero-filled
// past s and dh, by every thread of the block; the caller waits and syncs.
__device__ inline void load_operand(bf16* dst, const bf16* src, const Geometry& g, int s,
                                    int width, int dh, int tid, bool vec) {
  const int chunks = g.dh_pad / 8;
  if (vec) {
    for (int i = tid; i < g.s_pad * chunks; i += kThreads) {
      const int r = i / chunks, c = i % chunks;
      const bool live = r < s && c * 8 < dh;
      cp_async16(dst + chunk_offset(g, r, c), live ? src + (size_t)r * width + c * 8 : src,
                 live ? 16 : 0);
    }
  } else {
    for (int i = tid; i < g.s_pad * g.dh_pad; i += kThreads) {
      const int r = i / g.dh_pad, c = i % g.dh_pad;
      bf16 val = __float2bfloat16(0.f);
      if (r < s && c < dh) val = src[(size_t)r * width + c];
      dst[chunk_offset(g, r, c / 8) + c % 8] = val;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
short_attention_bwd_batched_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   bf16* __restrict__ dq, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int s, int heads, int dh, float scale,
                                   int causal, int vec) {
  constexpr int S_PAD = NT * 16;
  constexpr int NJ = 2 * NT;  // 8-key tiles of a row's logits
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(s, dh);
  const int width = heads * dh;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;       // mma fragment row and column pair
  const int mi = lane >> 3, ri = lane & 7;       // ldmatrix: matrix and row this lane addresses
  const int dt8 = g.dh_pad / 8;                  // 8-wide head-dim tiles

  bf16* plo = reinterpret_cast<bf16*>(smem_raw);  // bf16(p) [query][key]
  bf16* dsm = plo + S_PAD * S_PAD;                // ds [query][key]
  bf16* opa = dsm + S_PAD * S_PAD;                // K, then Q
  bf16* opb = opa + S_PAD * g.dh_pad;             // V, then dO

  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  load_operand(opa, k + slab, g, s, width, dh, tid, vec);
  load_operand(opb, v + slab, g, s, width, dh, tid, vec);
  cp_async_wait_all();
  __syncthreads();

  // ---- Phase A: a warp owns 16 query rows -------------------------------
  for (int rt = warp; rt < NT; rt += kWarps) {
    const int r0 = rt * 16, row_a = r0 + gq, row_b = r0 + gq + 8;
    float acc[NJ][4];

    // dp = do · vᵀ, parked in f32 in this tile's rows of the p and ds arrays
    // (each lane reads back only what it wrote).
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kd = 0; kd < dt8; kd += 2) {
      const int col = kd * 8 + 2 * tq;
      const unsigned a[4] = {load_pair(dout + slab, row_a, col, s, width, dh, vec),
                             load_pair(dout + slab, row_b, col, s, width, dh, vec),
                             load_pair(dout + slab, row_a, col + 8, s, width, dh, vec),
                             load_pair(dout + slab, row_b, col + 8, s, width, dh, vec)};
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        unsigned bv[4];
        ldsm_x4(bv, opb + chunk_offset(g, 8 * j + ri + (mi >> 1) * 8, kd + (mi & 1)));
        mma(acc[j], a, bv[0], bv[1]);
        mma(acc[j + 1], a, bv[2], bv[3]);
      }
    }
    float* park_a = reinterpret_cast<float*>(plo + r0 * S_PAD) + gq * S_PAD + 2 * tq;
    float* park_b = reinterpret_cast<float*>(dsm + r0 * S_PAD) + gq * S_PAD + 2 * tq;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float2*>(park_a + 8 * j) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(park_b + 8 * j) = make_float2(acc[j][2], acc[j][3]);
    }

    // logits = q · kᵀ, kept in registers.
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kd = 0; kd < dt8; kd += 2) {
      const int col = kd * 8 + 2 * tq;
      const unsigned a[4] = {load_pair(q + slab, row_a, col, s, width, dh, vec),
                             load_pair(q + slab, row_b, col, s, width, dh, vec),
                             load_pair(q + slab, row_a, col + 8, s, width, dh, vec),
                             load_pair(q + slab, row_b, col + 8, s, width, dh, vec)};
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        unsigned bk[4];
        ldsm_x4(bk, opa + chunk_offset(g, 8 * j + ri + (mi >> 1) * 8, kd + (mi & 1)));
        mma(acc[j], a, bk[0], bk[1]);
        mma(acc[j + 1], a, bk[2], bk[3]);
      }
    }

    // Softmax of rows a (registers 0, 1) and b (2, 3): keys [0, lim) live.
    const int lim_a = row_a < s ? (causal ? row_a + 1 : s) : 0;
    const int lim_b = row_b < s ? (causal ? row_b + 1 : s) : 0;
    float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c0 = 8 * j + 2 * tq;
      acc[j][0] = c0 < lim_a ? acc[j][0] * scale : -INFINITY;
      acc[j][1] = c0 + 1 < lim_a ? acc[j][1] * scale : -INFINITY;
      acc[j][2] = c0 < lim_b ? acc[j][2] * scale : -INFINITY;
      acc[j][3] = c0 + 1 < lim_b ? acc[j][3] * scale : -INFINITY;
      m_a = fmaxf(m_a, fmaxf(acc[j][0], acc[j][1]));
      m_b = fmaxf(m_b, fmaxf(acc[j][2], acc[j][3]));
    }
    // The shuffles run in every lane (rows a and b of one lane may differ in
    // liveness); a dead row's max is -inf, taken as 0.
    m_a = quad_max(m_a);
    m_b = quad_max(m_b);
    m_a = lim_a > 0 ? m_a : 0.f;
    m_b = lim_b > 0 ? m_b : 0.f;
    float l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {  // exp(-inf) = 0 on masked keys
      acc[j][0] = __expf(acc[j][0] - m_a);
      acc[j][1] = __expf(acc[j][1] - m_a);
      acc[j][2] = __expf(acc[j][2] - m_b);
      acc[j][3] = __expf(acc[j][3] - m_b);
      l_a += acc[j][0] + acc[j][1];
      l_b += acc[j][2] + acc[j][3];
    }
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float rl_a = lim_a > 0 ? 1.f / l_a : 0.f, rl_b = lim_b > 0 ? 1.f / l_b : 0.f;
    float d_a = 0.f, d_b = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j][0] *= rl_a;
      acc[j][1] *= rl_a;
      acc[j][2] *= rl_b;
      acc[j][3] *= rl_b;
      const float2 pa = *reinterpret_cast<const float2*>(park_a + 8 * j);
      const float2 pb = *reinterpret_cast<const float2*>(park_b + 8 * j);
      d_a += acc[j][0] * pa.x + acc[j][1] * pa.y;
      d_b += acc[j][2] * pb.x + acc[j][3] * pb.y;
    }
    d_a = quad_sum(d_a);
    d_b = quad_sum(d_b);

    // ds = bf16(p·(dp − D)·scale) and bf16(p), packed as mma fragments.
    unsigned pk_p[NJ][2], pk_ds[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 pa = *reinterpret_cast<const float2*>(park_a + 8 * j);
      const float2 pb = *reinterpret_cast<const float2*>(park_b + 8 * j);
      pk_p[j][0] = pack(acc[j][0], acc[j][1]);
      pk_p[j][1] = pack(acc[j][2], acc[j][3]);
      pk_ds[j][0] = pack((acc[j][0] * (pa.x - d_a)) * scale, (acc[j][1] * (pa.y - d_a)) * scale);
      pk_ds[j][1] = pack((acc[j][2] * (pb.x - d_b)) * scale, (acc[j][3] * (pb.y - d_b)) * scale);
    }
    __syncwarp();  // every lane has read its parked dp before the rows are overwritten
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c0 = 8 * j + 2 * tq;
      *reinterpret_cast<unsigned*>(plo + row_a * S_PAD + c0) = pk_p[j][0];
      *reinterpret_cast<unsigned*>(plo + row_b * S_PAD + c0) = pk_p[j][1];
      *reinterpret_cast<unsigned*>(dsm + row_a * S_PAD + c0) = pk_ds[j][0];
      *reinterpret_cast<unsigned*>(dsm + row_b * S_PAD + c0) = pk_ds[j][1];
    }

    // dq = ds · k: ds from registers (A), K by ldmatrix.trans (B).
    for (int nd = 0; nd < dt8; nd += 2) {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const unsigned a[4] = {pk_ds[2 * kk][0], pk_ds[2 * kk][1], pk_ds[2 * kk + 1][0],
                               pk_ds[2 * kk + 1][1]};
        unsigned bk[4];
        ldsm_x4_t(bk, opa + chunk_offset(g, 16 * kk + ri + (mi & 1) * 8, nd + (mi >> 1)));
        mma(c0, a, bk[0], bk[1]);
        mma(c1, a, bk[2], bk[3]);
      }
      const int col = nd * 8 + 2 * tq;
      store_pair(dq + slab, row_a, col, c0[0], c0[1], s, width, dh, vec);
      store_pair(dq + slab, row_b, col, c0[2], c0[3], s, width, dh, vec);
      store_pair(dq + slab, row_a, col + 8, c1[0], c1[1], s, width, dh, vec);
      store_pair(dq + slab, row_b, col + 8, c1[2], c1[3], s, width, dh, vec);
    }
  }

  // ---- Phase B: Q and dO replace K and V; a warp owns 16 key rows --------
  __syncthreads();
  load_operand(opa, q + slab, g, s, width, dh, tid, vec);
  load_operand(opb, dout + slab, g, s, width, dh, tid, vec);
  cp_async_wait_all();
  __syncthreads();

  for (int kt = warp; kt < NT; kt += kWarps) {
    const int k0 = kt * 16;
    float dva[kMaxDhTiles8][4], dka[kMaxDhTiles8][4];
#pragma unroll
    for (int i = 0; i < kMaxDhTiles8; ++i)
      dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = dka[i][0] = dka[i][1] = dka[i][2] =
          dka[i][3] = 0.f;
    // Causal: p and ds are zero for queries before the tile's first key.
    for (int kq = causal ? kt : 0; kq < NT; ++kq) {
      // A = bf16(p)ᵀ and dsᵀ rows [k0, k0+16) × queries [16kq, 16kq+16).
      const int off = (16 * kq + ri + (mi >> 1) * 8) * S_PAD + k0 + (mi & 1) * 8;
      unsigned ap[4], as[4];
      ldsm_x4_t(ap, plo + off);
      ldsm_x4_t(as, dsm + off);
#pragma unroll
      for (int nd = 0; nd < kMaxDhTiles8; nd += 2) {
        if (nd < dt8) {
          const int o = chunk_offset(g, 16 * kq + ri + (mi & 1) * 8, nd + (mi >> 1));
          unsigned bd[4], bq[4];
          ldsm_x4_t(bd, opb + o);
          ldsm_x4_t(bq, opa + o);
          mma(dva[nd], ap, bd[0], bd[1]);
          mma(dva[nd + 1], ap, bd[2], bd[3]);
          mma(dka[nd], as, bq[0], bq[1]);
          mma(dka[nd + 1], as, bq[2], bq[3]);
        }
      }
    }
    const int key_a = k0 + gq, key_b = k0 + gq + 8;
#pragma unroll
    for (int nd = 0; nd < kMaxDhTiles8; ++nd) {
      if (nd < dt8) {
        const int col = nd * 8 + 2 * tq;
        store_pair(dv + slab, key_a, col, dva[nd][0], dva[nd][1], s, width, dh, vec);
        store_pair(dv + slab, key_b, col, dva[nd][2], dva[nd][3], s, width, dh, vec);
        store_pair(dk + slab, key_a, col, dka[nd][0], dka[nd][1], s, width, dh, vec);
        store_pair(dk + slab, key_b, col, dka[nd][2], dka[nd][3], s, width, dh, vec);
      }
    }
  }
}


// Logits q·kᵀ of a warp's 16 query rows [r0, r0 + 16) against every key, in
// mma accumulators (q as fragments from device memory, K from shared memory).
template <int NJ>
__device__ inline void logits_rows(float (&acc)[NJ][4], const bf16* q, const bf16* kop,
                                   const Geometry& g, int r0, int s, int width, int dh,
                                   bool vec) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3, mi = lane >> 3,
            ri = lane & 7;
  const int row_a = r0 + gq, row_b = r0 + gq + 8, dt8 = g.dh_pad / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kd = 0; kd < dt8; kd += 2) {
    const int col = kd * 8 + 2 * tq;
    const unsigned a[4] = {load_pair(q, row_a, col, s, width, dh, vec),
                           load_pair(q, row_b, col, s, width, dh, vec),
                           load_pair(q, row_a, col + 8, s, width, dh, vec),
                           load_pair(q, row_b, col + 8, s, width, dh, vec)};
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      unsigned bk[4];
      ldsm_x4(bk, kop + chunk_offset(g, 8 * j + ri + (mi >> 1) * 8, kd + (mi & 1)));
      mma(acc[j], a, bk[0], bk[1]);
      mma(acc[j + 1], a, bk[2], bk[3]);
    }
  }
}

// dp = do·vᵀ of a warp's 16 query rows against keys [8j, 8j + 16), dO and V
// from shared memory: keys 8j.. into d0, 8j + 8.. into d1.
__device__ inline void dp_pair(float (&d0)[4], float (&d1)[4], const bf16* dop, const bf16* vop,
                               const Geometry& g, int r0, int j) {
  const int lane = threadIdx.x % 32, mi = lane >> 3, ri = lane & 7, dt8 = g.dh_pad / 8;
  d0[0] = d0[1] = d0[2] = d0[3] = d1[0] = d1[1] = d1[2] = d1[3] = 0.f;
  for (int kd = 0; kd < dt8; kd += 2) {
    unsigned a[4], bv[4];
    ldsm_x4(a, dop + chunk_offset(g, r0 + ri + (mi & 1) * 8, kd + (mi >> 1)));
    ldsm_x4(bv, vop + chunk_offset(g, 8 * j + ri + (mi >> 1) * 8, kd + (mi & 1)));
    mma(d0, a, bv[0], bv[1]);
    mma(d1, a, bv[2], bv[3]);
  }
}

// o (16 key rows [k0, k0 + 16) × dh) = Σ over queries of arrᵀ · op: the
// transposed (query × key) bf16 array times an operand, by ldmatrix.trans;
// causal skips the query tiles before the key tile.
template <int DT>
__device__ inline void key_rows_product(float (&o)[DT][4], const bf16* arr,
                                        const bf16* op, const Geometry& g, int kt, int nt,
                                        int causal) {
  const int lane = threadIdx.x % 32, mi = lane >> 3, ri = lane & 7, dt8 = g.dh_pad / 8;
  const int k0 = kt * 16;
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  for (int kq = causal ? kt : 0; kq < nt; ++kq) {
    unsigned ap[4];
    ldsm_x4_t(ap, arr + (16 * kq + ri + (mi >> 1) * 8) * g.s_pad + k0 + (mi & 1) * 8);
#pragma unroll
    for (int nd = 0; nd < DT; nd += 2) {
      if (nd < dt8) {
        unsigned bd[4];
        ldsm_x4_t(bd, op + chunk_offset(g, 16 * kq + ri + (mi & 1) * 8, nd + (mi >> 1)));
        mma(o[nd], ap, bd[0], bd[1]);
        mma(o[nd + 1], ap, bd[2], bd[3]);
      }
    }
  }
}

template <int DT>
__device__ inline void store_key_rows(bf16* dst, const float (&o)[DT][4],
                                      const Geometry& g, int k0, int s, int width, int dh,
                                      bool vec) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3, dt8 = g.dh_pad / 8;
#pragma unroll
  for (int nd = 0; nd < DT; ++nd) {
    if (nd < dt8) {
      const int col = nd * 8 + 2 * tq;
      store_pair(dst, k0 + gq, col, o[nd][0], o[nd][1], s, width, dh, vec);
      store_pair(dst, k0 + gq + 8, col, o[nd][2], o[nd][3], s, width, dh, vec);
    }
  }
}

// DT: 8-wide head-dim tiles the accumulators are sized for (8: dh <= 64,
// 16: dh <= 128), so the narrow heads keep their registers.
template <int NT, int DT>
__global__ void __launch_bounds__(kThreads, 1)
short_attention_bwd_batched_inplace_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                           const bf16* __restrict__ v,
                                           const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                           bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                                           int heads, int dh, float scale, int causal, int vec) {
  constexpr int S_PAD = NT * 16;
  constexpr int NJ = 2 * NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry_inplace(s, dh);
  const int width = heads * dh;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, ri = lane & 7;
  const int dt8 = g.dh_pad / 8;

  bf16* arr = reinterpret_cast<bf16*>(smem_raw);  // bf16(p), then ds [query][key]
  bf16* opa = arr + S_PAD * S_PAD;                // K
  bf16* opb = opa + S_PAD * g.dh_pad;             // V, then Q
  bf16* opc = opb + S_PAD * g.dh_pad;             // dO
  float* row_m = reinterpret_cast<float*>(opc + S_PAD * g.dh_pad);
  float* row_rl = row_m + S_PAD;
  float* row_d = row_rl + S_PAD;

  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  load_operand(opa, k + slab, g, s, width, dh, tid, vec);
  load_operand(opb, v + slab, g, s, width, dh, tid, vec);
  load_operand(opc, dout + slab, g, s, width, dh, tid, vec);
  cp_async_wait_all();
  __syncthreads();

  // ---- A: softmax, D and bf16(p) of a warp's 16 query rows ----------------
  for (int rt = warp; rt < NT; rt += kWarps) {
    const int r0 = rt * 16, row_a = r0 + gq, row_b = r0 + gq + 8;
    float acc[NJ][4];
    logits_rows<NJ>(acc, q + slab, opa, g, r0, s, width, dh, vec);
    const int lim_a = row_a < s ? (causal ? row_a + 1 : s) : 0;
    const int lim_b = row_b < s ? (causal ? row_b + 1 : s) : 0;
    float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c0 = 8 * j + 2 * tq;
      acc[j][0] = c0 < lim_a ? acc[j][0] * scale : -INFINITY;
      acc[j][1] = c0 + 1 < lim_a ? acc[j][1] * scale : -INFINITY;
      acc[j][2] = c0 < lim_b ? acc[j][2] * scale : -INFINITY;
      acc[j][3] = c0 + 1 < lim_b ? acc[j][3] * scale : -INFINITY;
      m_a = fmaxf(m_a, fmaxf(acc[j][0], acc[j][1]));
      m_b = fmaxf(m_b, fmaxf(acc[j][2], acc[j][3]));
    }
    m_a = quad_max(m_a);
    m_b = quad_max(m_b);
    m_a = lim_a > 0 ? m_a : 0.f;
    m_b = lim_b > 0 ? m_b : 0.f;
    float l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j][0] = __expf(acc[j][0] - m_a);
      acc[j][1] = __expf(acc[j][1] - m_a);
      acc[j][2] = __expf(acc[j][2] - m_b);
      acc[j][3] = __expf(acc[j][3] - m_b);
      l_a += acc[j][0] + acc[j][1];
      l_b += acc[j][2] + acc[j][3];
    }
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float rl_a = lim_a > 0 ? 1.f / l_a : 0.f, rl_b = lim_b > 0 ? 1.f / l_b : 0.f;
    float d_a = 0.f, d_b = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      float d0[4], d1[4];
      dp_pair(d0, d1, opc, opb, g, r0, j);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* p = acc[j + t];
        const float* dp = t == 0 ? d0 : d1;
        p[0] *= rl_a;
        p[1] *= rl_a;
        p[2] *= rl_b;
        p[3] *= rl_b;
        d_a += p[0] * dp[0] + p[1] * dp[1];
        d_b += p[2] * dp[2] + p[3] * dp[3];
        const int c0 = 8 * (j + t) + 2 * tq;
        *reinterpret_cast<unsigned*>(arr + row_a * S_PAD + c0) = pack(p[0], p[1]);
        *reinterpret_cast<unsigned*>(arr + row_b * S_PAD + c0) = pack(p[2], p[3]);
      }
    }
    d_a = quad_sum(d_a);
    d_b = quad_sum(d_b);
    if (tq == 0) {
      row_m[row_a] = m_a;
      row_rl[row_a] = rl_a;
      row_d[row_a] = d_a;
      row_m[row_b] = m_b;
      row_rl[row_b] = rl_b;
      row_d[row_b] = d_b;
    }
  }
  __syncthreads();

  // ---- B1: dv = bf16(p)ᵀ · dO over a warp's 16 key rows --------------------
  for (int kt = warp; kt < NT; kt += kWarps) {
    float o[DT][4];
    key_rows_product(o, arr, opc, g, kt, NT, causal);
    store_key_rows(dv + slab, o, g, kt * 16, s, width, dh, vec);
  }
  __syncthreads();

  // ---- B2: ds over bf16(p) in a warp's own rows, and dq = ds · k ----------
  for (int rt = warp; rt < NT; rt += kWarps) {
    const int r0 = rt * 16, row_a = r0 + gq, row_b = r0 + gq + 8;
    float acc[NJ][4];
    logits_rows<NJ>(acc, q + slab, opa, g, r0, s, width, dh, vec);
    const int lim_a = row_a < s ? (causal ? row_a + 1 : s) : 0;
    const int lim_b = row_b < s ? (causal ? row_b + 1 : s) : 0;
    const float m_a = row_m[row_a], rl_a = row_rl[row_a], d_a = row_d[row_a];
    const float m_b = row_m[row_b], rl_b = row_rl[row_b], d_b = row_d[row_b];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {  // A's arithmetic, so p is bit-identical to A's
      const int c0 = 8 * j + 2 * tq;
      acc[j][0] = __expf((c0 < lim_a ? acc[j][0] * scale : -INFINITY) - m_a) * rl_a;
      acc[j][1] = __expf((c0 + 1 < lim_a ? acc[j][1] * scale : -INFINITY) - m_a) * rl_a;
      acc[j][2] = __expf((c0 < lim_b ? acc[j][2] * scale : -INFINITY) - m_b) * rl_b;
      acc[j][3] = __expf((c0 + 1 < lim_b ? acc[j][3] * scale : -INFINITY) - m_b) * rl_b;
    }
    float c[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int j = 2 * kk;
      float d0[4], d1[4];
      dp_pair(d0, d1, opc, opb, g, r0, j);
      const unsigned a[4] = {
          pack((acc[j][0] * (d0[0] - d_a)) * scale, (acc[j][1] * (d0[1] - d_a)) * scale),
          pack((acc[j][2] * (d0[2] - d_b)) * scale, (acc[j][3] * (d0[3] - d_b)) * scale),
          pack((acc[j + 1][0] * (d1[0] - d_a)) * scale, (acc[j + 1][1] * (d1[1] - d_a)) * scale),
          pack((acc[j + 1][2] * (d1[2] - d_b)) * scale, (acc[j + 1][3] * (d1[3] - d_b)) * scale)};
      const int c0 = 8 * j + 2 * tq;
      *reinterpret_cast<unsigned*>(arr + row_a * S_PAD + c0) = a[0];
      *reinterpret_cast<unsigned*>(arr + row_b * S_PAD + c0) = a[1];
      *reinterpret_cast<unsigned*>(arr + row_a * S_PAD + c0 + 8) = a[2];
      *reinterpret_cast<unsigned*>(arr + row_b * S_PAD + c0 + 8) = a[3];
#pragma unroll
      for (int nd = 0; nd < DT; nd += 2) {
        if (nd < dt8) {
          unsigned bk[4];
          ldsm_x4_t(bk, opa + chunk_offset(g, 16 * kk + ri + (mi & 1) * 8, nd + (mi >> 1)));
          mma(c[nd], a, bk[0], bk[1]);
          mma(c[nd + 1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      if (nd < dt8) {
        const int col = nd * 8 + 2 * tq;
        store_pair(dq + slab, row_a, col, c[nd][0], c[nd][1], s, width, dh, vec);
        store_pair(dq + slab, row_b, col, c[nd][2], c[nd][3], s, width, dh, vec);
      }
    }
  }

  // ---- B3: Q replaces V; dk = dsᵀ · q over a warp's 16 key rows -----------
  __syncthreads();
  load_operand(opb, q + slab, g, s, width, dh, tid, vec);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = warp; kt < NT; kt += kWarps) {
    float o[DT][4];
    key_rows_product(o, arr, opb, g, kt, NT, causal);
    store_key_rows(dk + slab, o, g, kt * 16, s, width, dh, vec);
  }
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// ---- the warpgroup body: head dim 64, 16-byte rows, s_pad <= 256 ----------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBox = 64 * 128;  // one TMA box, or one 64 × 64 panel: 64 rows of 128 bytes

// Keys of a row in the products at this shape (64, 208 or 256, as K2's
// warpgroup body), 0 where the warpgroup body does not run (head dim other
// than 64, rows not 16-byte aligned, or s_pad > 256).
__host__ __device__ inline int wg_keys(int s, int dh, int vec) {
  const int s_pad = round_up(s, 16);
  if (dh != 64 || !vec || s < 1 || s_pad > 256) return 0;
  return s_pad <= 64 ? 64 : s_pad <= 208 ? 208 : 256;
}

// The block at N keys: K and V over kRows rows (whole TMA boxes, those past
// s zero), the stages of a Q and a dO tile, the tile's bf16(p) and ds in
// 64-key panels, the producer's parked p (N/2 f32 a thread), the barriers
// (K, V, one per stage, p/ds written, consumers done).
template <int N>
struct Wg {
  static constexpr int kRows = (N + 63) / 64 * 64;
  static constexpr int kPanels = kRows / 64;
  static constexpr int kGroups = N == 64 ? 1 : 3;  // s <= 64: one query tile, one warpgroup
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kStages = N == 64 ? 1 : 2;
  static constexpr size_t kParkBytes = (size_t)N / 2 * 128 * sizeof(float);
  static constexpr int kBars = 2 + kStages + 2;
  static constexpr size_t kSmem = 1024 + (size_t)2 * kRows * 128 + (size_t)kStages * 2 * kBox +
                                  (size_t)2 * kPanels * kBox + kParkBytes +
                                  kBars * sizeof(uint64_t);
};

// d = a·bᵀ over the head dim (64: four k16 steps) at N keys, both operands
// K-major at shared addresses a (64 query rows) and b (the head's keys), in
// one group, waited for. The descriptors are formed as key_tile_products'.
template <int N>
__device__ inline void row_products(float (&d)[N / 2], uint32_t a, uint32_t b) {
  uint64_t da = sw128_desc(a, 16), db = sw128_desc(b, 16);
  asm volatile("" : "+l"(da), "+l"(db));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_keys<N>(d, da + 2 * kk, db + 2 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(d);
}

__device__ inline void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// acc[kt] += A(kt)·B over one query tile for key tiles kt < KT: A(kt) the
// transposed 64-key panel kt of a (query × key) bf16 tile at shared address a,
// B the tile's (query × dh) operand at b, both MN-major; 4·KT m64n64k16
// products in one group. Each descriptor is its operand's first one plus the
// offset's 16-byte units (the start address field, 14 bits, holds every shared
// address), and that first one is opaque to the compiler: the 4·KT descriptors
// are formed at their products, not hoisted out of the caller's loop into
// registers beside the 128 of the accumulators.
template <int KT, int A>
__device__ inline void key_tile_products(float (&acc)[A][32], uint32_t a, uint32_t b) {
  uint64_t da = sw128_desc(a, kBox), db = sw128_desc(b, kBox);
  asm volatile("" : "+l"(da), "+l"(db));
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64_major<1, 1>(acc[kt], da + (uint64_t)((kt * kBox + kk * 2048) >> 4),
                               db + (uint64_t)(kk * 2048 >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) fence_operands(acc[kt]);
}

// This warp's 16 rows of a 64 × 64 f32 accumulator tile as bf16 into a
// 64 × 64 box at shared address box, laid out as TMA's 128-byte swizzle,
// by stmatrix: 16-column step m holds 8-column tiles 2m and 2m + 1, rows a
// and b of each. row_s: the row this lane addresses, times 128 (row lane %
// 8 of matrix lane / 8: rows a (matrices 0, 2) or b (1, 3)).
__device__ inline void stage_tile(uint32_t box, const float (&acc)[32], uint32_t row_s,
                                  int lane) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned r[4] = {pack(acc[8 * m], acc[8 * m + 1]), pack(acc[8 * m + 2], acc[8 * m + 3]),
                           pack(acc[8 * m + 4], acc[8 * m + 5]),
                           pack(acc[8 * m + 6], acc[8 * m + 7])};
    stsm_x4(box + row_s + (((2 * m + (lane >> 4)) ^ (lane & 7)) << 4), r);
  }
}

// dk or dv of key tiles kt < n_kt from one warpgroup's accumulators, by
// TMA through boxes (one per key tile; rows past s are not written), once
// every warp's products have read what the boxes held. Named barrier `bar`
// joins the warpgroup's 128 threads.
template <int A>
__device__ inline void store_key_tiles(const CUtensorMap* map, const float (&acc)[A][32],
                                       unsigned char* boxes, int n_kt, int h, int b, int bar,
                                       uint32_t row_s, int t) {
  named_barrier(bar, 128);
#pragma unroll
  for (int kt = 0; kt < A; ++kt)
    if (kt < n_kt) stage_tile(smem_u32(boxes + kt * kBox), acc[kt], row_s, t % 32);
  fence_proxy_async();
  named_barrier(bar, 128);
  if (t == 0) {
    for (int kt = 0; kt < n_kt; ++kt) tma_store(map, boxes + kt * kBox, h * 64, kt * 64, b);
    tma_store_commit();
    tma_store_wait();
  }
}

// One block per (head, batch row): the five products of the head's
// backward over its 64-row query tiles (the header's warpgroup body).
template <int N>
__global__ void __launch_bounds__(Wg<N>::kThreads, N == 64 ? 3 : 1)
short_attention_bwd_batched_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                         const __grid_constant__ CUtensorMap k_map,
                                         const __grid_constant__ CUtensorMap v_map,
                                         const __grid_constant__ CUtensorMap do_map,
                                         const __grid_constant__ CUtensorMap dq_map,
                                         const __grid_constant__ CUtensorMap dk_map,
                                         const __grid_constant__ CUtensorMap dv_map, int s,
                                         float scale, int causal) {
  using G = Wg<N>;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  unsigned char* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + G::kRows * 128;
  unsigned char* stages = vs + G::kRows * 128;  // stage i: Q at + 2i·kBox, dO after it
  unsigned char* pbuf = stages + G::kStages * 2 * kBox;  // bf16(p) [panel][query][key % 64]
  unsigned char* dsbuf = pbuf + G::kPanels * kBox;        // ds, the same layout
  float4* park = reinterpret_cast<float4*>(dsbuf + G::kPanels * kBox);
  uint64_t* k_bar = reinterpret_cast<uint64_t*>(dsbuf + G::kPanels * kBox + G::kParkBytes);
  uint64_t* v_bar = k_bar + 1;
  uint64_t* full = k_bar + 2;              // per stage: its Q and dO have landed
  uint64_t* pds_full = full + G::kStages;  // the producer wrote the tile's bf16(p) and ds
  uint64_t* done = pds_full + 1;           // both consumers are done with the tile

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (s + 63) / 64;  // query tiles, key tiles, K and V boxes
  // Query tile j's Q and dO into its stage (by one thread).
  auto load_tile = [&](int j) {
    const int st = j % G::kStages;
    mbar_expect_tx(&full[st], 2 * kBox);
    tma_load(stages + st * 2 * kBox, &q_map, &full[st], h * 64, j * 64, b);
    tma_load(stages + st * 2 * kBox + kBox, &do_map, &full[st], h * 64, j * 64, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(k_bar, 1);
    mbar_init(v_bar, 1);
    for (int i = 0; i < G::kStages; ++i) mbar_init(&full[i], 1);
    mbar_init(pds_full, 128);
    mbar_init(done, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // K and V rows past the last box are zero (the logits and dq read keys up
  // to N), and so are the keys past N of the last panel (the consumers' last
  // 64-key tile reads them; the producer writes only keys below N).
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < (G::kRows - n_qt * 64) * 8; i += G::kThreads) {
    reinterpret_cast<uint4*>(ks + n_qt * kBox)[i] = zero;
    reinterpret_cast<uint4*>(vs + n_qt * kBox)[i] = zero;
  }
  if constexpr (G::kRows > N) {
    for (int i = threadIdx.x; i < kBox / 16; i += G::kThreads) {
      reinterpret_cast<uint4*>(pbuf + (G::kPanels - 1) * kBox)[i] = zero;
      reinterpret_cast<uint4*>(dsbuf + (G::kPanels - 1) * kBox)[i] = zero;
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(k_bar, n_qt * kBox);
    for (int x = 0; x < n_qt; ++x) tma_load(ks + x * kBox, &k_map, k_bar, h * 64, x * 64, b);
    load_tile(0);
    mbar_expect_tx(v_bar, n_qt * kBox);
    for (int x = 0; x < n_qt; ++x) tma_load(vs + x * kBox, &v_map, v_bar, h * 64, x * 64, b);
    if (G::kStages > 1 && n_qt > 1) load_tile(1);
  }

  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, gq = lane >> 2, tq = lane & 3;
  if (threadIdx.x < 128) {
    // ---- the producer: K2's dQ work per query tile, and the p/ds panels ----
    const float sl = scale * kLog2e;
    const uint32_t ks_s = smem_u32(ks), vs_s = smem_u32(vs);
    const uint32_t p_s = smem_u32(pbuf), ds_s = smem_u32(dsbuf), park_s = smem_u32(park);
    // This lane addresses row lane % 8 of matrix lane / 8 of a stmatrix:
    // rows a (matrices 0, 2) or b (1, 3) of 8-key tile 2kk (0, 1) or 2kk + 1
    // (2, 3).
    const uint32_t row_s = (16 * w + (lane & 7) + (lane & 8)) * 128;
    for (int j = 0; j < n_qt; ++j) {
      const int st = j % G::kStages;
      const uint32_t qt_s = smem_u32(stages) + st * 2 * kBox, dot_s = qt_s + kBox;
      mbar_wait(&full[st], (unsigned)(j / G::kStages) & 1u);
      mbar_wait(k_bar, 0);
      const int row_a = j * 64 + 16 * w + gq, row_b = row_a + 8;

      float sc[N / 2];  // x = q·kᵀ
      row_products<N>(sc, qt_s, ks_s);

      // Softmax in registers (row a: registers 4n, 4n+1; row b: 4n+2, 4n+3
      // of 8-key tile n), parked in f32: float4 n at park[n·128 + t].
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
      if (j > 0) {
        // The last tile's dq has left the park's first 8 KB.
        if (t == 0) tma_store_wait_read();
        named_barrier(1, 128);
      }
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
        park[n * 128 + t] = make_float4(sc[4 * n] * il_a, sc[4 * n + 1] * il_a,
                                        sc[4 * n + 2] * il_b, sc[4 * n + 3] * il_b);

      mbar_wait(v_bar, 0);
      float dp[N / 2];  // dp = do·vᵀ
      row_products<N>(dp, dot_s, vs_s);
      if constexpr (G::kGroups > 1) {
        if (j > 0) {
          // The consumers are done with tile j − 1: its panels and its stage
          // are free, and tile j + 1 goes into that stage.
          mbar_wait(done, (unsigned)(j - 1) & 1u);
          if (t == 0 && j + 1 < n_qt) load_tile(j + 1);
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

      // ds = bf16((p·(dp − D))·scale) and bf16(p) into the panels by
      // stmatrix: 16-key step kk holds 8-key tiles 2kk and 2kk + 1, rows a
      // and b of each, as four 8 × 8 matrices; row r of the tile, keys 8n ..
      // 8n + 7, lies at panel n / 8, 16-byte chunk (n % 8) ⊕ (r % 8).
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        unsigned pw[4], dw[4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int n = 2 * kk + x;
          const float4 p = park[n * 128 + t];
          dw[2 * x] =
              pack((p.x * (dp[4 * n] - d_a)) * scale, (p.y * (dp[4 * n + 1] - d_a)) * scale);
          dw[2 * x + 1] =
              pack((p.z * (dp[4 * n + 2] - d_b)) * scale, (p.w * (dp[4 * n + 3] - d_b)) * scale);
          pw[2 * x] = pack(p.x, p.y);
          pw[2 * x + 1] = pack(p.z, p.w);
        }
        const int n = 2 * kk + (lane >> 4);
        const uint32_t off = (n >> 3) * kBox + row_s + (((n & 7) ^ (lane & 7)) << 4);
        stsm_x4(p_s + off, pw);
        stsm_x4(ds_s + off, dw);
      }
      // The panels are complete: visible to this warpgroup's wgmma and, by
      // the barrier, to the consumers'.
      fence_proxy_async();
      named_barrier(1, 128);
      if constexpr (G::kGroups > 1) mbar_arrive(pds_full);

      // dq = ds·k: the ds panels as the K-major A (16-key step kk at panel
      // kk / 4, byte kk % 4 · 32), K as the MN-major B (rows 16kk ..).
      float dqa[32];  // overwritten by the first product (scale_d = 0)
      uint64_t d_ds = sw128_desc(ds_s, 16), d_kt = sw128_desc(ks_s, kBox);
      asm volatile("" : "+l"(d_ds), "+l"(d_kt));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss_n64_major<0, 1>(dqa, d_ds + ((kk / 4) * kBox + (kk % 4) * 32) / 16,
                                 d_kt + 128 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dqa);
      // dq by TMA through the park's first 8 KB (read there: D and ds are done).
      stage_tile(park_s, dqa, row_s, lane);
      fence_proxy_async();
      named_barrier(1, 128);
      if (t == 0) {
        tma_store(&dq_map, park, h * 64, j * 64, b);
        tma_store_commit();
      }
    }
    if constexpr (G::kGroups == 1) {
      // One query tile (s <= 64): this warpgroup forms dv = bf16(p)ᵀ·dO and
      // dk = dsᵀ·Q itself from the panels it wrote.
      float dva[1][32], dka[1][32];
#pragma unroll
      for (int x = 0; x < 32; ++x) dva[0][x] = dka[0][x] = 0.f;
      key_tile_products<1>(dva, p_s, smem_u32(stages + kBox));
      key_tile_products<1>(dka, ds_s, smem_u32(stages));
      store_key_tiles(&dv_map, dva, pbuf, 1, h, b, 1, row_s, t);
      store_key_tiles(&dk_map, dka, dsbuf, 1, h, b, 1, row_s, t);
    }
    if (t == 0) tma_store_wait();
  } else if constexpr (G::kGroups > 1) {
    // ---- the consumers: dv (warpgroup 1) and dk (warpgroup 2) ------------
    const bool is_dv = threadIdx.x < 256;
    const uint32_t a_s = smem_u32(is_dv ? pbuf : dsbuf);
    const uint32_t b_s = smem_u32(stages) + (is_dv ? kBox : 0);  // dO or Q of stage 0
    float acc[4][32];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[kt][x] = 0.f;
    for (int j = 0; j < n_qt; ++j) {
      const int st = j % G::kStages;
      mbar_wait(&full[st], (unsigned)(j / G::kStages) & 1u);
      mbar_wait(pds_full, (unsigned)j & 1u);
      const uint32_t bop = b_s + st * 2 * kBox;
      // Causal: the keys of tiles past the query tile's diagonal have p = ds = 0.
      switch (causal ? min(j + 1, n_qt) : n_qt) {
        case 1: key_tile_products<1>(acc, a_s, bop); break;
        case 2: key_tile_products<2>(acc, a_s, bop); break;
        case 3: key_tile_products<3>(acc, a_s, bop); break;
        default: key_tile_products<4>(acc, a_s, bop); break;
      }
      mbar_arrive(done);
    }
    // dv by TMA through its own panels, free after its last products; dk
    // through the park past the producer's dq box (the producer reads the
    // park no more once it has published the last tile).
    const uint32_t row_s = (16 * w + (lane & 7) + (lane & 8)) * 128;
    if (is_dv)
      store_key_tiles(&dv_map, acc, pbuf, n_qt, h, b, 2, row_s, t);
    else
      store_key_tiles(&dk_map, acc, reinterpret_cast<unsigned char*>(park) + kBox, n_qt, h, b,
                      3, row_s, t);
  }
}

template <int N>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout, void* dq,
                         void* dk, void* dv, int b, int s, int heads, float scale, int causal,
                         cudaStream_t stream) {
  using G = Wg<N>;
  CUtensorMap maps[7] = {};
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 7 && err == cudaSuccess; ++i)
    err = make_map(&maps[i], ptrs[i], b, s, heads * 64);
  if (err == cudaSuccess) err = configure(short_attention_bwd_batched_wgmma_kernel<N>, G::kSmem);
  if (err != cudaSuccess) return err;
  short_attention_bwd_batched_wgmma_kernel<N><<<dim3(heads, b), G::kThreads, G::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], s, scale, causal);
  return cudaGetLastError();
}

template <int N>
int occupancy_wgmma() {
  int blocks = 0;
  cudaError_t err = configure(short_attention_bwd_batched_wgmma_kernel<N>, Wg<N>::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, short_attention_bwd_batched_wgmma_kernel<N>, Wg<N>::kThreads, Wg<N>::kSmem);
  return err == cudaSuccess ? blocks : 0;
}

// The kernel a shape takes: the two-array kernel where it fits, else the
// in-place one; 0 when neither does.
enum Variant { kNone = 0, kTwoArrays = 1, kInPlace = 2 };

Variant variant(int s, int dh) {
  if (s < 1 || dh < 1 || dh > kMaxHeadDim) return kNone;
  const int nt = round_up(s, 16) / 16;
  if (nt <= kMaxKeyTiles && geometry(s, dh).smem <= 227 * 1024) return kTwoArrays;
  if (nt >= kMinKeyTilesInPlace && nt <= kMaxKeyTilesInPlace &&
      geometry_inplace(s, dh).smem <= 227 * 1024)
    return kInPlace;
  return kNone;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv, int b, int s, int heads, int dh,
                   float scale, int causal, int vec, cudaStream_t stream) {
  cudaError_t err = configure(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, heads, dh, scale, causal, vec);
  return cudaGetLastError();
}

template <typename Kernel>
int occupancy(Kernel kernel, size_t smem) {
  int blocks = 0;
  cudaError_t err = configure(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : 0;
}

}  // namespace

// Each case: `kernel` and `smem` for key tiles NT of the variant, then BODY.
#define SABB_DISPATCH(VAR, S, DH, BODY)                                                      \
  if (VAR == kTwoArrays) {                                                                   \
    const size_t smem = geometry(S, DH).smem;                                                \
    switch (round_up(S, 16) / 16) {                                                          \
      SABB_TWO(1, BODY) SABB_TWO(2, BODY) SABB_TWO(3, BODY) SABB_TWO(4, BODY)                \
      SABB_TWO(5, BODY) SABB_TWO(6, BODY) SABB_TWO(7, BODY) SABB_TWO(8, BODY)                \
      SABB_TWO(9, BODY) SABB_TWO(10, BODY) SABB_TWO(11, BODY) SABB_TWO(12, BODY)             \
      SABB_TWO(13, BODY)                                                                     \
      default: break;                                                                        \
    }                                                                                        \
  } else if (VAR == kInPlace) {                                                              \
    const size_t smem = geometry_inplace(S, DH).smem;                                        \
    switch (round_up(S, 16) / 16) {                                                          \
      SABB_IN16(12, BODY) SABB_IN16(13, BODY) SABB_IN(14, BODY) SABB_IN8(15, BODY)           \
      SABB_IN8(16, BODY)                                                                     \
      default: break;                                                                        \
    }                                                                                        \
  }
#define SABB_TWO(NT, BODY)                                          \
  case NT: {                                                        \
    auto kernel = short_attention_bwd_batched_kernel<NT>;           \
    BODY                                                            \
  }
// The in-place instantiations a shape reaches (s_pad = 16·NT, DT 8 for
// dh <= 64, 16 beyond): below NT = 12 the two arrays fit at every dh <= 128,
// and at NT 12-13 at every dh <= 64; past NT = 14 in place fits only
// dh <= 64.
#define SABB_IN(NT, BODY)                                                             \
  case NT: {                                                                          \
    auto kernel = round_up(dh, 16) <= 64 ? short_attention_bwd_batched_inplace_kernel<NT, 8> \
                                         : short_attention_bwd_batched_inplace_kernel<NT, 16>; \
    BODY                                                                              \
  }
#define SABB_IN8(NT, BODY)                                          \
  case NT: {                                                        \
    auto kernel = short_attention_bwd_batched_inplace_kernel<NT, 8>;  \
    BODY                                                            \
  }
#define SABB_IN16(NT, BODY)                                          \
  case NT: {                                                         \
    auto kernel = short_attention_bwd_batched_inplace_kernel<NT, 16>;  \
    BODY                                                             \
  }

extern "C" {

// Dynamic shared memory of one block of the mma.sync kernel this shape
// takes (the variant of the fit), bytes (mirrored by
// ops/short_attention.py::short_attention_bwd_batched_smem_bytes); 0 when no
// variant takes it. The warpgroup body's is
// short_attention_bwd_batched_wgmma_smem_bytes.
long long short_attention_bwd_batched_smem_bytes(int s, int dh) {
  const Variant var = variant(s, dh);
  if (var == kNone) return 0;
  return (long long)(var == kTwoArrays ? geometry(s, dh) : geometry_inplace(s, dh)).smem;
}

// The variant of the fit at this shape: 1 two arrays, 2 in place, 0 none
// (the mma.sync kernel a call takes where the warpgroup body does not; for
// the records and the Python mirror of the fit).
int short_attention_bwd_batched_variant(int s, int dh) { return (int)variant(s, dh); }

// The body a call takes: 1 = the warpgroup body (wgmma fed by TMA), 0 = the
// mma.sync kernels (mirrored by
// ops/short_attention.py::short_attention_bwd_batched_body).
int short_attention_bwd_batched_body(int s, int dh, int vec) {
  return wg_keys(s, dh, vec) && variant(s, dh) != kNone ? 1 : 0;
}

// Dynamic shared memory of one block of the warpgroup body at length s,
// bytes; 0 where the body does not run (mirrored by
// ops/short_attention.py::short_attention_bwd_batched_wgmma_smem_bytes).
long long short_attention_bwd_batched_wgmma_smem_bytes(int s) {
  switch (wg_keys(s, 64, 1)) {
    case 64: return (long long)Wg<64>::kSmem;
    case 208: return (long long)Wg<208>::kSmem;
    case 256: return (long long)Wg<256>::kSmem;
    default: return 0;
  }
}

// q, k, v, dout, dq, dk, dv: (b, s, heads·dh) bf16, contiguous. One launch;
// returns its cudaError_t (0 on success) and does not synchronise.
// cudaErrorInvalidValue for a shape neither variant takes (s > 256, dh >
// 128, or over the shared-memory budget).
int short_attention_bwd_batched(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, int b, int s, int heads, int dh,
                                float scale, int causal, int vec, void* stream) {
  const Variant var = variant(s, dh);
  if (b < 1 || b > 65535 || heads < 1 || var == kNone) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wg_keys(s, dh, vec)) {
    case 64:
      return (int)launch_wgmma<64>(q, k, v, dout, dq, dk, dv, b, s, heads, scale, causal, st);
    case 208:
      return (int)launch_wgmma<208>(q, k, v, dout, dq, dk, dv, b, s, heads, scale, causal, st);
    case 256:
      return (int)launch_wgmma<256>(q, k, v, dout, dq, dk, dv, b, s, heads, scale, causal, st);
    default: break;
  }
  SABB_DISPATCH(var, s, dh,
                return (int)launch(kernel, smem, q, k, v, dout, dq, dk, dv, b, s, heads, dh,
                                   scale, causal, vec, st);)
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the kernel a call with 16-byte rows takes at
// this shape (0 with an error or a shape no variant takes), for the records.
int short_attention_bwd_batched_occupancy(int s, int dh) {
  const Variant var = variant(s, dh);
  if (var != kNone) {
    switch (wg_keys(s, dh, 1)) {
      case 64: return occupancy_wgmma<64>();
      case 208: return occupancy_wgmma<208>();
      case 256: return occupancy_wgmma<256>();
      default: break;
    }
  }
  SABB_DISPATCH(var, s, dh, return occupancy(kernel, smem);)
  return 0;
}

const char* short_attention_bwd_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
