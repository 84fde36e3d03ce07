// Head-batched short-sequence self-attention backward for Hopper (sm_90a).
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
// issues each of the five products once. So does this kernel: one launch per
// backward call, one block per (batch row, head), and every logit, exp and
// dp computed once. K2 is two kernels whose second recomputes the logits and
// dp tile by tile: seven products and every exp twice.
//
// Bound on this card: memory, as K2's. At ViT-B/16 vision, b=128 (s=196,
// h=12, dh=64), q, k, v, do read once and dq, dk, dv written once are
// 7·128·196·768·2 B ≈ 270 MB, ≈ 80.5 µs at 3.35 TB/s, while the five
// products are 5·2·128·12·196²·64 ≈ 37.8 GFLOP, ≈ 38.2 µs at 989 TFLOP/s.
//
// Design. The block keeps the head's whole bf16(p) and ds, (s_pad × s_pad)
// each, in shared memory: 2 · 208² · 2 B = 173 KB at s=196. Beside them sits
// one pair of the head's (s_pad × dh) operands in bf16, 53 KB: first K and V,
// then Q and dO. 226 KB of the 227 KB a block may have, so one block per SM;
// rows of 64 bf16 are stored with their 16-byte chunks XOR-swizzled by the
// row, so the ldmatrix loads of 8 rows hit 8 different bank groups.
//   Phase A, query rows: each warp owns 16 query rows. It computes its
//   16 × s_pad dp = do·vᵀ with mma.sync (the accumulator layout of
//   m16n8k16 is documented, so row statistics are quad shuffles) and parks it
//   in f32 in its own rows of the bf16(p) and ds arrays (16 rows of both are
//   16 · s_pad f32), then keeps the 16 × s_pad logits q·kᵀ in registers, takes
//   the softmax there, reads dp back for D = rowsum(dp ⊙ p), and writes
//   bf16(p) and ds over the parked dp. Its dq = ds·k takes ds straight from
//   registers as the A operand.
//   Phase B, key rows: after a block barrier Q and dO replace K and V, and
//   each warp owns 16 key rows: dv = bf16(p)ᵀ·do and dk = dsᵀ·q, with the
//   transposes read by ldmatrix.trans from the shared arrays.
// q and do rows of phase A are read as mma fragments straight from global
// memory (L2); every output element is written by one thread and there are
// no atomics, so runs are bitwise repeatable. The ragged edge (s=196) is
// zero-padded in shared memory and masked; causal masks by key, and phase B
// skips the query tiles that are masked whole. wgmma/TMA pipelining is later
// work.
//
// The in-place variant, for the lengths where the two (s_pad × s_pad) arrays
// do not fit: JAX's K3 takes s <= 250 at width 768 / 12 heads, 212 at 1,024 /
// 16 and 208 at 1,152 / 16 (dh = 72), and two arrays at s_pad = 256 are 262
// KB. It keeps ONE (s_pad × s_pad) bf16 array, 131 KB at s = 250, beside
// three operand slots (K, V then Q, dO; 98 KB at dh = 64) and the rows'
// (m, 1/l, D):
//   A  query rows: logits and softmax in registers, D = rowsum(p ⊙ dp) with
//      dp eight keys at a time (dO and V from shared memory), bf16(p) into
//      the array, (m, 1/l, D) saved;
//   B1 key rows: dv = bf16(p)ᵀ·dO;
//   B2 query rows: the logits and dp again, p from the saved (m, 1/l), so
//      bit-identical to A's; ds = bf16(p ⊙ (dp − D)·scale) over bf16(p) in
//      the warp's own rows, and dq = ds·k from the registers;
//   B3 Q replaces V; key rows: dk = dsᵀ·q.
// Seven products (the logits and dp twice) where the two-array kernel
// issues five, so it runs only where that one does not fit: s_pad > 208,
// or dh too wide for two arrays (kept for s_pad <= 208 as it was).

#include "short_attention_common.cuh"

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
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
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
      SABB_IN(9, BODY) SABB_IN(10, BODY) SABB_IN(11, BODY) SABB_IN(12, BODY)                 \
      SABB_IN(13, BODY) SABB_IN(14, BODY) SABB_IN(15, BODY) SABB_IN(16, BODY)                \
      default: break;                                                                        \
    }                                                                                        \
  }
#define SABB_TWO(NT, BODY)                                          \
  case NT: {                                                        \
    auto kernel = short_attention_bwd_batched_kernel<NT>;           \
    BODY                                                            \
  }
#define SABB_IN(NT, BODY)                                                             \
  case NT: {                                                                          \
    auto kernel = round_up(dh, 16) <= 64 ? short_attention_bwd_batched_inplace_kernel<NT, 8> \
                                         : short_attention_bwd_batched_inplace_kernel<NT, 16>; \
    BODY                                                                              \
  }

extern "C" {

// Dynamic shared memory of one block of the kernel this shape takes, bytes
// (mirrored by ops/short_attention.py::short_attention_bwd_batched_smem_bytes);
// 0 when no variant takes it.
long long short_attention_bwd_batched_smem_bytes(int s, int dh) {
  const Variant var = variant(s, dh);
  if (var == kNone) return 0;
  return (long long)(var == kTwoArrays ? geometry(s, dh) : geometry_inplace(s, dh)).smem;
}

// Which kernel this shape takes: 1 the two-array kernel, 2 the in-place one,
// 0 none (for the records and the Python mirror of the fit).
int short_attention_bwd_batched_variant(int s, int dh) { return (int)variant(s, dh); }

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
  SABB_DISPATCH(var, s, dh,
                return (int)launch(kernel, smem, q, k, v, dout, dq, dk, dv, b, s, heads, dh,
                                   scale, causal, vec, st);)
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM at this shape (0 with an error or a shape no
// variant takes), for the records.
int short_attention_bwd_batched_occupancy(int s, int dh) {
  const Variant var = variant(s, dh);
  SABB_DISPATCH(var, s, dh, return occupancy(kernel, smem);)
  return 0;
}

const char* short_attention_bwd_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
