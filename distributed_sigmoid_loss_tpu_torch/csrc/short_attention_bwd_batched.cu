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

#include "short_attention_common.cuh"

using namespace short_attention;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKeyTiles = 13;  // s <= 208: the logits of 16 rows stay in registers
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

template <int NT>
cudaError_t configure(const Geometry& g) {
  cudaError_t err = cudaFuncSetAttribute(short_attention_bwd_batched_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(short_attention_bwd_batched_kernel<NT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int NT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, int b, int s, int heads, int dh, float scale, int causal,
                   int vec, cudaStream_t stream) {
  const Geometry g = geometry(s, dh);
  cudaError_t err = configure<NT>(g);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, b);
  short_attention_bwd_batched_kernel<NT><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, heads, dh, scale, causal, vec);
  return cudaGetLastError();
}

template <int NT>
int occupancy(const Geometry& g) {
  int blocks = 0;
  cudaError_t err = configure<NT>(g);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, short_attention_bwd_batched_kernel<NT>, kThreads, g.smem);
  return err == cudaSuccess ? blocks : 0;
}

bool takes(int s, int dh) {
  if (s < 1 || dh < 1 || dh > kMaxHeadDim) return false;
  const Geometry g = geometry(s, dh);
  return g.s_pad / 16 <= kMaxKeyTiles && g.smem <= 227 * 1024;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, bytes (mirrored by
// ops/short_attention.py::short_attention_bwd_batched_smem_bytes).
long long short_attention_bwd_batched_smem_bytes(int s, int dh) {
  return (long long)geometry(s, dh).smem;
}

// q, k, v, dout, dq, dk, dv: (b, s, heads·dh) bf16, contiguous. One launch;
// returns its cudaError_t (0 on success) and does not synchronise.
// cudaErrorInvalidValue for a shape the kernel does not take (s > 208, dh >
// 128, or over the shared-memory budget).
int short_attention_bwd_batched(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, int b, int s, int heads, int dh,
                                float scale, int causal, int vec, void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || !takes(s, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SABB_LAUNCH(NT) \
  case NT:              \
    return (int)launch<NT>(q, k, v, dout, dq, dk, dv, b, s, heads, dh, scale, causal, vec, st);
  switch (round_up(s, 16) / 16) {
    SABB_LAUNCH(1) SABB_LAUNCH(2) SABB_LAUNCH(3) SABB_LAUNCH(4) SABB_LAUNCH(5) SABB_LAUNCH(6)
    SABB_LAUNCH(7) SABB_LAUNCH(8) SABB_LAUNCH(9) SABB_LAUNCH(10) SABB_LAUNCH(11)
    SABB_LAUNCH(12) SABB_LAUNCH(13)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SABB_LAUNCH
}

// Resident blocks per SM at this shape (0 with an error or a shape the
// kernel does not take), for the records.
int short_attention_bwd_batched_occupancy(int s, int dh) {
  if (!takes(s, dh)) return 0;
  const Geometry g = geometry(s, dh);
#define SABB_OCC(NT) \
  case NT:           \
    return occupancy<NT>(g);
  switch (g.s_pad / 16) {
    SABB_OCC(1) SABB_OCC(2) SABB_OCC(3) SABB_OCC(4) SABB_OCC(5) SABB_OCC(6) SABB_OCC(7)
    SABB_OCC(8) SABB_OCC(9) SABB_OCC(10) SABB_OCC(11) SABB_OCC(12) SABB_OCC(13)
    default: return 0;
  }
#undef SABB_OCC
}

const char* short_attention_bwd_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
