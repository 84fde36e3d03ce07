// Flash (blockwise) self-attention forward for Hopper (sm_90a): K7 fwd.
//
// Replaces the Pallas TPU kernel that distributed_sigmoid_loss_tpu/ops/
// flash_attention.py::flash_self_attention (:72) calls at :110: the forward
// pallas_call of jax/experimental/pallas/ops/tpu/flash_attention.py (body
// _flash_attention_kernel_single_batch), per (batch row, head), with the
// upstream kernel's rounding points per key tile, at this kernel's 64-key
// tile where JAX's is 128, 256 or 512 keys (so the bf16 roundings fall at
// other running maxima; ops/flash_attention.py):
//   s  = f32(q·kᵀ)·scale, keys past the ragged end (and above the diagonal,
//        causal) masked out;
//   per key tile: m' = max(m, rowmax(s)), p = exp(s − m') (unnormalised),
//   α = exp(m − m'), l' = rowsum(p) + α·l, and with r = 1/l' taken once,
//   acc = acc·(α·l·r) + (bf16(p)·v)·r;
//   out = bf16(acc); the row statistics m and l are saved in f32 for the
//   backward (flash_attention_bwd.cu).
// With a single key tile in the whole sequence (s <= 64) the upstream
// single-step body runs instead: p = exp(s − m) / l, normalised before it is
// rounded to bf16 for p·v.
//
// Bound on this card: at SigLIP-B/16 at 512 px (b=32, s=1024, h=12, dh=64)
// q, k, v and out are 4·32·1024·768·2 B = 201 MB, 60 µs at 3.35 TB/s, while
// the two products are 4·32·12·1024²·64 = 103 GFLOP, 104 µs at 989 TFLOP/s:
// the tensor cores bound it, and every byte is read once.
//
// Design. One block of four warps per (64-row query tile, head, batch row),
// reading the towers' native (b, s, h·dh) layout at stride width (no
// transposes, no padded copies). Each warp owns 16 query rows whose q
// fragments stay in registers. Key and value tiles of 64 rows stream through
// a two-stage cp.async ring in shared memory, so the next tile's copy
// overlaps this tile's products. The logits, p and the output accumulator
// live in registers in mma.sync m16n8k16's documented layout: row statistics
// are quad shuffles, and bf16(p) is the A operand of p·v as it stands.
// Nothing O(s²) leaves the SM. The ragged tail is zero-filled in shared
// memory and masked by index; causal blocks visit only the key tiles up to
// their diagonal (upstream below_or_on_diag) and run heaviest first. The
// rescaling uses explicitly rounded multiplies and adds (no FMA contraction),
// so the kernel rounds where its plain version does. wgmma/TMA pipelining is
// later work.

#include "short_attention_common.cuh"

using namespace short_attention;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows of a block, 16 per warp
constexpr int kBlockK = 64;           // keys of a streamed tile (8 mma n-tiles)
constexpr int kMaxHeadDim = 128;

struct Geometry {
  int dh_pad;   // head dim padded to the 16-deep MMA step
  int ld;       // row stride of every tile, bf16 elements (+8: conflict-free ldmatrix)
  size_t smem;  // the Q tile and two stages of (K, V) tiles, bytes
};

__host__ __device__ inline Geometry geometry(int dh) {
  Geometry g;
  g.dh_pad = round_up(dh, 16);
  g.ld = g.dh_pad + 8;
  g.smem = (size_t)(kBlockQ + 2 * 2 * kBlockK) * g.ld * sizeof(bf16);
  return g;
}

template <int DT>  // DT = dh_pad / 16
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ stats, int s, int heads, int dh, float scale,
                           int causal, int vec) {
  constexpr int NT8 = 2 * DT;  // 8-wide head-dim tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(dh);
  const int width = heads * dh;
  const int n_tiles = (s + kBlockK - 1) / kBlockK;
  const int qt = causal ? n_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row and column pair
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int q0 = qt * kBlockQ;
  const int row_a = q0 + warp * 16 + gq, row_b = row_a + 8;
  // Keys [0, lim) are live for a row; causal blocks stop at their diagonal tile.
  const int lim_a = causal ? min(row_a + 1, s) : s;
  const int lim_b = causal ? min(row_b + 1, s) : s;
  const int n_visit = causal ? qt + 1 : n_tiles;
  const bool single = n_tiles == 1;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  const int tile = kBlockK * g.ld;

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv = qs + kBlockQ * g.ld;  // stage st: K at kv + 2·st·tile, V one tile after

  load_tile(qs, q + slab, q0, kBlockQ, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  load_tile(kv, k + slab, 0, kBlockK, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  load_tile(kv + tile, v + slab, 0, kBlockK, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  cp_async_commit();

  unsigned qa[DT][4];
  float acc[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_visit; ++j) {
    if (j + 1 < n_visit) {
      bf16* nk = kv + 2 * ((j + 1) & 1) * tile;
      const int r0 = (j + 1) * kBlockK;
      load_tile(nk, k + slab, r0, kBlockK, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
      load_tile(nk + tile, v + slab, r0, kBlockK, s, width, dh, g.dh_pad, g.ld, tid, kThreads,
                vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int t = 0; t < DT; ++t)
        ldsm_x4(qa[t], qs + (warp * 16 + ri + (mi & 1) * 8) * g.ld + t * 16 + (mi >> 1) * 8);
    }
    const bf16* ks = kv + 2 * (j & 1) * tile;
    const bf16* vs = ks + tile;
    const int k0 = j * kBlockK;

    // s = q·kᵀ: the warp's 16 rows × 64 keys, eight 8-key n-tiles.
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        unsigned bk[4];
        ldsm_x4(bk, ks + (8 * n + ri + (mi >> 1) * 8) * g.ld + t * 16 + (mi & 1) * 8);
        mma(sc[n], qa[t], bk[0], bk[1]);
        mma(sc[n + 1], qa[t], bk[2], bk[3]);
      }
    }

    // Scale, mask, and this tile's row maxima (rows a: registers 0, 1; b: 2, 3).
    float mc_a = -INFINITY, mc_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = k0 + 8 * n + 2 * tq;
      sc[n][0] = c < lim_a ? __fmul_rn(sc[n][0], scale) : -INFINITY;
      sc[n][1] = c + 1 < lim_a ? __fmul_rn(sc[n][1], scale) : -INFINITY;
      sc[n][2] = c < lim_b ? __fmul_rn(sc[n][2], scale) : -INFINITY;
      sc[n][3] = c + 1 < lim_b ? __fmul_rn(sc[n][3], scale) : -INFINITY;
      mc_a = fmaxf(mc_a, fmaxf(sc[n][0], sc[n][1]));
      mc_b = fmaxf(mc_b, fmaxf(sc[n][2], sc[n][3]));
    }
    // Every visited tile holds a live key for every row (key k0 <= the row),
    // so the new maxima are finite; exp(-inf) = 0 on masked keys and on the
    // first tile's α.
    const float mn_a = fmaxf(m_a, quad_max(mc_a)), mn_b = fmaxf(m_b, quad_max(mc_b));
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = expf(__fsub_rn(sc[n][0], mn_a));
      sc[n][1] = expf(__fsub_rn(sc[n][1], mn_a));
      sc[n][2] = expf(__fsub_rn(sc[n][2], mn_b));
      sc[n][3] = expf(__fsub_rn(sc[n][3], mn_b));
      rs_a += sc[n][0] + sc[n][1];
      rs_b += sc[n][2] + sc[n][3];
    }
    const float lc_a = __fmul_rn(expf(__fsub_rn(m_a, mn_a)), l_a);
    const float lc_b = __fmul_rn(expf(__fsub_rn(m_b, mn_b)), l_b);
    l_a = __fadd_rn(quad_sum(rs_a), lc_a);
    l_b = __fadd_rn(quad_sum(rs_b), lc_b);
    m_a = mn_a;
    m_b = mn_b;
    const float r_a = l_a == 0.f ? 1.f : __fdiv_rn(1.f, l_a);
    const float r_b = l_b == 0.f ? 1.f : __fdiv_rn(1.f, l_b);
    if (single) {  // upstream single-step body: p normalised before the cast
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sc[n][0] = __fdiv_rn(sc[n][0], l_a);
        sc[n][1] = __fdiv_rn(sc[n][1], l_a);
        sc[n][2] = __fdiv_rn(sc[n][2], l_b);
        sc[n][3] = __fdiv_rn(sc[n][3], l_b);
      }
    }
    const float f_a = __fmul_rn(lc_a, r_a), f_b = __fmul_rn(lc_b, r_b);

    // bf16(p) as the A operand: 16-key step kk is n-tiles 2kk and 2kk+1.
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }

    // o = bf16(p)·v by pairs of 8-wide head-dim tiles (V by ldmatrix.trans),
    // folded into the accumulator with the rescaling.
#pragma unroll
    for (int nd = 0; nd < NT8; nd += 2) {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned bv[4];
        ldsm_x4_t(bv, vs + (16 * kk + ri + (mi & 1) * 8) * g.ld + (nd + (mi >> 1)) * 8);
        mma(c0, pa[kk], bv[0], bv[1]);
        mma(c1, pa[kk], bv[2], bv[3]);
      }
      if (single) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[nd][e] = c0[e];
          acc[nd + 1][e] = c1[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float f = e < 2 ? f_a : f_b, r = e < 2 ? r_a : r_b;
          acc[nd][e] = __fadd_rn(__fmul_rn(acc[nd][e], f), __fmul_rn(c0[e], r));
          acc[nd + 1][e] = __fadd_rn(__fmul_rn(acc[nd + 1][e], f), __fmul_rn(c1[e], r));
        }
      }
    }
    __syncthreads();  // the stage is refilled in the next iteration but one
  }

#pragma unroll
  for (int nd = 0; nd < NT8; ++nd) {
    const int col = nd * 8 + 2 * tq;
    store_pair(out + slab, row_a, col, acc[nd][0], acc[nd][1], s, width, dh, vec);
    store_pair(out + slab, row_b, col, acc[nd][2], acc[nd][3], s, width, dh, vec);
  }
  if (tq == 0) {
    float* st = stats + ((size_t)b * heads + h) * 2 * s;  // [m | l] rows of (b, h)
    if (row_a < s) {
      st[row_a] = m_a;
      st[s + row_a] = l_a;
    }
    if (row_b < s) {
      st[row_b] = m_b;
      st[s + row_b] = l_b;
    }
  }
}

template <int DT>
cudaError_t configure(const Geometry& g) {
  return cudaFuncSetAttribute(flash_attention_fwd_kernel<DT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
}

template <int DT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* stats, int b,
                   int s, int heads, int dh, float scale, int causal, int vec,
                   cudaStream_t stream) {
  const Geometry g = geometry(dh);
  const cudaError_t err = configure<DT>(g);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, heads, b);
  flash_attention_fwd_kernel<DT><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(stats), s, heads, dh, scale, causal, vec);
  return cudaGetLastError();
}

template <int DT>
int occupancy(const Geometry& g) {
  int blocks = 0;
  cudaError_t err = configure<DT>(g);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_attention_fwd_kernel<DT>,
                                                        kThreads, g.smem);
  return err == cudaSuccess ? blocks : 0;
}

bool takes(int dh) { return dh >= 8 && dh <= kMaxHeadDim && dh % 8 == 0; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block, bytes (mirrored by
// ops/flash_attention.py::flash_attention_smem_bytes).
long long flash_attention_fwd_smem_bytes(int dh) { return (long long)geometry(dh).smem; }

// q, k, v, out: (b, s, heads·dh) bf16, contiguous; stats: (b, heads, 2, s)
// f32, the row maxima m then the row sums l. One launch; returns its
// cudaError_t (0 on success) and does not synchronise. cudaErrorInvalidValue
// for a head dim that is not a multiple of 8 in [8, 128].
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* stats,
                        int b, int s, int heads, int dh, float scale, int causal, int vec,
                        void* stream) {
  if (b < 1 || b > 65535 || s < 1 || heads < 1 || heads > 65535 || !takes(dh))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(DT) \
  case DT:            \
    return (int)launch<DT>(q, k, v, out, stats, b, s, heads, dh, scale, causal, vec, st);
  switch (round_up(dh, 16) / 16) {
    FA_LAUNCH(1) FA_LAUNCH(2) FA_LAUNCH(3) FA_LAUNCH(4) FA_LAUNCH(5) FA_LAUNCH(6) FA_LAUNCH(7)
    FA_LAUNCH(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

// Resident blocks per SM at this head dim (0 with an error), for the records.
int flash_attention_fwd_occupancy(int dh) {
  if (!takes(dh)) return 0;
  const Geometry g = geometry(dh);
#define FA_OCC(DT) \
  case DT:         \
    return occupancy<DT>(g);
  switch (g.dh_pad / 16) {
    FA_OCC(1) FA_OCC(2) FA_OCC(3) FA_OCC(4) FA_OCC(5) FA_OCC(6) FA_OCC(7) FA_OCC(8)
    default: return 0;
  }
#undef FA_OCC
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
