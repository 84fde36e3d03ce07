// Flash (blockwise) self-attention forward for Hopper (sm_90a): K7 fwd.
//
// Replaces the Pallas TPU kernel that distributed_sigmoid_loss_tpu/ops/
// flash_attention.py::flash_self_attention (:72) calls at :110: the forward
// pallas_call of jax/experimental/pallas/ops/tpu/flash_attention.py (body
// _flash_attention_kernel_single_batch), per (batch row, head), with the
// upstream kernel's rounding points per key tile, at this kernel's 64-key
// tile where JAX's is 128, 256 or 512 keys (so the bf16 roundings fall at
// other running maxima; ops/flash_attention.py):
//   s = f32(q·kᵀ)·scale, keys past the ragged end (and above the diagonal,
//       causal) masked out;
//   per key tile: m' = max(m, rowmax(s)), p = exp(s − m') unnormalised and
//   rounded to bf16 for p·v, l' = α·l + rowsum(p) with α = exp(m − m');
//   out = bf16(o / l) with o the sum of the tiles' bf16(p)·v, each earlier
//   sum rescaled by α; the row statistics m and l are saved in f32 for the
//   backward (flash_attention_bwd.cu).
// With a single key tile in the whole sequence (s <= 64) the upstream
// single-step body runs instead: p = exp(s − m) / l, normalised before it is
// rounded to bf16 for p·v.
//
// Bound on this card: at SigLIP-B/16 at 512 px (b=32, s=1024, h=12, dh=64)
// q, k, v and out are 4·32·1024·768·2 B = 201 MB, 60 µs at 3.35 TB/s, while
// the two products are 4·32·12·1024²·64 = 103 GFLOP, 104 µs at 989 TFLOP/s:
// the tensor cores bound it, and only wgmma reaches their full rate.
//
// Two bodies, picked by shape in flash_attention_fwd:
// - The warpgroup body (head dims 64 and 128, the towers' B/16, L/14 and
//   context shapes): one block of three warpgroups per (128-row query tile,
//   head, batch row). A producer warpgroup keeps a ring of 64-key K and V
//   tiles in shared memory (8 tiles at dh=64, 4 at 128; each its own stage
//   with a full and an empty mbarrier), filled by TMA through 3-D tensor
//   maps over the towers' native (b, s, h·dh) layout (the head is the box's
//   column offset; rows past s are zero-filled by TMA, never read from the
//   next batch row) in 128-byte-swizzled 64-column panels; Q's tile is
//   loaded once. Two consumer warpgroups own 64 query rows each, so each
//   K/V tile is read from L2 once per 128 query rows. s = q·kᵀ is a wgmma
//   with both operands in shared memory; p stays in registers and is the A
//   operand of o += bf16(p)·v, a wgmma with V's descriptor transposed.
//   setmaxnreg moves registers from the producer to the consumers. Per
//   element the softmax is one FMA and one ex2.approx, 2^(x·scale·log2e −
//   m·scale·log2e), with m kept, and stored, in the natural-log domain as
//   max(x·scale); o is rescaled by α with the tile's product accumulated on
//   top, and normalised once at the end. Tensors whose rows are not 16-byte
//   aligned (no TMA) take the same body with the producer warpgroup writing
//   the swizzled tiles element by element, so both round identically.
// - The mma.sync body (every other head dim, a multiple of 8 up to 128,
//   e.g. So400m's 72, which does not fill the 128-byte swizzle atoms): one
//   block of four warps per (64-row query tile, head, batch row), q
//   fragments in registers, K/V tiles through a two-stage cp.async ring,
//   logits, p and the accumulator in mma.sync m16n8k16's register layout.
//   It rounds where the plain version does (explicitly rounded multiplies
//   and adds, IEEE exp, the accumulator normalised per tile).
// Both mask the ragged tail by index, and causal blocks visit only the key
// tiles up to their diagonal (upstream below_or_on_diag) and run heaviest
// first. Nothing O(s²) leaves the SM.

#include "short_attention_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

using namespace short_attention;

namespace {

using bf16 = __nv_bfloat16;

// ---- the warpgroup body --------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 40;

template <int DH>
struct Wg {
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kTileBytes = 64 * DH * 2;           // one 64-row K or V tile
  static constexpr int kConsumers = 2;                     // warpgroups of 64 query rows
  static constexpr int kRows = 64 * kConsumers;            // query rows of a block
  static constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
  static constexpr int kQBytes = kRows * DH * 2;           // the block's Q tile
  static constexpr int kStages = DH == 64 ? 8 : 4;         // ring entries, a K or a V tile each
  static constexpr int kMinBlocks = DH == 64 ? 2 : 1;
  // Consumer registers within the block's launch allocation (80 a thread at
  // two blocks per SM, 168 at one) after the producer gives up its own.
  static constexpr int kConsumerRegs = DH == 64 ? 96 : 232;
  static constexpr size_t kSmem =
      1024 + kQBytes + (size_t)kStages * kTileBytes + (2 * kStages + 1) * sizeof(uint64_t);
};

template <int DH>
__global__ void __launch_bounds__(Wg<DH>::kThreads, Wg<DH>::kMinBlocks)
flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, bf16* __restrict__ out,
                                 float* __restrict__ stats, int s, int heads, float scale,
                                 int causal, int vec) {
  using G = Wg<DH>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + G::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::kStages * G::kTileBytes);
  uint64_t* empty = full + G::kStages;
  uint64_t* qbar = empty + G::kStages;

  const int width = heads * DH;
  const int n_tiles = (s + 63) / 64, n_qb = (s + G::kRows - 1) / G::kRows;
  const int qb = causal ? n_qb - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * G::kRows;
  const int n_visit = causal ? min(G::kConsumers * (qb + 1), n_tiles) : n_tiles;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const size_t slab = (size_t)b * s * width + (size_t)h * DH;

  if (threadIdx.x == 0) {
    for (int e = 0; e < G::kStages; ++e) {
      mbar_init(&full[e], vec ? 1 : 128);
      mbar_init(&empty[e], 4 * G::kConsumers);  // one arrival per consumer warp
    }
    mbar_init(qbar, vec ? 1 : 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: Q once, then K0, V0, K1, V1, ... through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (vec) {
      if (t != 0) return;
      mbar_expect_tx(qbar, G::kQBytes);
      for (int p = 0; p < G::kPanels; ++p)
        for (int c = 0; c < G::kConsumers; ++c)
          tma_load(qs + p * G::kRows * 128 + c * 64 * 128, &q_map, qbar, h * DH + p * kPanel,
                   q0 + c * 64, b);
    } else {
      fill_swizzled<DH>(qs, q + slab, q0, G::kRows, s, width, t);
      mbar_arrive(qbar);
    }
    for (int i = 0; i < 2 * n_visit; ++i) {
      const int e = i % G::kStages, use = i / G::kStages;
      if (use > 0) mbar_wait(&empty[e], (use - 1) & 1);
      unsigned char* tile = ring + e * G::kTileBytes;
      if (vec) {
        mbar_expect_tx(&full[e], G::kTileBytes);
        for (int p = 0; p < G::kPanels; ++p)
          tma_load(tile + p * 64 * 128, (i & 1) ? &v_map : &k_map, &full[e], h * DH + p * kPanel,
                   (i / 2) * 64, b);
      } else {
        fill_swizzled<DH>(tile, ((i & 1) ? v : k) + slab, (i / 2) * 64, 64, s, width, t);
        mbar_arrive(&full[e]);
      }
    }
  } else {
    // Consumer c owns query rows q0 + 64c .. + 63; warp w of it rows 16w ..
    // 16w + 15 of those, in the accumulator layout of mma.sync (rows gq and
    // gq + 8, columns 2tq and 2tq + 1 of every 8-wide tile).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs));
    const int c = wg - 1, w = t / 32, lane = t % 32, gq = lane >> 2, tq = lane & 3;
    const int row_a = q0 + 64 * c + 16 * w + gq, row_b = row_a + 8;
    const int lim_a = causal ? min(row_a + 1, s) : s;
    const int lim_b = causal ? min(row_b + 1, s) : s;
    const int my_visit = causal ? min(G::kConsumers * qb + c + 1, n_tiles) : n_tiles;
    const bool single = n_tiles == 1;
    const float sl = scale * kLog2e;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // m in x units (unscaled)
    float al_a = 0.f, al_b = 0.f;  // the latest tile's rescale factors α
    unsigned pa[4][4];             // the latest tile's bf16(p)

    // Ring entries and phases of tile j's K and V.
    auto k_entry = [&](int j) { return (2 * j) % G::kStages; };
    auto v_entry = [&](int j) { return (2 * j + 1) % G::kStages; };
    auto k_phase = [&](int j) { return (unsigned)((2 * j) / G::kStages) & 1u; };
    auto v_phase = [&](int j) { return (unsigned)((2 * j + 1) / G::kStages) & 1u; };
    auto release = [&](int e) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[e]);
    };
    // s = q·kᵀ of tile j into sc, issued (uncommitted).
    auto issue_s = [&](int j, float (&sc)[32]) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64(sc, sw128_desc(qs + p * G::kRows * 128 + c * 64 * 128 + off, 16),
                     sw128_desc(ring + k_entry(j) * G::kTileBytes + p * 64 * 128 + off, 16),
                     kk > 0);
      }
    };
    // o += bf16(p)·v of tile j, issued (uncommitted).
    auto issue_pv = [&](int j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_dh<DH>(o, pa[kk],
                        sw128_desc(ring + v_entry(j) * G::kTileBytes + kk * 2048, 64 * 128));
    };
    // The softmax of tile j's raw logits sc: mask, running max and sum, α,
    // and bf16(p) packed as the A operand into pn (16-key step kk = 8-key
    // tiles 2kk and 2kk+1; rows a: registers 4n, 4n+1; b: 4n+2, 4n+3).
    auto softmax = [&](int j, float (&sc)[32], unsigned (&pn)[4][4]) {
      const int k0 = j * 64;
      if (k0 + 64 > min(lim_a, lim_b)) {  // a tile past some row's limit: mask
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = k0 + 8 * n + 2 * tq;
          sc[4 * n] = col < lim_a ? sc[4 * n] : -INFINITY;
          sc[4 * n + 1] = col + 1 < lim_a ? sc[4 * n + 1] : -INFINITY;
          sc[4 * n + 2] = col < lim_b ? sc[4 * n + 2] : -INFINITY;
          sc[4 * n + 3] = col + 1 < lim_b ? sc[4 * n + 3] : -INFINITY;
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      // Every visited tile holds a live key for every row, so the new
      // maxima are finite; 2^-inf = 0 on masked keys and the first α.
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      const float nm_a = -mn_a * sl, nm_b = -mn_b * sl;
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sc[4 * n] = ex2(fmaf(sc[4 * n], sl, nm_a));
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl, nm_a));
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl, nm_b));
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl, nm_b));
        rs_a += sc[4 * n] + sc[4 * n + 1];
        rs_b += sc[4 * n + 2] + sc[4 * n + 3];
      }
      rs_a = quad_sum(rs_a);
      rs_b = quad_sum(rs_b);
      if (single) {  // upstream single-step body: p normalised before the cast
        l_a = rs_a;
        l_b = rs_b;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          sc[4 * n] = __fdiv_rn(sc[4 * n], l_a);
          sc[4 * n + 1] = __fdiv_rn(sc[4 * n + 1], l_a);
          sc[4 * n + 2] = __fdiv_rn(sc[4 * n + 2], l_b);
          sc[4 * n + 3] = __fdiv_rn(sc[4 * n + 3], l_b);
        }
      } else {
        al_a = ex2(fmaf(m_a, sl, nm_a));
        al_b = ex2(fmaf(m_b, sl, nm_b));
        l_a = fmaf(l_a, al_a, rs_a);
        l_b = fmaf(l_b, al_b, rs_b);
      }
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pn[kk][0] = pack(sc[8 * kk], sc[8 * kk + 1]);
        pn[kk][1] = pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pn[kk][2] = pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pn[kk][3] = pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    mbar_wait(qbar, 0);
    for (int j = 0; j < my_visit; ++j) {
      float sc[32];  // overwritten by the first product (scale_d = 0)
      mbar_wait(&full[k_entry(j)], k_phase(j));
      wgmma_fence();
      issue_s(j, sc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      release(k_entry(j));
      softmax(j, sc, pa);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {  // o (0 before the first tile) to the new maxima
        o[4 * n] *= al_a;
        o[4 * n + 1] *= al_a;
        o[4 * n + 2] *= al_b;
        o[4 * n + 3] *= al_b;
      }
      mbar_wait(&full[v_entry(j)], v_phase(j));
      wgmma_fence();
      issue_pv(j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      release(v_entry(j));
    }

    const float r_a = single ? 1.f : 1.f / l_a, r_b = single ? 1.f : 1.f / l_b;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = 8 * n + 2 * tq;
      store_pair(out + slab, row_a, col, o[4 * n] * r_a, o[4 * n + 1] * r_a, s, width, DH, vec);
      store_pair(out + slab, row_b, col, o[4 * n + 2] * r_b, o[4 * n + 3] * r_b, s, width, DH, vec);
    }
    if (tq == 0) {
      float* st = stats + ((size_t)b * heads + h) * 2 * s;  // [m | l] rows of (b, h)
      if (row_a < s) {
        st[row_a] = m_a * scale;
        st[s + row_a] = l_a;
      }
      if (row_b < s) {
        st[row_b] = m_b * scale;
        st[s + row_b] = l_b;
      }
    }
  }
}

// Sets the kernel's shared memory; refuses a build whose launch allocation
// cannot cover the registers setmaxnreg hands the consumers (the consumers
// would wait for them forever).
template <int DH>
cudaError_t configure_wgmma() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_attention_fwd_wgmma_kernel<DH>);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * Wg<DH>::kThreads <
      128 * kProducerRegs + 128 * Wg<DH>::kConsumers * Wg<DH>::kConsumerRegs)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(flash_attention_fwd_wgmma_kernel<DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Wg<DH>::kSmem);
}

template <int DH>
int occupancy_wgmma() {
  int blocks = 0;
  cudaError_t err = configure_wgmma<DH>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_attention_fwd_wgmma_kernel<DH>, Wg<DH>::kThreads, Wg<DH>::kSmem);
  return err == cudaSuccess ? blocks : 0;
}

template <int DH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, void* stats, int b,
                         int s, int heads, float scale, int causal, int vec, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  cudaError_t err = configure_wgmma<DH>();
  if (vec) {
    const void* ptrs[3] = {q, k, v};
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      err = make_map(&maps[i], ptrs[i], b, s, heads * DH);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((s + Wg<DH>::kRows - 1) / Wg<DH>::kRows, heads, b);
  flash_attention_fwd_wgmma_kernel<DH><<<grid, Wg<DH>::kThreads, Wg<DH>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(stats), s, heads,
      scale, causal, vec);
  return cudaGetLastError();
}

// ---- the mma.sync body ---------------------------------------------------

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

// The body a head dim takes: the warpgroup body at 64 and 128, the mma.sync
// body at every other head dim the kernels take.
bool warpgroup_body(int dh) { return dh == 64 || dh == 128; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the body this head dim takes, bytes
// (mirrored by ops/flash_attention.py::flash_attention_smem_bytes).
long long flash_attention_fwd_smem_bytes(int dh) {
  if (dh == 64) return (long long)Wg<64>::kSmem;
  if (dh == 128) return (long long)Wg<128>::kSmem;
  return (long long)geometry(dh).smem;
}

// The body a call takes, for the records: 1 = warpgroup body fed by TMA,
// 2 = warpgroup body with element-wise loads (rows not 16-byte aligned),
// 0 = mma.sync body; -1 for a head dim the kernels do not take.
int flash_attention_fwd_body(int dh, int vec) {
  if (!takes(dh)) return -1;
  return warpgroup_body(dh) ? (vec ? 1 : 2) : 0;
}

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
  if (dh == 64)
    return (int)launch_wgmma<64>(q, k, v, out, stats, b, s, heads, scale, causal, vec, st);
  if (dh == 128)
    return (int)launch_wgmma<128>(q, k, v, out, stats, b, s, heads, scale, causal, vec, st);
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

// Resident blocks per SM of the body this head dim takes (0 with an error),
// for the records.
int flash_attention_fwd_occupancy(int dh) {
  if (!takes(dh)) return 0;
  if (dh == 64) return occupancy_wgmma<64>();
  if (dh == 128) return occupancy_wgmma<128>();
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
