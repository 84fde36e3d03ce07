// Fused short-sequence self-attention forward for Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel distributed_sigmoid_loss_tpu/ops/
// pallas_short_attention.py::_short_attention_fwd (body _fwd_kernel): per
// (batch row, head), out = softmax(q·kᵀ·scale [causal mask]) · v, with f32
// logits and softmax, the exact row max, p = exp(x − m)·(1/l) normalised
// before it is rounded to bf16, f32 accumulation of bf16(p)·v, output in bf16.
//
// Bound on this card: bytes, at every shape the towers give it. At ViT-B/16
// vision, b=128 (s=196, h=12, dh=64), q, k, v and out are
// 4·128·196·768·2 B ≈ 154 MB, ≈ 46 µs at 3.35 TB/s, while the two products
// are 15.1 GFLOP, ≈ 15 µs at 989 TFLOP/s (text, s=64, and L/14, s=256, are
// further on the bytes side).
//
// Design against that bound: read q, k and v once, write out once, and do
// nothing in shared memory that the bound does not need.
// - One block per (head, batch row): K and V of the head come from HBM
//   once, by 16-byte cp.async copies in the towers' native (b, s, h·dh)
//   layout (the head slice at stride width, no transposes), and stay in
//   shared memory while the block walks the head's query tiles. V's copy is
//   a second group that the first tile's logits and softmax overlap; the
//   next q tile is in flight during the current one. Three blocks per SM
//   (head dim up to 64) overlap one head's loads with another's products.
// - The logits never reach shared memory. They stay in the tensor cores'
//   accumulator registers (mma.sync's documented layout, which wgmma's
//   accumulator repeats per warp): row max and row sum are quad shuffles,
//   exp is one FMA and one ex2.approx per element (about 2 ulp in f32, far
//   below the bf16 rounding of p), and bf16(p·(1/l)) is packed straight
//   into the A operand of p·v. Masks apply only to the 8-key tiles that
//   reach past a row's limit (the ragged end, or the diagonal).
// - Three bodies, picked by shape in short_attention_fwd:
//   * the warpgroup body (head dim 64, 16-byte rows, s_pad <= 256: B/16's
//     vision s=196 and text s=64, L/14's s=256): one warpgroup a block, K
//     and V in 128-byte-swizzled shared memory, s = q·kᵀ as one wgmma chain
//     of N = 64, 208 or 256 keys per 64-row query tile (K is read from shared memory once
//     per 64 rows, not once per 16), and p·v as a register-A wgmma against
//     V's transposed descriptor;
//   * the mma.sync one-pass body (other head dims, or rows not 16-byte
//     aligned, up to s_pad = 208): four warps of 16-row tiles, warp w
//     taking tiles w, w+4, ..., with each warp's q tile staged in a buffer
//     of its own, and element-wise loads and stores where rows are not
//     16-byte aligned (vec = 0, e.g. width 60);
//   * the two-pass body (s_pad > 208, or > 256 at dh=64, up to the dispatch
//     limit, s=416 at dh=64): the mma.sync body over 64-key chunks of the resident K, an
//     online max and sum, then p·v with the final m and l (the logits are
//     recomputed; the extra product is cheap under the bytes bound; l is
//     summed in another order, within K1's tolerance).
//   Shared memory holds every key tile a body reads, zero past s, so the
//   product loops have no branches.

#include "short_attention_common.cuh"
#include "wgmma.cuh"

using namespace short_attention;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadTiles = 8;  // head_dim <= 128
constexpr int kChunk = 8;         // 8-key tiles per chunk of the two-pass body (64 keys)
constexpr float kLog2e = 1.4426950408889634f;

// 8-key tiles of a row held in registers by the one-pass body, 0 for the
// two-pass body.
__host__ __device__ inline int resident_tiles(int s) {
  const int s_pad = round_up(s, 16);
  return s_pad <= 64 ? 8 : s_pad <= 208 ? 26 : 0;
}

struct Geometry {
  int rows;     // K/V rows in shared memory: every key tile a body reads, zero past s
  int dh_pad;   // head dim padded to the 16-wide MMA step
  int ld;       // K/V/q row stride in bf16 elements (+8: conflict-free ldmatrix)
  size_t smem;  // K and V of the head and four 16-row q buffers, bytes
};

__host__ __device__ inline Geometry geometry(int s, int dh) {
  Geometry g;
  const int nt = resident_tiles(s);
  g.rows = nt ? 8 * nt : round_up(s, 64);
  g.dh_pad = round_up(dh, 16);
  g.ld = g.dh_pad + 8;
  g.smem = (size_t)(2 * g.rows + kWarps * 16) * g.ld * sizeof(bf16);
  return g;
}

// sc[n] = q·kᵀ for the 8-key tiles n0 + n of the warp's 16 rows (branch
// free: the rows are in shared memory, zero past s).
template <int DT, int N>
__device__ inline void logits(float (&sc)[N][4], const unsigned (&qa)[DT][4], const bf16* ks,
                              int ld, int n0, int mi, int ri) {
#pragma unroll
  for (int n = 0; n < N; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      unsigned bk[4];
      ldsm_x4(bk, ks + (8 * (n0 + n) + ri + (mi >> 1) * 8) * ld + t * 16 + (mi & 1) * 8);
      mma(sc[n], qa[t], bk[0], bk[1]);
      mma(sc[n + 1], qa[t], bk[2], bk[3]);
    }
  }
}

// Keys at or past a row's limit to -inf (rows a: registers 0, 1; b: 2, 3),
// in the 8-key tiles that reach past the lower of the two limits; returns
// the quad's row maxima of the raw (unscaled) logits.
template <int N>
__device__ inline void mask_max(float (&sc)[N][4], int key0, int lim_a, int lim_b, int tq,
                                float& mx_a, float& mx_b) {
  const int lim = min(lim_a, lim_b);
  mx_a = mx_b = -INFINITY;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = key0 + 8 * n + 2 * tq;
    if (key0 + 8 * n + 8 > lim) {
      sc[n][0] = c < lim_a ? sc[n][0] : -INFINITY;
      sc[n][1] = c + 1 < lim_a ? sc[n][1] : -INFINITY;
      sc[n][2] = c < lim_b ? sc[n][2] : -INFINITY;
      sc[n][3] = c + 1 < lim_b ? sc[n][3] : -INFINITY;
    }
    mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
}

// sc = exp(scale·(x − max)) = 2^(x·sl − max·sl) in place (masked keys give 0);
// returns the quad's row sums.
template <int N>
__device__ inline void exp_sum(float (&sc)[N][4], float sl, float nm_a, float nm_b, float& rs_a,
                               float& rs_b) {
  rs_a = rs_b = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    sc[n][0] = ex2(fmaf(sc[n][0], sl, nm_a));
    sc[n][1] = ex2(fmaf(sc[n][1], sl, nm_a));
    sc[n][2] = ex2(fmaf(sc[n][2], sl, nm_b));
    sc[n][3] = ex2(fmaf(sc[n][3], sl, nm_b));
    rs_a += sc[n][0] + sc[n][1];
    rs_b += sc[n][2] + sc[n][3];
  }
  rs_a = quad_sum(rs_a);
  rs_b = quad_sum(rs_b);
}

// acc += bf16(p·r)·v over the 16-key steps of tiles n0.. (p in sc).
template <int DT, int N>
__device__ inline void pv(float (&acc)[2 * DT][4], const float (&sc)[N][4], float r_a, float r_b,
                          const bf16* vs, int ld, int n0, int mi, int ri) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    unsigned pa[4];
    pa[0] = pack(sc[2 * kk][0] * r_a, sc[2 * kk][1] * r_a);
    pa[1] = pack(sc[2 * kk][2] * r_b, sc[2 * kk][3] * r_b);
    pa[2] = pack(sc[2 * kk + 1][0] * r_a, sc[2 * kk + 1][1] * r_a);
    pa[3] = pack(sc[2 * kk + 1][2] * r_b, sc[2 * kk + 1][3] * r_b);
    const int key0 = 8 * (n0 + 2 * kk);
#pragma unroll
    for (int nd = 0; nd < 2 * DT; nd += 2) {
      unsigned bv[4];
      ldsm_x4_t(bv, vs + (key0 + ri + (mi & 1) * 8) * ld + (nd + (mi >> 1)) * 8);
      mma(acc[nd], pa, bv[0], bv[1]);
      mma(acc[nd + 1], pa, bv[2], bv[3]);
    }
  }
}

// Three blocks per SM (168 registers a thread) up to head dim 64; the
// one-pass body at wider heads needs more registers than that.
template <int DT, int NT>  // DT = dh_pad / 16; NT = resident_tiles(s)
__global__ void __launch_bounds__(kThreads, DT <= 4 ? 3 : 1)
short_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int s, int heads,
                           int dh, float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geometry g = geometry(s, dh);
  const int width = heads * dh;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row and column pair
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int n_qt = (s + 15) / 16;
  const float sl = scale * kLog2e;

  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + g.rows * g.ld;
  bf16* qs = vs + g.rows * g.ld + warp * 16 * g.ld;  // this warp's q tile

  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  // Two copy groups: K with each warp's first q tile, then V, which the
  // first tiles' logits and softmax overlap.
  load_tile(ks, k + slab, 0, g.rows, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  if (warp < n_qt) load_tile(qs, q + slab, warp * 16, 16, s, width, dh, g.dh_pad, g.ld, lane, 32, vec);
  cp_async_commit();
  load_tile(vs, v + slab, 0, g.rows, s, width, dh, g.dh_pad, g.ld, tid, kThreads, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // K in place; warps own their tiles from here
  // V in place: each warp joins this barrier once, before its first p·v
  // (or on its way out when it has no tile). `pending` = its copy groups
  // issued after V's.
  auto wait_v = [&](bool pending) {
    if (pending) cp_async_wait<1>();
    else cp_async_wait<0>();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  };
  if (warp >= n_qt) {
    wait_v(false);
    return;
  }
  bool v_ready = false;

  for (int qt = warp; qt < n_qt; qt += kWarps) {
    const int r0 = qt * 16, row_a = r0 + gq, row_b = row_a + 8;
    // Keys [0, lim) are live for a row; a causal tile's keys end at its diagonal.
    const int lim_a = causal ? min(row_a + 1, s) : s;
    const int lim_b = causal ? min(row_b + 1, s) : s;
    // 8-key tiles up to the tile's last live key (a causal tile's diagonal).
    const int nt_live = round_up(causal ? min(r0 + 16, s) : s, 16) / 8;

    unsigned qa[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t) ldsm_x4(qa[t], qs + (ri + (mi & 1) * 8) * g.ld + t * 16 + (mi >> 1) * 8);
    __syncwarp();
    const bool prefetch = qt + kWarps < n_qt;
    if (prefetch) {  // the next tile's q, in flight during this one
      load_tile(qs, q + slab, r0 + 16 * kWarps, 16, s, width, dh, g.dh_pad, g.ld, lane, 32, vec);
      cp_async_commit();
    }

    float acc[2 * DT][4];
#pragma unroll
    for (int n = 0; n < 2 * DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if constexpr (NT > 0) {
      // One pass: the row's logits whole in registers.
      float sc[NT][4], mx_a, mx_b, rs_a, rs_b;
      logits<DT, NT>(sc, qa, ks, g.ld, 0, mi, ri);
      mask_max<NT>(sc, 0, lim_a, lim_b, tq, mx_a, mx_b);
      exp_sum<NT>(sc, sl, -mx_a * sl, -mx_b * sl, rs_a, rs_b);
      if (!v_ready) wait_v(prefetch);
      v_ready = true;
      pv<DT, NT>(acc, sc, 1.f / rs_a, 1.f / rs_b, vs, g.ld, 0, mi, ri);
    } else {
      // Two passes over 64-key chunks: online max and sum, then p·v.
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      for (int c = 0; c < nt_live; c += kChunk) {
        float sc[kChunk][4], mx_a, mx_b, rs_a, rs_b;
        logits<DT, kChunk>(sc, qa, ks, g.ld, c, mi, ri);
        mask_max<kChunk>(sc, 8 * c, lim_a, lim_b, tq, mx_a, mx_b);
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float nm_a = -mn_a * sl, nm_b = -mn_b * sl;
        exp_sum<kChunk>(sc, sl, nm_a, nm_b, rs_a, rs_b);
        // The first chunk's α is 2^-inf = 0 (every row has key 0 live).
        l_a = fmaf(l_a, ex2(fmaf(m_a, sl, nm_a)), rs_a);
        l_b = fmaf(l_b, ex2(fmaf(m_b, sl, nm_b)), rs_b);
        m_a = mn_a;
        m_b = mn_b;
      }
      const float r_a = 1.f / l_a, r_b = 1.f / l_b;
      if (!v_ready) wait_v(prefetch);
      v_ready = true;
      for (int c = 0; c < nt_live; c += kChunk) {
        float sc[kChunk][4], mx_a, mx_b, rs_a, rs_b;
        logits<DT, kChunk>(sc, qa, ks, g.ld, c, mi, ri);
        mask_max<kChunk>(sc, 8 * c, lim_a, lim_b, tq, mx_a, mx_b);
        exp_sum<kChunk>(sc, sl, -m_a * sl, -m_b * sl, rs_a, rs_b);
        pv<DT, kChunk>(acc, sc, r_a, r_b, vs, g.ld, c, mi, ri);
      }
    }

#pragma unroll
    for (int nd = 0; nd < 2 * DT; ++nd) {
      const int col = nd * 8 + 2 * tq;
      store_pair(out + slab, row_a, col, acc[nd][0], acc[nd][1], s, width, dh, vec);
      store_pair(out + slab, row_b, col, acc[nd][2], acc[nd][3], s, width, dh, vec);
    }
    cp_async_wait_all();  // the next tile's q has landed
    __syncwarp();
  }
}

// ---- the warpgroup body: head dim 64, rows 16-byte aligned, s_pad <= 256 ----

// Copy rows [row0, row0 + rows) of one head's (s, 64) slice into 128-byte
// rows of shared memory, 16-byte chunk c of row r at chunk c ⊕ (r % 8) (the
// 128-byte swizzle that wgmma's descriptors read), zero past s.
__device__ inline void load_swizzled(unsigned char* dst, const bf16* src, int row0, int rows, int s,
                                     int width, int tid) {
  for (int i = tid; i < rows * 8; i += kThreads) {
    const int r = i / 8, c = i % 8, row = row0 + r;
    const bool live = row < s;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), live ? src + (size_t)row * width + c * 8 : src,
               live ? 16 : 0);
  }
}

// 8-key tiles of a row the warpgroup body holds at this shape (64, 208 or
// 256 keys), 0 where it does not run (head dim other than 64, rows not
// 16-byte aligned, or s_pad > 256).
__host__ __device__ inline int wgmma_tiles(int s, int dh, int vec) {
  const int s_pad = round_up(s, 16);
  if (dh != 64 || !vec || s_pad > 256) return 0;
  return s_pad <= 64 ? 8 : s_pad <= 208 ? 26 : 32;
}

// Bytes of dynamic shared memory of the warpgroup body: 1,024 of alignment
// slack, K and V (8·nt rows of 128 bytes each) and one 64-row q tile.
__host__ __device__ inline size_t wgmma_smem_bytes(int nt) { return 1024 + (2 * 8 * nt + 64) * 128; }

// One block is one warpgroup per (head, batch row); it walks the head's
// 64-row query tiles. s = q·kᵀ is one wgmma chain (m64 × n(8·NT) × k64)
// with both operands in shared memory; the row's logits stay in its
// accumulator registers, laid out as mma.sync's (rows gq and gq + 8 of the
// warp's 16, columns 2tq and 2tq + 1 of each 8-key tile); bf16(p·(1/l)) is
// the register A operand of o = p·v against V's transposed descriptor.
template <int NT>  // 8-key tiles of a row: 8 (s_pad <= 64), 26 (<= 208) or 32 (<= 256)
__global__ void __launch_bounds__(kThreads, NT <= 26 ? 3 : 2)
short_attention_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, bf16* __restrict__ out, int s,
                                 int heads, float scale, int causal) {
  constexpr int N = 8 * NT;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  unsigned char* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + N * 128;
  unsigned char* qs = vs + N * 128;
  const int width = heads * 64;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, gq = lane >> 2, tq = lane & 3;
  const int n_qt = (s + 63) / 64;
  const float sl = scale * kLog2e;
  const size_t slab = (size_t)b * s * width + (size_t)h * 64;

  // Two copy groups: K with the first q tile, then V, which the first
  // tile's product and softmax overlap.
  load_swizzled(ks, k + slab, 0, N, s, width, tid);
  load_swizzled(qs, q + slab, 0, 64, s, width, tid);
  cp_async_commit();
  load_swizzled(vs, v + slab, 0, N, s, width, tid);
  cp_async_commit();

  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt == 0) cp_async_wait<1>();
    else cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // this tile's q (and, first, K) in place for the product

    float sc[N / 2];  // overwritten by the first product (scale_d = 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(qs + kk * 32, 16), db = sw128_desc(ks + kk * 32, 16);
      if constexpr (NT == 8) wgmma_ss_n64(sc, da, db, kk > 0);
      else if constexpr (NT == 26) wgmma_ss_n208(sc, da, db, kk > 0);
      else wgmma_ss_n256(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    __syncthreads();  // every warp's product has read q's buffer
    const bool prefetch = qt + 1 < n_qt;
    if (prefetch) {  // the next tile's q, in flight during this one
      load_swizzled(qs, q + slab, (qt + 1) * 64, 64, s, width, tid);
      cp_async_commit();
    }

    // Softmax in registers (rows a: registers 4n, 4n+1; b: 4n+2, 4n+3).
    const int row_a = qt * 64 + 16 * w + gq, row_b = row_a + 8;
    const int lim_a = causal ? min(row_a + 1, s) : s;
    const int lim_b = causal ? min(row_b + 1, s) : s;
    const int lim = min(lim_a, lim_b);
    float mx_a = -INFINITY, mx_b = -INFINITY, rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n + 8 > lim) {
        const int c = 8 * n + 2 * tq;
        sc[4 * n] = c < lim_a ? sc[4 * n] : -INFINITY;
        sc[4 * n + 1] = c + 1 < lim_a ? sc[4 * n + 1] : -INFINITY;
        sc[4 * n + 2] = c < lim_b ? sc[4 * n + 2] : -INFINITY;
        sc[4 * n + 3] = c + 1 < lim_b ? sc[4 * n + 3] : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    const float nm_a = -quad_max(mx_a) * sl, nm_b = -quad_max(mx_b) * sl;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[4 * n] = ex2(fmaf(sc[4 * n], sl, nm_a));
      sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl, nm_a));
      sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl, nm_b));
      sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl, nm_b));
      rs_a += sc[4 * n] + sc[4 * n + 1];
      rs_b += sc[4 * n + 2] + sc[4 * n + 3];
    }
    const float r_a = 1.f / quad_sum(rs_a), r_b = 1.f / quad_sum(rs_b);
    unsigned pa[NT / 2][4];  // bf16(p·(1/l)); 16-key step kk = 8-key tiles 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      pa[kk][0] = pack(sc[8 * kk] * r_a, sc[8 * kk + 1] * r_a);
      pa[kk][1] = pack(sc[8 * kk + 2] * r_b, sc[8 * kk + 3] * r_b);
      pa[kk][2] = pack(sc[8 * kk + 4] * r_a, sc[8 * kk + 5] * r_a);
      pa[kk][3] = pack(sc[8 * kk + 6] * r_b, sc[8 * kk + 7] * r_b);
    }
    if (qt == 0) {  // V in place
      if (prefetch) cp_async_wait<1>();
      else cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }

    float o[32];  // overwritten by the first product (scale_d = 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_rs_n64(o, pa[kk], sw128_desc(vs + kk * 2048, 64 * 128), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tq;
      store_pair(out + slab, row_a, col, o[4 * n], o[4 * n + 1], s, width, 64, true);
      store_pair(out + slab, row_b, col, o[4 * n + 2], o[4 * n + 3], s, width, 64, true);
    }
  }
}

struct Call {
  const void *q, *k, *v;
  void* out;
  int b, s, heads, dh;
  float scale;
  int causal, vec;
  cudaStream_t stream;
};

// Launch (occupancy = false: returns the cudaError_t) or report resident
// blocks per SM (occupancy = true: 0 on an error) for one body.
template <int DT, int NT>
int run(const Call& c, bool occupancy) {
  const Geometry g = geometry(c.s, c.dh);
  auto kernel = short_attention_fwd_kernel<DT, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (occupancy) {
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, g.smem);
    return err == cudaSuccess ? blocks : 0;
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(c.heads, c.b), kThreads, g.smem, c.stream>>>(
      static_cast<const bf16*>(c.q), static_cast<const bf16*>(c.k), static_cast<const bf16*>(c.v),
      static_cast<bf16*>(c.out), c.s, c.heads, c.dh, c.scale, c.causal, c.vec);
  return (int)cudaGetLastError();
}

// The warpgroup body's launch (occupancy = false) or blocks per SM (true).
template <int NT>
int run_wgmma(const Call& c, bool occupancy) {
  const size_t smem = wgmma_smem_bytes(NT);
  auto kernel = short_attention_fwd_wgmma_kernel<NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (occupancy) {
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    return err == cudaSuccess ? blocks : 0;
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(c.heads, c.b), kThreads, smem, c.stream>>>(
      static_cast<const bf16*>(c.q), static_cast<const bf16*>(c.k), static_cast<const bf16*>(c.v),
      static_cast<bf16*>(c.out), c.s, c.heads, c.scale, c.causal);
  return (int)cudaGetLastError();
}

// The body a call takes: 2 = the warpgroup body (head dim 64, 16-byte rows,
// s_pad <= 256), 1 = the mma.sync one-pass body, 0 = the two-pass body.
int body(int s, int dh, int vec) {
  if (wgmma_tiles(s, dh, vec)) return 2;
  return resident_tiles(s) ? 1 : 0;
}

template <int DT>
int run_body(const Call& c, bool occupancy) {
  switch (wgmma_tiles(c.s, c.dh, c.vec)) {
    case 8: return run_wgmma<8>(c, occupancy);
    case 26: return run_wgmma<26>(c, occupancy);
    case 32: return run_wgmma<32>(c, occupancy);
  }
  switch (resident_tiles(c.s)) {
    case 8: return run<DT, 8>(c, occupancy);
    case 26: return run<DT, 26>(c, occupancy);
    default: return run<DT, 0>(c, occupancy);
  }
}

int dispatch(const Call& c, bool occupancy) {
  switch ((c.dh + 15) / 16) {
    case 1: return run_body<1>(c, occupancy);
    case 2: return run_body<2>(c, occupancy);
    case 3: return run_body<3>(c, occupancy);
    case 4: return run_body<4>(c, occupancy);
    case 5: return run_body<5>(c, occupancy);
    case 6: return run_body<6>(c, occupancy);
    case 7: return run_body<7>(c, occupancy);
    default: return run_body<8>(c, occupancy);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the body a call with 16-byte rows
// takes, bytes (mirrored by ops/short_attention.py::short_attention_smem_bytes).
long long short_attention_smem_bytes(int s, int dh) {
  const int nt = wgmma_tiles(s, dh, 1);
  return (long long)(nt ? wgmma_smem_bytes(nt) : geometry(s, dh).smem);
}

// The body a call takes (2 warpgroup, 1 mma.sync one-pass, 0 two-pass), for
// the records.
int short_attention_body(int s, int dh, int vec) { return body(s, dh, vec); }

// Keys of a row the body a call takes holds in registers (64, 208 or 256),
// or 0 for the two-pass body; for the records.
int short_attention_row_keys(int s, int dh, int vec) {
  const int nt = wgmma_tiles(s, dh, vec);
  return 8 * (nt ? nt : resident_tiles(s));
}

// q, k, v, out: (b, s, heads·dh) bf16, contiguous. Returns the cudaError_t of
// the launch (0 on success); the launch does not synchronise.
int short_attention_fwd(const void* q, const void* k, const void* v, void* out, int b, int s,
                        int heads, int dh, float scale, int causal, int vec, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || heads < 1 || dh < 1 || dh > 16 * kMaxHeadTiles)
    return (int)cudaErrorInvalidValue;
  return dispatch({q, k, v, out, b, s, heads, dh, scale, causal, vec,
                   static_cast<cudaStream_t>(stream)},
                  false);
}

// Resident blocks per SM of the body a call with 16-byte rows takes at this
// shape (0 with an error), for the records.
int short_attention_occupancy(int s, int dh) {
  if (s < 1 || dh < 1 || dh > 16 * kMaxHeadTiles) return 0;
  return dispatch({nullptr, nullptr, nullptr, nullptr, 1, s, 1, dh, 1.f, 0, 1, nullptr}, true);
}

const char* short_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
