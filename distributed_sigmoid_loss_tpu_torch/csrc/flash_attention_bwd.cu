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
// p is normalised by the forward's final l, so no rounding point depends on
// the tile: only the order of the f32 sums does. Each output element is
// written by one thread and there are no atomics, so the gradients are
// bitwise repeatable.
//
// Bound on this card: at SigLIP-B/16 at 512 px (b=32, s=1024, h=12, dh=64)
// q, k, v, do read once and dq, dk, dv written once are 7·32·1024·768·2 B =
// 352 MB, 105 µs at 3.35 TB/s, while the five products are
// 5·2·32·12·1024²·64 = 258 GFLOP, 261 µs at 989 TFLOP/s: the tensor cores
// bound the pair. (The two-pass split computes q·kᵀ and do·vᵀ in both
// kernels: seven products, the price of no atomics.)
//
// Two bodies for each kernel, picked by shape:
// - The warpgroup bodies (head dims 64 and 128, the towers' B/16, L/14 and
//   context shapes): one block of three warpgroups per (128-row tile, head,
//   batch row), one block per SM. A producer warpgroup loads the block's
//   resident tiles once and keeps a four-stage mbarrier ring of streamed
//   64-row tiles filled, by TMA through 3-D tensor maps over the native
//   (b, s, h·dh) layout (rows past s zero-filled) into 128-byte-swizzled
//   panels, or element by element when rows are not 16-byte aligned (the
//   same consumers run on the same layout, so both round identically).
//   setmaxnreg moves registers from the producer to two consumer
//   warpgroups of 64 resident rows each.
//   dkv: a block owns 128 keys; K and V stay resident, and query tiles (Q
//   and dO by one producer thread, their rows' −m·log2e, 1/l and di by two
//   producer warps that load the next tile's while they wait for its stage)
//   stream. Per tile each consumer issues sᵀ = k·qᵀ and dpᵀ = v·doᵀ as wgmma
//   with both operands in shared memory (keys as M), so pᵀ and dsᵀ lie in
//   registers in the A-operand layout, and dv += bf16(pᵀ)·do, dk +=
//   bf16(dsᵀ)·q follow as wgmma with A in registers and dO's or Q's tile as
//   the transposed (MN-major) B. At dh=64 the two consumers take turns
//   (named barriers): a turn issues the previous tile's dv and dk and this
//   tile's sᵀ and dpᵀ, so that one consumer's softmax runs while the
//   other's products do. At dh=128, where dk and dv hold 128 f32 registers
//   a thread, each consumer runs the four products one after another (dpᵀ
//   after dv) to stay within its registers. Causal blocks skip the query
//   tiles before their keys; key block 0, the heaviest, is launched first.
//   dq: a block owns 128 query rows; Q and dO stay resident and the rows'
//   statistics stay in registers; K and V tiles stream. Per key tile: s =
//   q·kᵀ and dp = do·vᵀ (the softmax starts while dp runs), then dq +=
//   bf16(ds)·k with K's tile as MN-major B. Causal blocks stop at their
//   diagonal and run heaviest first.
//   Per element p is one FMA and one ex2.approx, 2^(x·scale·log2e −
//   m·log2e) times 1/l, with 1/l taken once per row.
//   Every sequence of products is straight-line code with nothing in
//   flight across a loop's back edge: ptxas serialises the wgmmas of a
//   loop that carries one, or that issues them in divergent branches.
// - The mma.sync bodies (every other head dim, a multiple of 8 up to 128,
//   e.g. So400m's 72): four warps of 16 rows.
//   dkv: a warp owns 16 keys. K and V of the block's tile stay in shared
//   memory; query tiles (Q, dO and their m, 1/l, di) stream through a
//   two-stage cp.async ring. The warp computes sᵀ = k·qᵀ and dpᵀ = v·doᵀ
//   directly (16 keys × 64 queries in registers), so bf16(pᵀ) and bf16(dsᵀ)
//   are A operands as they stand, and do and q enter dv and dk through
//   ldmatrix.trans. Causal blocks skip the query tiles above their diagonal.
//   dq: a warp owns 16 query rows, whose m, 1/l and di stay in registers; key
//   and value tiles stream through the ring; bf16(ds) feeds ds·k with K
//   through ldmatrix.trans. Causal blocks stop at their diagonal tile.
//   The ragged tail is zero-filled in shared memory. Rounded intrinsics keep
//   the compiler from contracting the chain into FMAs, so these bodies round
//   where their plain versions do.
// Every body masks the ragged tail by index (p = 0 there) and makes no
// padded copies.

#include "short_attention_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

using namespace short_attention;

namespace {

using bf16 = __nv_bfloat16;

// ---- the di pass -----------------------------------------------------------

constexpr int kDiWarps = 8;

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

// ---- the warpgroup bodies --------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, one per consumer, over both warpgroups' 256 threads), so
// that one's softmax runs while the other's products keep the tensor cores.
__device__ inline void wait_turn(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ inline void pass_turn(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

template <int DH>
struct WgBwd {
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kConsumers = 2;                     // warpgroups of 64 resident rows
  // Registers a thread after setmaxnreg, within the launch allocation of
  // 168 a thread (one block per SM): the producer keeps enough not to spill
  // at dh=64; at 128 the consumers need all but 40.
  static constexpr int kProducerRegs = DH == 64 ? 56 : 40;
  static constexpr int kConsumerRegs = DH == 64 ? 224 : 232;
  static constexpr int kRows = 64 * kConsumers;            // resident rows of a block
  static constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
  static constexpr int kResBytes = kRows * DH * 2;         // one resident tile: K, V or Q, dO
  static constexpr int kTileBytes = 64 * DH * 2;           // one streamed 64-row tile
  static constexpr int kStageBytes = 2 * kTileBytes;       // a stage: (Q, dO) or (K, V)
  static constexpr int kStages = 4;
  static constexpr int kStatFloats = 3 * 64;  // dkv, per stage: −m·log2e, 1/l, di of 64 rows
  static constexpr size_t kSmemDq =
      1024 + 2 * kResBytes + (size_t)kStages * kStageBytes + (2 * kStages + 1) * sizeof(uint64_t);
  static constexpr size_t kSmemDkv = kSmemDq + (size_t)kStages * kStatFloats * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(WgBwd<DH>::kThreads, 1)
flash_attention_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const __grid_constant__ CUtensorMap do_map,
                                     const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                     const float* __restrict__ stats,
                                     const float* __restrict__ di, bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, int s, int heads, float scale,
                                     int causal, int vec) {
  using G = WgBwd<DH>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  unsigned char* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + G::kResBytes;
  unsigned char* ring = vs + G::kResBytes;  // stage e: Q at ring + e·kStageBytes, dO after
  float* rstat = reinterpret_cast<float*>(ring + G::kStages * G::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(rstat + G::kStages * G::kStatFloats);
  uint64_t* empty = full + G::kStages;
  uint64_t* resbar = empty + G::kStages;

  const int width = heads * DH;
  const int n_q = (s + 63) / 64;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;  // causal: kb = 0 is heaviest
  const int k0 = kb * G::kRows;
  const int i0 = causal ? k0 / 64 : 0;  // causal: earlier query tiles see none of the keys
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const size_t slab = (size_t)b * s * width + (size_t)h * DH;

  if (threadIdx.x == 0) {
    for (int e = 0; e < G::kStages; ++e) {
      // TMA's thread and the 64 row-statistics threads, or every producer
      // thread when they fill the tiles element by element.
      mbar_init(&full[e], vec ? 65 : 128);
      mbar_init(&empty[e], 4 * G::kConsumers);  // one arrival per consumer warp
    }
    mbar_init(resbar, vec ? 1 : 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: K and V once, then (Q, dO) of each query tile from thread 0
    // (TMA) and the tile's row statistics from threads 32 .. 95, which load
    // the next tile's while they wait for its stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs));
    const int r = t - 32;
    const bool stats_thread = r >= 0 && r < 64;
    if (vec && t != 0 && !stats_thread) return;
    const float* st_m = stats + ((size_t)b * heads + h) * 2 * s;
    const float* st_l = st_m + s;
    const float* di_bh = di + ((size_t)b * heads + h) * s;
    float m_next = 0.f, l_next = 1.f, di_next = 0.f;
    auto fetch = [&](int i) {  // raw values of row 64i + r (none past s)
      const int row = i * 64 + r;
      if (row < s) {
        m_next = st_m[row];
        l_next = st_l[row];
        di_next = di_bh[row];
      }
    };
    if (stats_thread) fetch(i0);
    if (!vec) {
      fill_swizzled<DH>(ks, k + slab, k0, G::kRows, s, width, t);
      fill_swizzled<DH>(vs, v + slab, k0, G::kRows, s, width, t);
      mbar_arrive(resbar);
    } else if (t == 0) {
      mbar_expect_tx(resbar, 2 * G::kResBytes);
      for (int p = 0; p < G::kPanels; ++p)
        for (int c = 0; c < G::kConsumers; ++c) {
          const int off = p * G::kRows * 128 + c * 64 * 128, col = h * DH + p * kPanel;
          tma_load(ks + off, &k_map, resbar, col, k0 + c * 64, b);
          tma_load(vs + off, &v_map, resbar, col, k0 + c * 64, b);
        }
    }
    for (int i = i0; i < n_q; ++i) {
      const int u = i - i0, e = u % G::kStages, use = u / G::kStages;
      if (use > 0) mbar_wait(&empty[e], (use - 1) & 1);
      unsigned char* qt = ring + e * G::kStageBytes;
      if (vec && t == 0) {
        mbar_expect_tx(&full[e], G::kStageBytes);  // this thread's arrival
        for (int p = 0; p < G::kPanels; ++p) {
          const int col = h * DH + p * kPanel;
          tma_load(qt + p * 64 * 128, &q_map, &full[e], col, i * 64, b);
          tma_load(qt + G::kTileBytes + p * 64 * 128, &do_map, &full[e], col, i * 64, b);
        }
        continue;
      }
      if (stats_thread) {
        float* rs = rstat + e * G::kStatFloats;
        const bool live = i * 64 + r < s;
        rs[r] = live ? -m_next * kLog2e : 0.f;
        rs[64 + r] = live ? __fdiv_rn(1.f, l_next) : 0.f;
        rs[128 + r] = live ? di_next : 0.f;
        if (i + 1 < n_q) fetch(i + 1);
      }
      if (!vec) {
        fill_swizzled<DH>(qt, q + slab, i * 64, 64, s, width, t);
        fill_swizzled<DH>(qt + G::kTileBytes, dout + slab, i * 64, 64, s, width, t);
      }
      mbar_arrive(&full[e]);
    }
  } else {
    // Consumer c owns keys k0 + 64c .. + 63; warp w of it keys 16w .. 16w +
    // 15 of those (rows a and b of the accumulator layout), against the 64
    // query columns 8n + 2tq, 8n + 2tq + 1 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs));
    const int c = wg - 1, w = t / 32, lane = t % 32, gq = lane >> 2, tq = lane & 3;
    const int kc0 = k0 + 64 * c;
    const int key_a = kc0 + 16 * w + gq, key_b = key_a + 8;
    const float sl = scale * kLog2e;
    const unsigned char* kc = ks + c * 64 * 128;  // this consumer's rows of each panel
    const unsigned char* vc = vs + c * 64 * 128;
    auto live = [&](int key, int row) { return key < s && row < s && (!causal || key <= row); };
    auto stage = [&](int i) { return (i - i0) % G::kStages; };
    auto wait_full = [&](int i) {
      mbar_wait(&full[stage(i)], (unsigned)((i - i0) / G::kStages) & 1u);
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage(i)]);
    };

    float dka[DH / 2], dva[DH / 2];
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) dka[x] = dva[x] = 0.f;
    float sc[32], dp[32];  // overwritten by their products (scale_d = 0)
    unsigned pa[4][4], da[4][4];

    // sᵀ = k·qᵀ (into sc) and dpᵀ = v·doᵀ (into dp) of query tile i, each a
    // committed group; the key rows are M, both operands in shared memory.
    auto issue_s = [&](int i) {
      const unsigned char* qt = ring + stage(i) * G::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64(sc, sw128_desc(kc + p * G::kRows * 128 + off, 16),
                     sw128_desc(qt + p * 64 * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_dp = [&](int i) {
      const unsigned char* dot = ring + stage(i) * G::kStageBytes + G::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64(dp, sw128_desc(vc + p * G::kRows * 128 + off, 16),
                     sw128_desc(dot + p * 64 * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    // pᵀ = 2^(sᵀ·scale·log2e − m·log2e) · (1/l) in sc, 0 on pairs that are
    // not live, and bf16(pᵀ) as the A operand in pa (16 queries per step).
    auto softmax = [&](int i) {
      const float* rs = rstat + stage(i) * G::kStatFloats;
      const int q0 = i * 64;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 nm = *reinterpret_cast<const float2*>(rs + 8 * n + 2 * tq);
        const float2 il = *reinterpret_cast<const float2*>(rs + 64 + 8 * n + 2 * tq);
        sc[4 * n] = ex2(fmaf(sc[4 * n], sl, nm.x)) * il.x;
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl, nm.y)) * il.y;
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl, nm.x)) * il.x;
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl, nm.y)) * il.y;
      }
      if (q0 + 64 > s || kc0 + 64 > s || (causal && q0 <= kc0)) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = q0 + 8 * n + 2 * tq;
          sc[4 * n] = live(key_a, col) ? sc[4 * n] : 0.f;
          sc[4 * n + 1] = live(key_a, col + 1) ? sc[4 * n + 1] : 0.f;
          sc[4 * n + 2] = live(key_b, col) ? sc[4 * n + 2] : 0.f;
          sc[4 * n + 3] = live(key_b, col + 1) ? sc[4 * n + 3] : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // dsᵀ = ((dpᵀ − di) ⊙ pᵀ) · scale, bf16 as the A operand in da.
    auto grad = [&](int i) {
      const float* rs = rstat + stage(i) * G::kStatFloats + 128;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 dd = *reinterpret_cast<const float2*>(rs + 8 * n + 2 * tq);
        dp[4 * n] = (dp[4 * n] - dd.x) * sc[4 * n] * scale;
        dp[4 * n + 1] = (dp[4 * n + 1] - dd.y) * sc[4 * n + 1] * scale;
        dp[4 * n + 2] = (dp[4 * n + 2] - dd.x) * sc[4 * n + 2] * scale;
        dp[4 * n + 3] = (dp[4 * n + 3] - dd.y) * sc[4 * n + 3] * scale;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        da[kk][0] = pack(dp[8 * kk], dp[8 * kk + 1]);
        da[kk][1] = pack(dp[8 * kk + 2], dp[8 * kk + 3]);
        da[kk][2] = pack(dp[8 * kk + 4], dp[8 * kk + 5]);
        da[kk][3] = pack(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
    };
    // dv += bf16(pᵀ)·do and dk += bf16(dsᵀ)·q, dO's and Q's tiles as
    // MN-major B, each a committed group.
    auto issue_dv = [&](int i) {
      const unsigned char* dot = ring + stage(i) * G::kStageBytes + G::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_dh<DH>(dva, pa[kk], sw128_desc(dot + kk * 2048, 64 * 128));
      wgmma_commit();
    };
    auto issue_dk = [&](int i) {
      const unsigned char* qt = ring + stage(i) * G::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_dh<DH>(dka, da[kk], sw128_desc(qt + kk * 2048, 64 * 128));
      wgmma_commit();
    };

    mbar_wait(resbar, 0);
    if constexpr (DH == 64) {
      // Turns: one per query tile of the block, then one more; both
      // consumers take n_q − i0 + 1, consumer 0 first. A turn issues the
      // previous tile's dv and dk and this tile's sᵀ and dpᵀ; each sequence
      // of products is straight-line code, so that ptxas keeps them async.
      const int first = causal && c > 0 ? i0 + 1 : i0;  // this consumer's first tile
      if (c == 1) pass_turn(1);
      if (first > i0) {  // consumer 1's causal first turn: its tile's queries precede its keys
        wait_full(i0);
        wait_turn(c);
        pass_turn(c);
        release(i0);
      }
      if (first < n_q) {
        wait_full(first);
        wait_turn(c);
        issue_s(first);
        issue_dp(first);
        pass_turn(c);
        wgmma_wait<1>();  // sᵀ
        fence_operands(sc);
        softmax(first);
        wgmma_wait<0>();  // dpᵀ
        fence_operands(dp);
        grad(first);
        for (int i = first + 1; i < n_q; ++i) {
          wait_full(i);
          wait_turn(c);
          issue_dv(i - 1);
          issue_dk(i - 1);
          issue_s(i);
          issue_dp(i);
          pass_turn(c);
          wgmma_wait<1>();  // the previous tile's dv and dk, and sᵀ
          fence_operands(pa);
          fence_operands(da);
          fence_operands(sc);
          release(i - 1);
          softmax(i);
          wgmma_wait<0>();  // dpᵀ
          fence_operands(dp);
          grad(i);
        }
        wait_turn(c);
        issue_dv(n_q - 1);
        issue_dk(n_q - 1);
        if (c == 0) pass_turn(c);  // consumer 1's last turn passes nothing
        wgmma_wait<0>();
        fence_operands(pa);
        fence_operands(da);
        release(n_q - 1);
      } else {  // consumer 1 without a tile of its own
        wait_turn(c);
      }
    } else {
      // At dh=128 dk and dv take 128 registers a thread: one product at a
      // time, dpᵀ after dv, so that sᵀ, dpᵀ and pa are never all live.
      int i = i0;
      if (causal && c > 0 && i < n_q) {  // the first tile's queries all precede these keys
        wait_full(i);
        release(i);
        ++i;
      }
      for (; i < n_q; ++i) {
        wait_full(i);
        issue_s(i);
        wgmma_wait<0>();
        fence_operands(sc);
        softmax(i);
        issue_dv(i);
        wgmma_wait<0>();
        fence_operands(pa);
        issue_dp(i);
        wgmma_wait<0>();
        fence_operands(dp);
        grad(i);
        issue_dk(i);
        wgmma_wait<0>();
        fence_operands(da);
        release(i);
      }
    }
    fence_operands(dka);
    fence_operands(dva);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = 8 * n + 2 * tq;
      store_pair(dv + slab, key_a, col, dva[4 * n], dva[4 * n + 1], s, width, DH, vec);
      store_pair(dv + slab, key_b, col, dva[4 * n + 2], dva[4 * n + 3], s, width, DH, vec);
      store_pair(dk + slab, key_a, col, dka[4 * n], dka[4 * n + 1], s, width, DH, vec);
      store_pair(dk + slab, key_b, col, dka[4 * n + 2], dka[4 * n + 3], s, width, DH, vec);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(WgBwd<DH>::kThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap k_map,
                                    const __grid_constant__ CUtensorMap v_map,
                                    const __grid_constant__ CUtensorMap do_map,
                                    const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ di, bf16* __restrict__ dq, int s,
                                    int heads, float scale, int causal, int vec) {
  using G = WgBwd<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + G::kResBytes;
  unsigned char* ring = dos + G::kResBytes;  // stage e: K at ring + e·kStageBytes, V after
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::kStages * G::kStageBytes);
  uint64_t* empty = full + G::kStages;
  uint64_t* resbar = empty + G::kStages;

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
    mbar_init(resbar, vec ? 1 : 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: Q and dO once, then (K, V) of each key tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs));
    if (vec) {
      if (t != 0) return;
      mbar_expect_tx(resbar, 2 * G::kResBytes);
      for (int p = 0; p < G::kPanels; ++p)
        for (int c = 0; c < G::kConsumers; ++c) {
          const int off = p * G::kRows * 128 + c * 64 * 128, col = h * DH + p * kPanel;
          tma_load(qs + off, &q_map, resbar, col, q0 + c * 64, b);
          tma_load(dos + off, &do_map, resbar, col, q0 + c * 64, b);
        }
    } else {
      fill_swizzled<DH>(qs, q + slab, q0, G::kRows, s, width, t);
      fill_swizzled<DH>(dos, dout + slab, q0, G::kRows, s, width, t);
      mbar_arrive(resbar);
    }
    for (int j = 0; j < n_visit; ++j) {
      const int e = j % G::kStages, use = j / G::kStages;
      if (use > 0) mbar_wait(&empty[e], (use - 1) & 1);
      unsigned char* kt = ring + e * G::kStageBytes;
      if (vec) {
        mbar_expect_tx(&full[e], G::kStageBytes);
        for (int p = 0; p < G::kPanels; ++p) {
          const int col = h * DH + p * kPanel;
          tma_load(kt + p * 64 * 128, &k_map, &full[e], col, j * 64, b);
          tma_load(kt + G::kTileBytes + p * 64 * 128, &v_map, &full[e], col, j * 64, b);
        }
      } else {
        fill_swizzled<DH>(kt, k + slab, j * 64, 64, s, width, t);
        fill_swizzled<DH>(kt + G::kTileBytes, v + slab, j * 64, 64, s, width, t);
        mbar_arrive(&full[e]);
      }
    }
  } else {
    // Consumer c owns query rows q0 + 64c .. + 63; warp w of it rows 16w ..
    // 16w + 15 of those (rows a and b of the accumulator layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs));
    const int c = wg - 1, w = t / 32, lane = t % 32, gq = lane >> 2, tq = lane & 3;
    const int qc0 = q0 + 64 * c;
    const int row_a = qc0 + 16 * w + gq, row_b = row_a + 8;
    const int my_visit = causal ? min(G::kConsumers * qb + c + 1, n_tiles) : n_tiles;
    const float sl = scale * kLog2e;
    const float* st_m = stats + ((size_t)b * heads + h) * 2 * s;
    const float* st_l = st_m + s;
    const float* di_bh = di + ((size_t)b * heads + h) * s;
    const float nm_a = row_a < s ? -st_m[row_a] * kLog2e : 0.f;
    const float nm_b = row_b < s ? -st_m[row_b] * kLog2e : 0.f;
    const float il_a = row_a < s ? __fdiv_rn(1.f, st_l[row_a]) : 0.f;
    const float il_b = row_b < s ? __fdiv_rn(1.f, st_l[row_b]) : 0.f;
    const float di_a = row_a < s ? di_bh[row_a] : 0.f, di_b = row_b < s ? di_bh[row_b] : 0.f;
    const unsigned char* qc = qs + c * 64 * 128;  // this consumer's rows of each panel
    const unsigned char* doc = dos + c * 64 * 128;
    auto live = [&](int row, int key) { return key < s && row < s && (!causal || key <= row); };
    auto wait_full = [&](int j) {
      mbar_wait(&full[j % G::kStages], (unsigned)(j / G::kStages) & 1u);
    };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % G::kStages]);
    };

    float dqa[DH / 2];
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) dqa[x] = 0.f;
    float sc[32], dp[32];  // overwritten by their products (scale_d = 0)
    unsigned da[4][4];

    // s = q·kᵀ (into sc) and dp = do·vᵀ (into dp) of key tile j, two
    // committed groups; both operands in shared memory.
    auto issue_s_dp = [&](int j) {
      const unsigned char* kt = ring + (j % G::kStages) * G::kStageBytes;
      const unsigned char* vt = kt + G::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64(sc, sw128_desc(qc + p * G::kRows * 128 + off, 16),
                     sw128_desc(kt + p * 64 * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64(dp, sw128_desc(doc + p * G::kRows * 128 + off, 16),
                     sw128_desc(vt + p * 64 * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
    };

    // dq += bf16(ds)·k of key tile j, K's tile as MN-major B, one committed group.
    auto issue_dq = [&](int j) {
      const unsigned char* kt = ring + (j % G::kStages) * G::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_dh<DH>(dqa, da[kk], sw128_desc(kt + kk * 2048, 64 * 128));
      wgmma_commit();
    };

    // p = 2^(s·scale·log2e − m·log2e) · (1/l), 0 on pairs that are not
    // live; then ds = ((dp − di) ⊙ p) · scale, bf16 as the A operand in da.
    auto softmax_grad = [&](int j) {
      const int k0 = j * 64;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sc[4 * n] = ex2(fmaf(sc[4 * n], sl, nm_a)) * il_a;
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl, nm_a)) * il_a;
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl, nm_b)) * il_b;
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl, nm_b)) * il_b;
      }
      if (k0 + 64 > s || qc0 + 64 > s || (causal && k0 >= qc0)) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = k0 + 8 * n + 2 * tq;
          sc[4 * n] = live(row_a, col) ? sc[4 * n] : 0.f;
          sc[4 * n + 1] = live(row_a, col + 1) ? sc[4 * n + 1] : 0.f;
          sc[4 * n + 2] = live(row_b, col) ? sc[4 * n + 2] : 0.f;
          sc[4 * n + 3] = live(row_b, col + 1) ? sc[4 * n + 3] : 0.f;
        }
      }
      wgmma_wait<0>();  // dp
      fence_operands(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        dp[4 * n] = (dp[4 * n] - di_a) * sc[4 * n] * scale;
        dp[4 * n + 1] = (dp[4 * n + 1] - di_a) * sc[4 * n + 1] * scale;
        dp[4 * n + 2] = (dp[4 * n + 2] - di_b) * sc[4 * n + 2] * scale;
        dp[4 * n + 3] = (dp[4 * n + 3] - di_b) * sc[4 * n + 3] * scale;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        da[kk][0] = pack(dp[8 * kk], dp[8 * kk + 1]);
        da[kk][1] = pack(dp[8 * kk + 2], dp[8 * kk + 3]);
        da[kk][2] = pack(dp[8 * kk + 4], dp[8 * kk + 5]);
        da[kk][3] = pack(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
    };

    mbar_wait(resbar, 0);
    for (int j = 0; j < my_visit; ++j) {
      wait_full(j);
      issue_s_dp(j);
      wgmma_wait<1>();  // s (dp may still run)
      fence_operands(sc);
      softmax_grad(j);
      issue_dq(j);
      wgmma_wait<0>();
      fence_operands(da);
      release(j);
    }
    fence_operands(dqa);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = 8 * n + 2 * tq;
      store_pair(dq + slab, row_a, col, dqa[4 * n], dqa[4 * n + 1], s, width, DH, vec);
      store_pair(dq + slab, row_b, col, dqa[4 * n + 2], dqa[4 * n + 3], s, width, DH, vec);
    }
  }
}

// Sets a warpgroup kernel's shared memory; refuses a build whose launch
// allocation cannot cover the registers setmaxnreg hands the consumers (the
// consumers would wait for them forever).
template <typename G, typename Kernel>
cudaError_t configure_wgmma(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * G::kThreads <
      128 * G::kProducerRegs + 128 * G::kConsumers * G::kConsumerRegs)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
cudaError_t configure_dkv_wgmma() {
  return configure_wgmma<WgBwd<DH>>(flash_attention_bwd_dkv_wgmma_kernel<DH>, WgBwd<DH>::kSmemDkv);
}

template <int DH>
cudaError_t configure_dq_wgmma() {
  return configure_wgmma<WgBwd<DH>>(flash_attention_bwd_dq_wgmma_kernel<DH>, WgBwd<DH>::kSmemDq);
}

// The tensor maps of q, k, v and do when rows are 16-byte aligned (vec).
template <int DH>
cudaError_t make_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                      const void* dout, int b, int s, int heads, int vec) {
  const void* ptrs[4] = {q, k, v, dout};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && vec && err == cudaSuccess; ++i)
    err = make_map(&maps[i], ptrs[i], b, s, heads * DH);
  return err;
}

template <int DH>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* stats, const void* di, void* dk, void* dv, int b, int s,
                             int heads, float scale, int causal, int vec, cudaStream_t stream) {
  using G = WgBwd<DH>;
  CUtensorMap maps[4] = {};
  cudaError_t err = configure_dkv_wgmma<DH>();
  if (err == cudaSuccess) err = make_maps<DH>(maps, q, k, v, dout, b, s, heads, vec);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + G::kRows - 1) / G::kRows, heads, b);
  flash_attention_bwd_dkv_wgmma_kernel<DH><<<grid, G::kThreads, G::kSmemDkv, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(di), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, heads, scale, causal, vec);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* stats, const void* di, void* dq, int b, int s, int heads,
                            float scale, int causal, int vec, cudaStream_t stream) {
  using G = WgBwd<DH>;
  CUtensorMap maps[4] = {};
  cudaError_t err = configure_dq_wgmma<DH>();
  if (err == cudaSuccess) err = make_maps<DH>(maps, q, k, v, dout, b, s, heads, vec);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + G::kRows - 1) / G::kRows, heads, b);
  flash_attention_bwd_dq_wgmma_kernel<DH><<<grid, G::kThreads, G::kSmemDq, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(di), static_cast<bf16*>(dq), s,
      heads, scale, causal, vec);
  return cudaGetLastError();
}

template <int DH>
int occupancy_wgmma(int which) {
  int blocks = 0;
  cudaError_t err = which == 0 ? configure_dkv_wgmma<DH>() : configure_dq_wgmma<DH>();
  if (err == cudaSuccess)
    err = which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, flash_attention_bwd_dkv_wgmma_kernel<DH>,
                           WgBwd<DH>::kThreads, WgBwd<DH>::kSmemDkv)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, flash_attention_bwd_dq_wgmma_kernel<DH>,
                           WgBwd<DH>::kThreads, WgBwd<DH>::kSmemDq);
  return err == cudaSuccess ? blocks : 0;
}

// ---- the mma.sync bodies ---------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;  // rows of every tile: 16 per warp, 8 mma n-tiles
constexpr int kMaxHeadDim = 128;

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

// The body a head dim takes: the warpgroup bodies at 64 and 128, the
// mma.sync bodies at every other head dim the kernels take.
bool warpgroup_body(int dh) { return dh == 64 || dh == 128; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the dkv (which = 0) or dq (1)
// kernel of the body this head dim takes, bytes (mirrored by
// ops/flash_attention.py::flash_attention_bwd_smem_bytes).
long long flash_attention_bwd_smem_bytes(int dh, int which) {
  if (dh == 64) return (long long)(which == 0 ? WgBwd<64>::kSmemDkv : WgBwd<64>::kSmemDq);
  if (dh == 128) return (long long)(which == 0 ? WgBwd<128>::kSmemDkv : WgBwd<128>::kSmemDq);
  return (long long)geometry(dh).smem;
}

// The body the dkv (which = 0) or dq (1) kernel takes, for the records: 1 =
// warpgroup body fed by TMA, 2 = warpgroup body with element-wise loads
// (rows not 16-byte aligned), 0 = mma.sync body; -1 for a head dim the
// kernels do not take.
int flash_attention_bwd_body(int dh, int vec, int which) {
  if (!takes(1, 1, 1, dh) || (which != 0 && which != 1)) return -1;
  return warpgroup_body(dh) ? (vec ? 1 : 2) : 0;
}

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
  if (dh == 64)
    return (int)launch_dkv_wgmma<64>(q, k, v, dout, stats, di, dk, dv, b, s, heads, scale, causal,
                                     vec, st);
  if (dh == 128)
    return (int)launch_dkv_wgmma<128>(q, k, v, dout, stats, di, dk, dv, b, s, heads, scale,
                                      causal, vec, st);
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
  if (dh == 64)
    return (int)launch_dq_wgmma<64>(q, k, v, dout, stats, di, dq, b, s, heads, scale, causal, vec,
                                    st);
  if (dh == 128)
    return (int)launch_dq_wgmma<128>(q, k, v, dout, stats, di, dq, b, s, heads, scale, causal,
                                     vec, st);
#define FA_DQ(DT) \
  case DT:        \
    return (int)launch_dq<DT>(q, k, v, dout, stats, di, dq, b, s, heads, dh, scale, causal, vec, st);
  switch (round_up(dh, 16) / 16) {
    FA_DQ(1) FA_DQ(2) FA_DQ(3) FA_DQ(4) FA_DQ(5) FA_DQ(6) FA_DQ(7) FA_DQ(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_DQ
}

// Resident blocks per SM of the dkv (which = 0) or dq (1) kernel of the body
// this head dim takes (0 with an error), for the records.
int flash_attention_bwd_occupancy(int dh, int which) {
  if (!takes(1, 1, 1, dh)) return 0;
  if (dh == 64) return occupancy_wgmma<64>(which);
  if (dh == 128) return occupancy_wgmma<128>(which);
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
