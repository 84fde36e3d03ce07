// f32 self-attention for Hopper (sm_90a): a forward and a two-pass backward
// (a di pass with dK/dV, then dQ), every product on the tensor cores in split
// f32 (3xTF32).
//
// Replaces, for f32 activations, the Pallas TPU kernels that JAX runs in f32
// on the same towers: K1 (distributed_sigmoid_loss_tpu/ops/
// pallas_short_attention.py:_short_attention_fwd, body _fwd_kernel), K2 and
// K3 (_short_attention_bwd with _bwd_kernel or _bwd_kernel_batched) and K7
// (the upstream flash kernel that ops/flash_attention.py:flash_self_attention
// calls). In f32 there is no rounding of p or ds to a narrower type, so K1
// and K7 compute one function, softmax(q·kᵀ·scale [causal]) · v, and K2, K3
// and K7's backward another:
//   p  = exp(x − m) / l     with x = q·kᵀ·scale, m the row max, l the row sum
//   dv = pᵀ·do,  dp = do·vᵀ,  di = rowsum(out ⊙ do) (= rowsum(p ⊙ dp)),
//   ds = p ⊙ (dp − di) · scale,  dq = ds·k,  dk = dsᵀ·q.
// So one forward plays the K1 and the K7 role (the caller counts it under the
// role it plays) and writes the row statistics (m, l) for K7's saved stats,
// and one backward plays the K2, K3 and K7-backward roles: in the K2 and K3
// roles the caller first runs the forward for (out, m, l), since those saved
// only (q, k, v). JAX's f32 kernels are held at rtol 1e-4; so are these.
//
// Split f32. Each f32 operand x is split into hi = tf32(x) and lo = tf32(x −
// hi), both rounded as cvt.rna.tf32.f32 rounds (nearest, ties away; done on
// the integer bits, bitwise the same and cheaper), and every TF32 product
// step adds lo·hi, hi·lo, then hi·hi into an f32 accumulator (the small
// terms first; the split, mma.sync's step and the cp.async copies are in
// split_f32.cuh, shared with sigmoid_loss.cu, and wgmma's in wgmma.cuh).
// What is dropped, lo·lo and the rounding of lo, is about 2^-22 of each
// term; on the card the backward's outputs stay within ~1.5e-5 of the
// largest magnitude of the f32 plain version at s = 1,024 (the tensor
// cores' own accumulation adds to it), inside the 1e-4 contract. Plain TF32
// (hi·hi alone) keeps about three digits, ~4e-4 to ~8e-4 here, and would
// not hold. (This is the fast-f32 scheme of PyTorch's memory-efficient
// attention, its f32 yardstick on this card.)
//
// Bounds on this card: operations. At ViT-B/16 vision in f32 (b=128, s=196,
// h=12, dh=64) one s²·dh product is 2·128·12·196²·64 = 7.55 GFLOP against
// 4·128·196·768·4 B = 308 MB (92 µs at 3.35 TB/s) for four tensors. In
// split f32, three TF32 products for each at the 495 TFLOP/s TF32 peak: the
// forward's two (x, p·v) take 0.0915 ms, as long as its bytes; the
// backward's four (dK/dV: x, dp, dv, dk) or three (dQ: x, dp, dq) 0.183 and
// 0.137 ms. On the CUDA cores (67 TFLOP/s) they would take 0.225, 0.451 and
// 0.338.
//
// Design of the forward. A block of G warpgroups owns 64 query rows a
// warpgroup, of one (batch row, head), and walks the keys in chunks
// of fwd_keys(P) (64; 32 past head dim 64, where the planes of 64 would not
// fit; P = ceil(dh / 32) panels of 32 head-dim columns), up to its last row
// when causal, with the online softmax in registers:
//   1. the block's query rows are split once into 128-byte-swizzled TF32
//      hi and lo planes (K-major, one panel a 128-byte row), which stay in
//      shared memory as wgmma's A operand for the whole walk; every thread
//      issues all its loads of them before its first split, so the block
//      waits for device memory once (loads one at a time, with the plane
//      splits' loops rolled, made the forward 1.24× slower at B/16 vision
//      on an H100);
//   2. each chunk's K and V rows land by cp.async (16-byte copies when dh %
//      4 == 0 and q, k, v are 16-byte aligned, else 4-byte, bitwise the
//      same) in one f32 stage, and the block splits them once for all its
//      warpgroups: K into hi and lo planes as stored (keys K-major), V
//      transposed (a row per head-dim column, the chunk's keys along it, in
//      the order (2t, 2t + 1) below); then the stage takes the next chunk's
//      copies, which fly while this chunk's products run;
//   3. x = q·kᵀ on wgmma m64nNk8 (N = the chunk's keys; both operands from
//      the planes), three products a k-step, in fresh registers;
//   4. the softmax in the same registers: x·scale masked to −inf (keys past
//      s, causal keys after the row), the rows' running max m by quad
//      shuffles, p = exp(x·scale − m) (__expf, on ex2.approx: a few ulps
//      near the row max, more only where p itself is small; IEEE expf, which
//      the backward uses, made the forward 1.05× slower at B/16 vision and
//      1.06× in K7's role on an H100, with the same largest errors), the
//      rescale alpha of what came before, l = l·alpha + Σ p;
//   5. oc = p·v on wgmma m64n(32·P)k8 with p straight from x's accumulator
//      as the register A operand: an m64nN accumulator holds columns (2t,
//      2t + 1) of rows (g, g + 8), the TF32 A fragment k = (t, t + 4), so
//      V's planes hold the keys in that order and p never touches shared
//      memory; p is split in registers. oc is summed in fresh registers (24
//      TF32 products at most) and added as o = o·alpha + oc in IEEE f32, so
//      the tensor cores' truncating sums stay short whatever s.
// A last chunk with at most 16 or 32 live keys runs at that width (B/16's s
// = 196: 3 chunks of 64 and one of 16), so 208 keys are formed for 196
// (64-key tiles formed 256). Rows past s and columns past dh are
// zero-filled and not written; the statistics are m (of the scaled
// logits; −inf for a row with no live key) and l, as the backward reads
// them. Each sequence of products is straight-line code waited for before
// the next barrier (ptxas serialises wgmma across a loop's back edge or in
// divergent branches). G = fwd_groups(s), picked before launch: two
// warpgroups share each chunk's split, but where one holds every row (s <=
// 64, B/16's text) the second would run its products on rows past s. On an
// H100 (compare_attention_f32.py against a copy of this source), one
// warpgroup a block took 1.44× as long as two at B/16 vision and 1.42× in
// K7's role, and two 1.07× as long as one at B/16 text (s = 64). Variants
// that split the next chunk's planes while this chunk's products ran (two
// sets: the split and the products share shared memory's bandwidth) or
// walked the blocks persistently, fetching the next one's rows during the
// last chunk (253–255 registers), were no faster. Shared memory: Q's
// planes (G warpgroups × 64 rows × P panels × hi, lo), K's and V's planes
// (2 × keys × P panels; 2 × 32·P rows × keys / 32 panels), the f32 stage
// (2 × keys × 32·P) and 1 KB to align the planes; and the blocks an SM
// holds by it (228 KB, 1 KB reserved a block; registers may hold fewer):
//    dh   forward bytes, s <= 64  blocks  s > 64  blocks
//    20                   66,560       3  82,944       2
//    64                  132,096       1  164,864      1
//    72                  123,904       1  173,056      1
//   128                  164,864       1  230,400      1
//
// Design of the two backward kernels: split f32 on mma.sync m16n8k8 TF32. A
// block of 128 threads (4 warps) owns
// 64 resident rows of one (batch row, head), 16 a warp: dK/dV its keys, with
// K and V resident; dQ its queries, with Q and dO resident. It walks the
// other side's tiles of 32 rows, which stream through a two-stage cp.async
// ring: tile j + 1's copies fly while tile j's products run. Rows are copied
// 16 bytes at a time when dh % 4 == 0 and the tensors are 16-byte aligned,
// else 4 bytes at a time, into the same layout, so both give bitwise the same
// result. Rows past s and columns past dh are zero-filled. Every tile is
// row-major at a stride of round16(dh) + 4 floats (≡ 4 mod 8), so each
// fragment read below is free of bank conflicts. Per streamed tile a warp
//   1. forms x and dp, its 16 rows against the tile's 32 (A = the resident
//      rows, B = the streamed rows, both split as they are read),
//   2. turns them into p and ds in the accumulators, p = expf(x·scale − m) ·
//      (1/l) with the forward's m and l, masked (−inf keys: causal, past s)
//      to 0, ds = p·(dp − di)·scale,
//   3. adds p·do and ds·q (dK/dV: into dv and dk) or ds·k (dQ: into dq) with
//      p and ds as the A operand straight from the accumulators. A 16 × 8
//      accumulator holds columns (2t, 2t + 1) of rows (g, g + 8), while the
//      TF32 A fragment holds k = (t, t + 4): reading the B operand's k rows in
//      the order (2t, 2t + 1) makes the accumulator the A fragment, with no
//      round trip through shared memory. p and ds are split in registers.
// Each 8-column step splits its operands once and runs its lo·hi products
// for every output tile, then the hi·lo, then the hi·hi, so independent
// products cover each other's latency. The splitting, not the tensor cores,
// is most of the instructions. The resident rows stay f32 in shared memory
// and are split as they are read (once per 8 columns, reused across the
// tile's four 8-row groups): split planes would double their footprint. 32
// streamed rows (not 64) keep the accumulators within the registers without
// a spill at dh = 128 and let three blocks share an SM at dh = 64 (64 rows:
// two, and slower at B/16). A tile with at most 8 live rows (s = 196's
// last) runs one 8-row group, and a warp whose rows are all past s, or
// causally before the whole tile, skips it. Shared memory: dK/dV 2·64 + 4·32
// rows of f32 + 6·32 statistics, dQ 2·64 + 4·32 rows; and the blocks an SM
// holds by it (228 KB, 1 KB reserved a block; registers may hold fewer):
//    dh   dK/dV bytes  blocks  dQ bytes  blocks
//    20        37,632       6    36,864       6
//    64        70,400       3    69,632       3
//    72        86,784       2    86,016       2
//   128       135,936       1   135,168       1
// Every output element has one writer and there are no atomics: runs are
// bitwise repeatable. The di pass is its own launch, one warp a row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "split_f32.cuh"
#include "wgmma.cuh"

using namespace split_f32;
using namespace hopper;

namespace {

constexpr int kThreads = 256;  // the di pass
constexpr int kMaxHeadDim = 128;

__host__ __device__ inline int ceil_div(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ inline int round16(int x) { return ceil_div(x, 16) * 16; }

// The forward's geometry. A block of G warpgroups (fwd_groups(s)) owns 64
// query rows a warpgroup and walks the keys fwd_keys(P) at a time (a last
// chunk with at most 16 or 32 live keys at that width). P = ceil(dh / 32):
// the head dim in 32-column panels, one 128-byte row of TF32 each.
constexpr int kQPanel = 64 * 128;  // bytes: one warpgroup's 64 query rows, one panel

// Two warpgroups a block share each chunk's split; one where a warpgroup
// holds every row (s <= 64), so none runs its products on rows past s.
__host__ __device__ constexpr int fwd_groups(int s) { return s <= 64 ? 1 : 2; }
__host__ __device__ constexpr int fwd_panels(int dh) { return (dh + 31) / 32; }
// Keys of a chunk at P panels: 64, or 32 where the planes of 64 would not
// fit beside Q's.
__host__ __device__ constexpr int fwd_keys(int p) { return p <= 2 ? 64 : 32; }

// Q's hi and lo planes; a chunk's K planes (keys · 128 bytes a panel), V
// planes (transposed: 32·P rows a 32-key panel) and f32 K and V rows, each
// 2 · P · keys · 128 bytes; and 1 KB to align the planes to the 128-byte
// swizzle's 1,024-byte period.
__host__ __device__ inline size_t fwd_smem_bytes(int dh, int groups) {
  const int p = fwd_panels(dh);
  return (size_t)(2 * groups * p * kQPanel + 6 * p * fwd_keys(p) * 128) + 1024;
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled plane.
__device__ inline int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ inline void split4(const float4 x, uint4& hi, uint4& lo) {
  split_nan_lo(x.x, hi.x, lo.x);
  split_nan_lo(x.y, hi.y, lo.y);
  split_nan_lo(x.z, hi.z, lo.z);
  split_nan_lo(x.w, hi.w, lo.w);
}

// Rows [q0, q0 + 64·G) of one head's (s, dh) slice of q (rows at stride
// `width`) split into Q's hi and lo planes (warpgroup w's rows at panels
// [w·P, w·P + P)), zero past s and dh. Every load is issued before the
// first split (16 bytes a load with `vec`), so the block waits for device
// memory once.
template <int P, int G>
__device__ inline void split_queries(unsigned char* hi, unsigned char* lo,
                                     const float* __restrict__ q, int q0, int s, int width,
                                     int dh, bool vec) {
  constexpr int kThreads = 128 * G, kItems = 4 * P;  // kItems: 16-byte chunks a thread
  float4 x[kItems];
#pragma unroll
  for (int n = 0; n < kItems; ++n) {
    const int i = threadIdx.x + n * kThreads, row = q0 + i / (8 * P), col = 4 * (i % (8 * P));
    const float* src = q + (size_t)row * width + col;
    x[n] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s && vec && col < dh) x[n] = __ldg(reinterpret_cast<const float4*>(src));
    if (row < s && !vec) {
      if (col < dh) x[n].x = __ldg(src);
      if (col + 1 < dh) x[n].y = __ldg(src + 1);
      if (col + 2 < dh) x[n].z = __ldg(src + 2);
      if (col + 3 < dh) x[n].w = __ldg(src + 3);
    }
  }
#pragma unroll
  for (int n = 0; n < kItems; ++n) {
    const int i = threadIdx.x + n * kThreads, r = i / (8 * P), c = i % (8 * P);
    uint4 h, l;
    split4(x[n], h, l);
    const int off = ((r / 64) * P + c / 8) * kQPanel + sw128(r % 64, c % 8);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Keys [k0, k0 + fwd_keys(P)) of one head's K and V slices into kraw and
// vraw (rows of 32·P floats), zero past s and dh: 16 bytes a copy with
// `vec`, else 4, by a block of G warpgroups. The caller commits.
template <int P, int G>
__device__ inline void fetch_chunk(float* kraw, float* vraw, const float* __restrict__ k,
                                   const float* __restrict__ v, int k0, int s, int width, int dh,
                                   bool vec) {
  constexpr int kD = 32 * P, kKeys = fwd_keys(P), kThreads = 128 * G;
  if (vec) {
#pragma unroll
    for (int n = 0; n < kKeys * kD / 4 / kThreads; ++n) {
      const int i = threadIdx.x + n * kThreads, r = i / (kD / 4), c = i % (kD / 4) * 4;
      const bool in = k0 + r < s && c < dh;
      const size_t off = in ? (size_t)(k0 + r) * width + c : 0;
      cp_async16(kraw + r * kD + c, k + off, in ? 16 : 0);
      cp_async16(vraw + r * kD + c, v + off, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int n = 0; n < kKeys * kD / kThreads; ++n) {
      const int i = threadIdx.x + n * kThreads, r = i / kD, c = i % kD;
      const bool in = k0 + r < s && c < dh;
      const size_t off = in ? (size_t)(k0 + r) * width + c : 0;
      cp_async4(kraw + r * kD + c, k + off, in ? 4 : 0);
      cp_async4(vraw + r * kD + c, v + off, in ? 4 : 0);
    }
  }
}

// The chunk's first NK keys (B of x = q·kᵀ) split into hi and lo planes, one
// per 32-column panel of fwd_keys(P) rows (a key a row, the columns in
// their own order, K-major), by a block of G warpgroups.
template <int P, int G, int NK>
__device__ inline void split_keys(unsigned char* hi, unsigned char* lo, const float* raw) {
  constexpr int kD = 32 * P, kItems = NK * 8 * P, kThreads = 128 * G;
#pragma unroll
  for (int n = 0; n < (kItems + kThreads - 1) / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads, r = i / (8 * P), c = i % (8 * P);
    if (kItems % kThreads != 0 && i >= kItems) break;
    uint4 h, l;
    split4(*reinterpret_cast<const float4*>(raw + r * kD + 4 * c), h, l);
    const int off = (c / 8) * fwd_keys(P) * 128 + sw128(r, c % 8);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// The chunk's first NK values (B of o = p·v) transposed and split into hi
// and lo planes: a row per head-dim column, 32 keys along it a panel. The A
// operand is p's accumulator: k-step j's k = t is key 8j + 2t and k = t + 4
// is 8j + 2t + 1, so plane position 8j + u holds key 8j + 2u (u < 4) or
// 8j + 2(u − 4) + 1, and chunk c of a panel's row keys 8(c/2) + (c odd) +
// 0, 2, 4, 6 of the panel. By a block of G warpgroups.
template <int P, int G, int NK>
__device__ inline void split_values(unsigned char* hi, unsigned char* lo, const float* raw) {
  constexpr int kD = 32 * P, kItems = kD * NK / 4, kThreads = 128 * G;
#pragma unroll
  for (int n = 0; n < (kItems + kThreads - 1) / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads, d = i % kD, cc = i / kD, c = cc % 8;
    if (kItems % kThreads != 0 && i >= kItems) break;
    const float* col = raw + (32 * (cc / 8) + 8 * (c / 2) + (c & 1)) * kD + d;
    uint4 h, l;
    split4(make_float4(col[0], col[2 * kD], col[4 * kD], col[6 * kD]), h, l);
    const int off = (cc / 8) * kD * 128 + sw128(d, c);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Forward: grid (query blocks of 64·G rows, heads, b), G = fwd_groups(s).
// out = softmax(x)·v; stats (b, h, 2, s) = (m, l) when not null. `vec`:
// 16-byte loads and copies (dh % 4 == 0, q, k, v 16-byte aligned).
template <int P, int G>
__global__ void __launch_bounds__(128 * G, 1)
attention_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ stats, int s, int heads, int dh, float scale,
                         int causal, int vec) {
  constexpr int kD = 32 * P;  // head-dim columns of the planes, zero past dh
  constexpr int kKeys = fwd_keys(P), kKPanel = kKeys * 128;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  // Aligned by an offset, so the compiler still sees shared-memory pointers.
  unsigned char* qhi =
      fwd_smem + ((1024 - (unsigned)__cvta_generic_to_shared(fwd_smem) % 1024) % 1024);
  unsigned char* qlo = qhi + G * P * kQPanel;
  unsigned char* khi = qlo + G * P * kQPanel;
  unsigned char* klo = khi + P * kKPanel;
  unsigned char* vhi = klo + P * kKPanel;  // kKeys / 32 panels of kD rows
  unsigned char* vlo = vhi + P * kKPanel;
  float* kraw = reinterpret_cast<float*>(vlo + P * kKPanel);
  float* vraw = kraw + kKeys * kD;
  const int q0 = blockIdx.x * 64 * G, h = blockIdx.y, b = blockIdx.z;
  const int width = heads * dh, grp = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  // Keys a block's rows see, its chunks, and the last one's live keys.
  const int kend = causal ? min(s, q0 + 64 * G) : s;
  const int chunks = ceil_div(kend, kKeys);
  const int last = kend - (chunks - 1) * kKeys;

  fetch_chunk<P, G>(kraw, vraw, k + slab, v + slab, 0, s, width, dh, vec);
  cp_async_commit();
  // The block's query rows, split once into Q's planes.
  split_queries<P, G>(qhi, qlo, q + slab, q0, s, width, dh, vec);

  // Rows a (g) and b (g + 8) of this warp's 16: their running max m, sum l
  // and output, in the layout of a wgmma m64n(32·P) accumulator (element
  // 4n + e: row a for e < 2, else b; column 8n + 2t + e % 2).
  const int row_a = q0 + 64 * grp + 16 * warp + g;
  float o[16 * P], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 16 * P; ++e) o[e] = 0.f;
  const unsigned char* qh = qhi + grp * P * kQPanel;
  const unsigned char* ql = qlo + grp * P * kQPanel;

  // Chunk j at NK keys (kKeys, or 16 or 32 for a short last chunk).
  const auto chunk = [&](auto nk, int j) {
    constexpr int NK = decltype(nk)::value;
    const int k0 = j * kKeys;
    cp_async_wait<0>();
    __syncthreads();  // chunk j landed (and Q's planes are written); chunk j − 1's planes are free
    split_keys<P, G, NK>(khi, klo, kraw);
    split_values<P, G, NK>(vhi, vlo, vraw);
    fence_proxy_async();
    __syncthreads();  // the planes are written; kraw and vraw are free
    if (j + 1 < chunks)
      fetch_chunk<P, G>(kraw, vraw, k + slab, v + slab, k0 + kKeys, s, width, dh, vec);
    cp_async_commit();

    // x = q·kᵀ over the head dim, k-step kk its columns [8kk, 8kk + 8):
    // lo·hi, hi·lo, hi·hi, summed in fresh registers.
    float x[NK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * P; ++kk) {
      const int qo = (kk / 4) * kQPanel + 32 * (kk % 4), ko = (kk / 4) * kKPanel + 32 * (kk % 4);
      wgmma_tf32_ss<NK>(x, sw128_desc(ql + qo, 16), sw128_desc(khi + ko, 16), kk > 0);
      wgmma_tf32_ss<NK>(x, sw128_desc(qh + qo, 16), sw128_desc(klo + ko, 16), 1);
      wgmma_tf32_ss<NK>(x, sw128_desc(qh + qo, 16), sw128_desc(khi + ko, 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(x);

    // The online softmax in the same registers: x·scale, −inf on keys past
    // s and (causal) after the row; the rows' new max, p = exp(x − m),
    // the rescale of what came before, and the sums.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1), row = row_a + 8 * (e >> 1);
        const bool live = key < s && (!causal || key <= row);
        x[4 * n + e] = live ? x[4 * n + e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], x[4 * n + e]);
      }
    float alpha[2], mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
      alpha[i] = __expf(m[i] - mu[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int e = 0; e < NK / 2; ++e) {
      x[e] = __expf(x[e] - mu[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += x[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);

    // oc = p·v, p split in registers straight from x (k-step j's A fragment
    // is x's 8-key group j: (a, 2t), (b, 2t), (a, 2t + 1), (b, 2t + 1)), in
    // fresh registers; then o = o·alpha + oc in IEEE f32.
    unsigned ahi[NK / 8][4], alo[NK / 8][4];
#pragma unroll
    for (int jj = 0; jj < NK / 8; ++jj) {
      split_nan_lo(x[4 * jj], ahi[jj][0], alo[jj][0]);
      split_nan_lo(x[4 * jj + 2], ahi[jj][1], alo[jj][1]);
      split_nan_lo(x[4 * jj + 1], ahi[jj][2], alo[jj][2]);
      split_nan_lo(x[4 * jj + 3], ahi[jj][3], alo[jj][3]);
    }
    float oc[16 * P];
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < NK / 8; ++jj) {
      const int vo = (jj / 4) * kD * 128 + 32 * (jj % 4);
      wgmma_tf32_rs<kD>(oc, alo[jj], sw128_desc(vhi + vo, 16), jj > 0);
      wgmma_tf32_rs<kD>(oc, ahi[jj], sw128_desc(vlo + vo, 16), 1);
      wgmma_tf32_rs<kD>(oc, ahi[jj], sw128_desc(vhi + vo, 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(oc);
    fence_operands(ahi);
    fence_operands(alo);
#pragma unroll
    for (int e = 0; e < 16 * P; ++e) o[e] = fmaf(o[e], alpha[(e >> 1) & 1], oc[e]);
  };
  for (int j = 0; j < chunks - 1; ++j) chunk(std::integral_constant<int, kKeys>(), j);
  if (last <= 16)
    chunk(std::integral_constant<int, 16>(), chunks - 1);
  else if (kKeys > 32 && last <= 32)
    chunk(std::integral_constant<int, 32>(), chunks - 1);
  else
    chunk(std::integral_constant<int, kKeys>(), chunks - 1);

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = l[i] > 0.f ? __frcp_rn(l[i]) : 0.f;
  float* dst = out + slab;
#pragma unroll
  for (int n = 0; n < 4 * P; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_a + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      if (row < s && col < dh) dst[(size_t)row * width + col] = o[4 * n + e] * inv[e >> 1];
    }
  if (stats != nullptr && t == 0) {
    float* st = stats + ((size_t)b * heads + h) * 2 * s;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row < s) {
        st[row] = m[i];
        st[s + row] = l[i];
      }
    }
  }
}

// The backward's geometry at head dim dh: a block's 64 resident rows, 32
// streamed rows a stage, every row at stride round16(dh) + 4 floats.
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kRes = 16 * kBwdWarps;
constexpr int kStream = 32;  // streamed rows a stage

__host__ __device__ constexpr int bwd_ld(int kc) { return 16 * kc + 4; }

__host__ __device__ inline size_t dkv_smem_bytes(int dh) {
  return (size_t)((2 * kRes + 4 * kStream) * bwd_ld(round16(dh) / 16) + 6 * kStream) *
         sizeof(float);
}

__host__ __device__ inline size_t dq_smem_bytes(int dh) {
  return (size_t)(2 * kRes + 4 * kStream) * bwd_ld(round16(dh) / 16) * sizeof(float);
}

// di (b, h, s) = rowsum(out ⊙ do): one warp per (batch row, position, head).
__global__ void __launch_bounds__(kThreads)
attention_f32_di_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                        float* __restrict__ di, int b, int s, int heads, int dh) {
  const int lane = threadIdx.x % 32;
  const size_t rows = (size_t)b * s * heads;
  for (size_t r = ((size_t)blockIdx.x * kThreads + threadIdx.x) / 32; r < rows;
       r += (size_t)gridDim.x * (kThreads / 32)) {
    const float* o = out + r * dh;
    const float* g = dout + r * dh;
    float acc = 0.f;
    for (int c = lane; c < dh; c += 32) acc = fmaf(__ldg(o + c), __ldg(g + c), acc);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int h = (int)(r % heads), pos = (int)((r / heads) % s), bb = (int)(r / heads / s);
      di[((size_t)bb * heads + h) * s + pos] = acc;
    }
  }
}

// ---- the backward's split-f32 tensor-core products --------------------------

// Rows [row0, row0 + rows) of one head's (s, dh) slice (rows at stride
// `width`) into dst at row stride bwd_ld(KC), zero past s and for columns in
// [dh, 16·KC): 16 bytes a copy with `vec` (dh % 4 == 0, 16-byte aligned
// rows), else 4. The caller commits and waits.
template <int KC>
__device__ inline void load_rows(float* dst, const float* __restrict__ src, int row0, int rows,
                                 int s, int width, int dh, bool vec) {
  constexpr int kDhp = 16 * KC, kLdb = bwd_ld(KC);
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kDhp / 4); i += kBwdThreads) {
      const int r = i / (kDhp / 4), c = i % (kDhp / 4) * 4, row = row0 + r;
      const bool in = row < s && c < dh;
      cp_async16(dst + r * kLdb + c, in ? src + (size_t)row * width + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kDhp; i += kBwdThreads) {
      const int r = i / kDhp, c = i % kDhp, row = row0 + r;
      const bool in = row < s && c < dh;
      cp_async4(dst + r * kLdb + c, in ? src + (size_t)row * width + c : src, in ? 4 : 0);
    }
  }
}

// c[n] = Σ_d a[r][d] · b[8n + c][d]: the warp's 16 rows of `a` (resident)
// against the first 8·NT rows of the streamed tile `b`, over 16·KC columns.
template <int KC, int NT>
__device__ inline void product_rows(float (&c)[NT][4], const float* a, const float* b) {
  constexpr int kLdb = bwd_ld(KC);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* ar = a + g * kLdb + t;
  const float* br = b + g * kLdb + t;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < 2 * KC; ++kc) {
    unsigned ahi[4], alo[4];
    split_nan_lo(ar[8 * kc], ahi[0], alo[0]);
    split_nan_lo(ar[8 * kLdb + 8 * kc], ahi[1], alo[1]);
    split_nan_lo(ar[8 * kc + 4], ahi[2], alo[2]);
    split_nan_lo(ar[8 * kLdb + 8 * kc + 4], ahi[3], alo[3]);
    unsigned bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      split_nan_lo(br[8 * n * kLdb + 8 * kc], bh[n][0], bl[n][0]);
      split_nan_lo(br[8 * n * kLdb + 8 * kc + 4], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], alo, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], ahi, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], ahi, bh[n][0], bh[n][1]);
  }
}

// o[n] += Σ_k p[r][k] · b[k][8n + c] over the first 8·NT rows k of the
// streamed tile b: p is a product_rows accumulator, its columns (2t, 2t + 1)
// taken as the A fragment's k = (t, t + 4), so b's rows are read in that order.
template <int KC, int NT>
__device__ inline void product_acc(float (&o)[2 * KC][4], const float (&p)[NT][4],
                                   const float* b) {
  constexpr int kLdb = bwd_ld(KC);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* br = b + 2 * t * kLdb + g;
#pragma unroll
  for (int kc = 0; kc < NT; ++kc) {
    unsigned ahi[4], alo[4];
    split_nan_lo(p[kc][0], ahi[0], alo[0]);
    split_nan_lo(p[kc][2], ahi[1], alo[1]);
    split_nan_lo(p[kc][1], ahi[2], alo[2]);
    split_nan_lo(p[kc][3], ahi[3], alo[3]);
    unsigned bh[2 * KC][2], bl[2 * KC][2];
#pragma unroll
    for (int n = 0; n < 2 * KC; ++n) {
      split_nan_lo(br[8 * kc * kLdb + 8 * n], bh[n][0], bl[n][0]);
      split_nan_lo(br[(8 * kc + 1) * kLdb + 8 * n], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < 2 * KC; ++n) mma_tf32(o[n], alo, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < 2 * KC; ++n) mma_tf32(o[n], ahi, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < 2 * KC; ++n) mma_tf32(o[n], ahi, bh[n][0], bh[n][1]);
  }
}

// Write a warp's 16 × 16·KC accumulator as rows row0 + g (+8) < s, columns
// < dh of one head's slice.
template <int KC>
__device__ inline void store_acc(float* __restrict__ dst, const float (&o)[2 * KC][4], int row0,
                                 int s, int width, int dh) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 2 * KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      if (row < s && col < dh) dst[(size_t)row * width + col] = o[n][e];
    }
}

// One streamed query tile of the dK/dV kernel for one warp: keys key0 + r
// (resident k, v rows), queries q0 + c (tile rows qt, dot; their m, l, di in
// st[0..N), st[N..2N), st[2N..3N)); only the first 8·NT queries are live.
template <int KC, int NT>
__device__ inline void dkv_tile(float (&gk)[2 * KC][4], float (&gv)[2 * KC][4], const float* kr,
                                const float* vr, const float* qt, const float* dot,
                                const float* st, int key0, int q0, int s, float scale,
                                int causal) {
  constexpr int N = kStream;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float x[NT][4], dp[NT][4];
  product_rows<KC, NT>(x, kr, qt);   // x[key][query]
  product_rows<KC, NT>(dp, vr, dot); // dp[key][query]
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cq = 8 * n + 2 * t + (e & 1), query = q0 + cq, key = key0 + g + 8 * (e >> 1);
      const bool live = query < s && (!causal || key <= query);
      const float p = live ? expf(x[n][e] * scale - st[cq]) * __frcp_rn(st[N + cq]) : 0.f;
      dp[n][e] = p * (dp[n][e] - st[2 * N + cq]) * scale;
      x[n][e] = p;
    }
  product_acc<KC, NT>(gv, x, dot);  // dv += p·do
  product_acc<KC, NT>(gk, dp, qt);  // dk += ds·q
}

// dK/dV: grid (key tiles, heads, b); a block owns 64 key rows and walks the
// query tiles (causal: from its own diagonal on).
template <int KC>
__global__ void __launch_bounds__(kBwdThreads)
attention_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ stats, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, int s, int heads,
                         int dh, float scale, int causal, int vec) {
  constexpr int N = kStream, kLdb = bwd_ld(KC);
  extern __shared__ __align__(16) float bwd_smem[];
  float* kr = bwd_smem;
  float* vr = kr + kRes * kLdb;
  float* ring = vr + kRes * kLdb;       // stage i: q tile at 2i·N rows, do at (2i + 1)·N
  float* rst = ring + 4 * N * kLdb;     // stage i: m, l, di at 3i·N
  const int k0 = blockIdx.x * kRes, h = blockIdx.y, b = blockIdx.z;
  const int width = heads * dh, warp = threadIdx.x / 32;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  const float* st = stats + ((size_t)b * heads + h) * 2 * s;
  const float* dr = di + ((size_t)b * heads + h) * s;
  const int first = causal ? k0 : 0, tiles = ceil_div(s - first, N);
  const auto fetch = [&](int j) {
    const int q0 = first + j * N, i = j & 1;
    load_rows<KC>(ring + 2 * i * N * kLdb, q + slab, q0, N, s, width, dh, vec);
    load_rows<KC>(ring + (2 * i + 1) * N * kLdb, dout + slab, q0, N, s, width, dh, vec);
    for (int r = threadIdx.x; r < 3 * N; r += kBwdThreads) {
      const int row = q0 + r % N;
      const float* src = r < N ? st + row : r < 2 * N ? st + s + row : dr + row;
      cp_async4(rst + 3 * i * N + r, row < s ? src : st, row < s ? 4 : 0);
    }
  };
  load_rows<KC>(kr, k + slab, k0, kRes, s, width, dh, vec);
  load_rows<KC>(vr, v + slab, k0, kRes, s, width, dh, vec);
  fetch(0);
  cp_async_commit();

  float gk[2 * KC][4], gv[2 * KC][4];
#pragma unroll
  for (int n = 0; n < 2 * KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;
  const int key0 = k0 + 16 * warp;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) fetch(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j (and the resident rows) landed for every thread
    const int q0 = first + j * N, i = j & 1;
    const float* qt = ring + 2 * i * N * kLdb;
    const float* dot = qt + N * kLdb;
    if (key0 < s && !(causal && q0 + N - 1 < key0)) {
      if (s - q0 <= 8)  // one 8-row group live (s = 196's last tile)
        dkv_tile<KC, 1>(gk, gv, kr + 16 * warp * kLdb, vr + 16 * warp * kLdb, qt, dot,
                        rst + 3 * i * N, key0, q0, s, scale, causal);
      else
        dkv_tile<KC, N / 8>(gk, gv, kr + 16 * warp * kLdb, vr + 16 * warp * kLdb, qt, dot,
                            rst + 3 * i * N, key0, q0, s, scale, causal);
    }
    __syncthreads();  // every warp is done with stage i before tile j + 2 refills it
  }
  store_acc<KC>(dk + slab, gk, key0, s, width, dh);
  store_acc<KC>(dv + slab, gv, key0, s, width, dh);
}

// One streamed key tile of the dQ kernel for one warp: queries row0 + r
// (resident q, do rows; their m, 1/l and di in registers, r = g, g + 8),
// keys k0 + c (tile rows kt, vt); only the first 8·NT keys are live.
template <int KC, int NT>
__device__ inline void dq_tile(float (&gq)[2 * KC][4], const float* qr, const float* dor,
                               const float* kt, const float* vt, const float (&rm)[2],
                               const float (&rl)[2], const float (&rd)[2], int row0, int k0,
                               int s, float scale, int causal) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float x[NT][4], dp[NT][4];
  product_rows<KC, NT>(x, qr, kt);    // x[query][key]
  product_rows<KC, NT>(dp, dor, vt);  // dp[query][key]
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * n + 2 * t + (e & 1), row = row0 + g + 8 * (e >> 1), i = e >> 1;
      const bool live = key < s && (!causal || key <= row);
      const float p = live ? expf(x[n][e] * scale - rm[i]) * rl[i] : 0.f;
      x[n][e] = p * (dp[n][e] - rd[i]) * scale;
    }
  product_acc<KC, NT>(gq, x, kt);  // dq += ds·k
}

// dQ: grid (query tiles, heads, b); a block owns 64 query rows and walks the
// key tiles (causal: up to its diagonal).
template <int KC>
__global__ void __launch_bounds__(kBwdThreads)
attention_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ stats, const float* __restrict__ di,
                        float* __restrict__ dq, int s, int heads, int dh, float scale,
                        int causal, int vec) {
  constexpr int N = kStream, kLdb = bwd_ld(KC);
  extern __shared__ __align__(16) float bwd_smem[];
  float* qr = bwd_smem;
  float* dor = qr + kRes * kLdb;
  float* ring = dor + kRes * kLdb;  // stage i: k tile at 2i·N rows, v at (2i + 1)·N
  const int q0 = blockIdx.x * kRes, h = blockIdx.y, b = blockIdx.z;
  const int width = heads * dh, warp = threadIdx.x / 32;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  const float* st = stats + ((size_t)b * heads + h) * 2 * s;
  const float* dr = di + ((size_t)b * heads + h) * s;
  const int last = causal ? min(s, q0 + kRes) : s, tiles = ceil_div(last, N);
  const auto fetch = [&](int j) {
    const int i = j & 1;
    load_rows<KC>(ring + 2 * i * N * kLdb, k + slab, j * N, N, s, width, dh, vec);
    load_rows<KC>(ring + (2 * i + 1) * N * kLdb, v + slab, j * N, N, s, width, dh, vec);
  };
  load_rows<KC>(qr, q + slab, q0, kRes, s, width, dh, vec);
  load_rows<KC>(dor, dout + slab, q0, kRes, s, width, dh, vec);
  fetch(0);
  cp_async_commit();

  const int row0 = q0 + 16 * warp, g = threadIdx.x % 32 / 4;
  float rm[2], rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    rm[i] = row < s ? st[row] : 0.f;
    rl[i] = row < s ? 1.f / st[s + row] : 0.f;
    rd[i] = row < s ? dr[row] : 0.f;
  }
  float gq[2 * KC][4];
#pragma unroll
  for (int n = 0; n < 2 * KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[n][e] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) fetch(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j (and the resident rows) landed for every thread
    const int k0 = j * N, i = j & 1;
    const float* kt = ring + 2 * i * N * kLdb;
    const float* vt = kt + N * kLdb;
    if (row0 < s && !(causal && k0 > row0 + 15)) {
      if (s - k0 <= 8)  // one 8-row group live (s = 196's last tile)
        dq_tile<KC, 1>(gq, qr + 16 * warp * kLdb, dor + 16 * warp * kLdb, kt, vt, rm, rl, rd,
                       row0, k0, s, scale, causal);
      else
        dq_tile<KC, N / 8>(gq, qr + 16 * warp * kLdb, dor + 16 * warp * kLdb, kt, vt, rm, rl,
                           rd, row0, k0, s, scale, causal);
    }
    __syncthreads();  // every warp is done with stage i before tile j + 2 refills it
  }
  store_acc<KC>(dq + slab, gq, row0, s, width, dh);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int b, int s, int heads, int dh) {
  return b < 1 || b > 65535 || s < 1 || heads < 1 || heads > 65535 || dh < 1 ||
         dh > kMaxHeadDim;
}

// 16-byte copies: dh % 4 == 0 and every tensor a kernel streams is 16-byte
// aligned (then so is every row of every head).
bool bwd_vec(int dh, const void* q, const void* k, const void* v, const void* dout) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
  return dh % 4 == 0 && any % 16 == 0;
}

// KC = round16(dh) / 16: the backward's 16-column groups.
#define ATTN_F32_SWITCH(NC_EXPR, CALL)                                              \
  switch (NC_EXPR) {                                                                \
    case 1: CALL(1) case 2: CALL(2) case 3: CALL(3) case 4: CALL(4) case 5: CALL(5) \
    case 6: CALL(6) case 7: CALL(7) case 8: CALL(8)                                 \
    default: return (int)cudaErrorInvalidValue;                                     \
  }

// P = fwd_panels(dh): the forward's 32-column panels.
#define ATTN_F32_FWD_SWITCH(P_EXPR, CALL)                               \
  switch (P_EXPR) {                                                     \
    case 1: CALL(1) case 2: CALL(2) case 3: CALL(3) case 4: CALL(4)     \
    default: return (int)cudaErrorInvalidValue;                         \
  }

template <int P, int G>
int launch_fwd(const float* q, const float* k, const float* v, float* out, float* stats, int b,
               int s, int heads, int dh, float scale, int causal, int vec, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(dh, G);
  cudaError_t err = configure(attention_f32_fwd_kernel<P, G>, smem);
  if (err != cudaSuccess) return (int)err;
  attention_f32_fwd_kernel<P, G><<<dim3(ceil_div(s, 64 * G), heads, b), 128 * G, smem, st>>>(
      q, k, v, out, stats, s, heads, dh, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* stats, const float* di, float* dk, float* dv, int b, int s,
               int heads, int dh, float scale, int causal, int vec, cudaStream_t st) {
  const size_t smem = dkv_smem_bytes(dh);
  cudaError_t err = configure(attention_f32_dkv_kernel<KC>, smem);
  if (err != cudaSuccess) return (int)err;
  attention_f32_dkv_kernel<KC><<<dim3(ceil_div(s, kRes), heads, b), kBwdThreads, smem, st>>>(
      q, k, v, dout, stats, di, dk, dv, s, heads, dh, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* stats, const float* di, float* dq, int b, int s, int heads, int dh,
              float scale, int causal, int vec, cudaStream_t st) {
  const size_t smem = dq_smem_bytes(dh);
  cudaError_t err = configure(attention_f32_dq_kernel<KC>, smem);
  if (err != cudaSuccess) return (int)err;
  attention_f32_dq_kernel<KC><<<dim3(ceil_div(s, kRes), heads, b), kBwdThreads, smem, st>>>(
      q, k, v, dout, stats, di, dq, s, heads, dh, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <int P, int G>
int fwd_occupancy(int dh) {
  int blocks = 0;
  cudaError_t err = configure(attention_f32_fwd_kernel<P, G>, fwd_smem_bytes(dh, G));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attention_f32_fwd_kernel<P, G>,
                                                        128 * G, fwd_smem_bytes(dh, G));
  return err == cudaSuccess ? blocks : 0;
}

template <int NC>
int occupancy(int which, int dh) {
  int blocks = 0;
  cudaError_t err;
  if (which == 1) {
    err = configure(attention_f32_dkv_kernel<NC>, dkv_smem_bytes(dh));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attention_f32_dkv_kernel<NC>,
                                                          kBwdThreads, dkv_smem_bytes(dh));
  } else {
    err = configure(attention_f32_dq_kernel<NC>, dq_smem_bytes(dh));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attention_f32_dq_kernel<NC>,
                                                          kBwdThreads, dq_smem_bytes(dh));
  }
  return err == cudaSuccess ? blocks : 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the forward (which = 0), dK/dV (1)
// or dQ (2) at head dim dh and length s (the forward's warpgroups), bytes.
long long attention_f32_smem_bytes(int dh, int which, int s) {
  if (dh < 1) return 0;
  return (long long)(which == 0 ? fwd_smem_bytes(dh, fwd_groups(s))
                                : which == 1 ? dkv_smem_bytes(dh) : dq_smem_bytes(dh));
}

// Blocks of the forward (which = 0), dK/dV (1) or dQ (2) kernel that one SM
// of this card holds at head dim dh and length s (registers and shared
// memory); 0 on error.
int attention_f32_occupancy(int dh, int which, int s) {
  if (dh < 1 || dh > kMaxHeadDim) return 0;
  if (which == 0) {
    const bool one = fwd_groups(s) == 1;
    switch (fwd_panels(dh)) {
      case 1: return one ? fwd_occupancy<1, 1>(dh) : fwd_occupancy<1, 2>(dh);
      case 2: return one ? fwd_occupancy<2, 1>(dh) : fwd_occupancy<2, 2>(dh);
      case 3: return one ? fwd_occupancy<3, 1>(dh) : fwd_occupancy<3, 2>(dh);
      case 4: return one ? fwd_occupancy<4, 1>(dh) : fwd_occupancy<4, 2>(dh);
      default: return 0;
    }
  }
#define OCC_CALL(NC) return occupancy<NC>(which, dh);
  switch (round16(dh) / 16) {
    case 1: OCC_CALL(1) case 2: OCC_CALL(2) case 3: OCC_CALL(3) case 4: OCC_CALL(4)
    case 5: OCC_CALL(5) case 6: OCC_CALL(6) case 7: OCC_CALL(7) case 8: OCC_CALL(8)
    default: return 0;
  }
#undef OCC_CALL
}

// q, k, v, out: (b, s, heads·dh) f32, contiguous; stats: (b, heads, 2, s) f32
// (m, then l) or null. Returns the cudaError_t of the launch (0 on success);
// it does not synchronise. cudaErrorInvalidValue for dh > 128.
int attention_f32_fwd(const void* q, const void* k, const void* v, void* out, void* stats, int b,
                      int s, int heads, int dh, float scale, int causal, void* stream) {
  if (bad_shape(b, s, heads, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float *of = static_cast<float*>(out), *sf = static_cast<float*>(stats);
  const int vec = bwd_vec(dh, q, k, v, v);
#define FWD_CALL(P)                                                                    \
  return fwd_groups(s) == 1                                                            \
             ? launch_fwd<P, 1>(qf, kf, vf, of, sf, b, s, heads, dh, scale, causal, vec, st) \
             : launch_fwd<P, 2>(qf, kf, vf, of, sf, b, s, heads, dh, scale, causal, vec, st);
  ATTN_F32_FWD_SWITCH(fwd_panels(dh), FWD_CALL)
#undef FWD_CALL
}

// The di pass, then dK/dV. out, dout: (b, s, heads·dh) f32; stats from the
// forward; di: (b, heads, s) f32 scratch, written here for the dQ pass.
int attention_f32_bwd_dkv(const void* q, const void* k, const void* v, const void* out,
                          const void* dout, const void* stats, void* di, void* dk, void* dv,
                          int b, int s, int heads, int dh, float scale, int causal,
                          void* stream) {
  if (bad_shape(b, s, heads, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)b * s * heads;
  const size_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  attention_f32_di_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0, st>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), static_cast<float*>(di),
      b, s, heads, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout),
              *sf = static_cast<const float*>(stats), *df = static_cast<const float*>(di);
  float *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv);
  const int vec = bwd_vec(dh, q, k, v, dout);
#define DKV_CALL(KC)                                                                         \
  return launch_dkv<KC>(qf, kf, vf, gf, sf, df, dkf, dvf, b, s, heads, dh, scale, causal, vec, \
                        st);
  ATTN_F32_SWITCH(round16(dh) / 16, DKV_CALL)
#undef DKV_CALL
}

// dQ from the forward's stats and the dK/dV pass's di.
int attention_f32_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                         const void* stats, const void* di, void* dq, int b, int s, int heads,
                         int dh, float scale, int causal, void* stream) {
  if (bad_shape(b, s, heads, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout),
              *sf = static_cast<const float*>(stats), *df = static_cast<const float*>(di);
  float* dqf = static_cast<float*>(dq);
  const int vec = bwd_vec(dh, q, k, v, dout);
#define DQ_CALL(KC) \
  return launch_dq<KC>(qf, kf, vf, gf, sf, df, dqf, b, s, heads, dh, scale, causal, vec, st);
  ATTN_F32_SWITCH(round16(dh) / 16, DQ_CALL)
#undef DQ_CALL
}

const char* attention_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
