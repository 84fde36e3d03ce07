// Streaming sigmoid-loss block for Hopper (sm_90a): forward (K4) and the two
// backward passes (K5, K6).
//
// Replaces the Pallas TPU kernels of distributed_sigmoid_loss_tpu/ops/
// pallas_sigmoid_loss.py. Over one (b × n) block of image rows zimg (b, d) and
// text rows ztxt (n, d), with t = exp(t′), raw = zimg·ztxtᵀ (f32),
// logit = raw·t + bias, label = +1 where col == row + off and −1 elsewhere
// (off = −2²⁴ makes every label −1):
//   K4  (_fwd, body _fwd_kernel):        loss = Σ softplus(−label·logit)
//   K5  (_bwd pass 1, _bwd_img_kernel):  dl = g·(−label·σ(−label·logit)),
//                                        dzimg = t·dl·ztxt, dt′ = t·Σ dl·raw,
//                                        dbias = Σ dl
//   K6  (_bwd pass 2, _bwd_txt_kernel):  dztxt = t·dlᵀ·zimg
//
// Numerics. Everything outside the products is IEEE f32: precise expf and
// log1pf, softplus(x) = max(x, 0) + log1p(exp(−|x|)) as jax.nn.softplus
// computes it, and the products `raw·t` and `+ bias` rounded apart (no
// contraction into one FMA), as JAX rounds them; K5/K6's sigmoid takes its
// reciprocal from rcp.approx refined by one Newton step (within an ulp).
//   f32 mode: every product, K4's logits, K5/K6's recompute of them (raw =
//   own·otherᵀ) and their gradient product dl·other, runs on the tensor
//   cores in split f32 (3xTF32, split_f32.cuh): each f32 operand as hi =
//   tf32(x) and lo = tf32(x − hi), lo·hi + hi·lo + hi·hi summed in f32,
//   ~2^-22 of each term dropped. The tensor cores truncate as they
//   accumulate, so sums are kept short: each 32-column step of the logits
//   (12 TF32 products) is summed in fresh registers and then added to the
//   logits with IEEE adds, in K4 as in K5/K6, so the forward evaluates the
//   function the backward differentiates; the gradient accumulator sums at
//   most 8 tiles (512 other rows; 192 TF32 products; 4 in the int8 mode)
//   before it is folded into the block's output rows with IEEE adds, the
//   splits' partials summed in IEEE f32 too. On the card the
//   gradients stay within ~5e-6 of the largest magnitude of the IEEE plain
//   versions at the 4096-row ring hop (contract 1e-4); without the short
//   sums they drifted to 4e-5 at d = 2000. Plain TF32 (hi·hi alone, ~6e-4
//   of the largest magnitude in emulation) would miss the contract and is
//   not used.
//
// Bounds at one ring hop of a 32k global batch over 8 ranks (b = n = 4096,
// d = 512): operations. K4 reads 16.8 MB (5 µs) and does 2·b·n·d = 17.2
// GFLOP: 0.256 ms at the 67 TFLOP/s f32 peak outside the tensor cores, or,
// as three TF32 products, 0.104 ms at the 495 TFLOP/s TF32 peak. K5 and K6
// each do 4·b·n·d = 34.4 GFLOP: 0.513 ms on the CUDA cores, or 0.208 ms in
// 3xTF32. K4's epilogue (softplus with precise expf and log1pf) adds b·n
// evaluations on the CUDA cores beside the products.
//
// Design. No logits matrix ever reaches device memory: every kernel
// recomputes its logit tiles from the embeddings, so memory stays O(tile),
// as in the TPU kernels. The TPU kernels carried their sums from one grid
// step to the next; Hopper's blocks run in no order, so partial sums go to
// scratch and are summed in a fixed order by a second kernel: runs are
// bitwise repeatable (no float atomics).
//   K4: a persistent grid of blocks of two warpgroups (one an SM in the
//   f32 mode, two in the int8 mode) walks 128 × 128 tiles of the logits (tile x,
//   x + grid, …; the operand with fewer 128-row blocks is swept fastest, so
//   it stays in L2 while the other streams). A warpgroup holds the logits of
//   64 zimg rows against the tile's 128 ztxt rows in the registers of a wgmma
//   m64n128 accumulator. f32 mode: each 32-column step's B (the tile's ztxt
//   rows) is split once into TF32 hi and lo planes (K-major, 128-byte
//   swizzled, laid out as K5's logit planes; two sets, used in turn), each
//   warp splits its own 16 zimg rows (A) in registers, and wgmma m64n128k8
//   forms the three products of each 8 columns into a fresh accumulator,
//   added to the logits with IEEE adds; step i + 1's B is split into the
//   other plane set while step i's products run. int8 mode: a step is 128
//   values of d; the int8 rows of both operands land by cp.async straight
//   in 128-byte-swizzled K-major tiles, and wgmma m64n128k32 s8 (both
//   operands in shared memory) accumulates the tile's exact int32 sums.
//   Every step streams through a cp.async ring (f32: four stages, int8:
//   three) that runs on across the block's tiles; step i + stages − 1's
//   copies are issued after step i's products (straight-line code, so the
//   wgmmas stay asynchronous), and steps i + 2 (f32; int8: i + 1) to
//   i + stages − 1 fly while step i computes, the next tile's first ones
//   while a tile's epilogue runs. The epilogue, in registers: (int8:
//   dequantize) logit_of, the label, softplus, the mask, a per-thread sum
//   and the block's fixed-order sum into one partial per tile, which
//   sigmoid_loss_reduce_kernel sums in tile order: bitwise repeatable
//   whatever the grid. K4 keeps no copy of the operands in device memory:
//   its scratch is the partials, 4 bytes a tile. By width d (the steps of a
//   tile in each mode; shared bytes and blocks per SM in each mode; '-':
//   the int8 mode takes d % 16 == 0):
//      d   f32 steps   int8 steps   f32 shared   int8 shared   blocks/SM
//    200           7            -      214,016        99,328     1     2
//    512          16            4      214,016        99,328     1     2
//   1152          36            9      214,016        99,328     1     2
//   2000          63           16      214,016        99,328     1     2
//   4096         128           32      214,016        99,328     1     2
//   K5 and K6 (one kernel, K6 on the transposed problem: own = ztxt, other =
//   zimg): a block of two warpgroups owns 128 rows of `own` (64 a
//   warpgroup, 16 a warp) and a slice of at most 256 gradient columns
//   (grid.y), and walks a share (grid.z) of the other operand's 64-row
//   tiles. Per tile a warpgroup
//     1. forms its 64 × 64 logits in the registers of a wgmma m64n64
//        accumulator over d, 32 columns a step: the tile's rows (B) are
//        split once per block into TF32 hi and lo planes in shared memory
//        (K-major, 128-byte swizzled), each warp splits its own 16 rows (A)
//        in registers, and wgmma m64n64k8 forms the three products of each
//        8 columns. The slices of one row block form a thread-block cluster
//        along grid.y (up to 8; the int8 mode's clusters are of one): each
//        member sums its share of d's steps, and every member adds all the
//        members' partial logits in rank order over distributed shared
//        memory, so the logits are formed once per row block, bitwise the
//        same in every member, whatever the slicing;
//     2. turns them into dl in the same registers (logit_of, the label, the
//        sigmoid; masked to 0 outside the block), takes K5's dt′ and dbias
//        sums from them, and splits each dl into the gradient product's A
//        fragments: k-step j's k = t is accumulator column 8j + 2t and
//        k = t + 4 is 8j + 2t + 1, so dl never touches shared memory;
//     3. adds dl·other[tile, slice] into its gradient rows with wgmma
//        m64n256k8, B the tile's slice transposed and split into hi and lo
//        planes (its rows in the order (2t, 2t + 1)), 32 tile rows a step.
//   The gradient rows (64 × 256 f32 a warpgroup, 128 registers a thread)
//   stay in the accumulator across the block's sweep and go to its rows of
//   dout (× t at the end) when grid.z is 1, else of the split's scratch:
//   written after at most 8 tiles, then after every 8 more (and the last)
//   each thread adds its accumulator to what it wrote there (a fold, IEEE
//   f32; the rows are the block's own, so the order is fixed) and starts it
//   at zero. A fold reads its old values back by cp.async into the gradient
//   planes, free between tiles, half the rows at a time (read into
//   registers, a few at a time beside the accumulator, they made each fold
//   ~25 µs and the ring hop ~8% slower on an H100 80GB HBM3 at 700 W). The
//   splits (grid.z) are chosen on the card (sigmoid_loss_bwd_splits): of the
//   counts whose blocks fill at most two resident waves, the one with the
//   fewest waves × tiles per split, so the scratch holds at most about two
//   waves of blocks' rows (at the 4096 × 32768 × 512 block of the fused
//   all-gather, 2 splits of 8.4 MB for K5 and none for K6). K5's blocks of
//   slice 0 also write partials of dt′ and dbias.
//   Every step (32 columns of own's rows and the tile's, or 32 tile rows of
//   the slice) streams through a four-stage cp.async ring: step i + 3's
//   copies fly while step i computes. Rows are copied 16 bytes at a time
//   when d % 4 == 0 and the tensors are 16-byte aligned, else 4 bytes at a
//   time, into the same layout: bitwise the same result. Ragged b, n and d
//   are zero-filled and masked. A thread reads its A values of four k-steps
//   as two 16-byte loads (k-step s takes column 8t + s as k = t and 8t + 4
//   + s as k = t + 4; the planes hold B in that order), and staged rows lie
//   at a stride ≡ 4 mod 8 floats (36 for a logit step, 260 for a gradient
//   step). The partial logits are exchanged in the gradient planes' space.
//   Shared memory: the planes (2 × 32 KB gradient, 2 × 8 KB logits), four
//   stages of 32 × 260 floats and 1 KB of alignment slack; a block needs
//   one SM (255 registers). By width d (blocks per SM by shared memory of
//   228 KB, 1 KB reserved a block; the steps of a tile in the f32 mode for
//   the cluster member with the most; the int8 mode's logit steps take 128
//   values of d each):
//      d   slices   slice   cluster   steps a tile   shared bytes   blocks/SM
//    200        1     224         1              9        216,064           1
//    512        2     256         2             10        216,064           1
//   1152        5     256         5             10        216,064           1
//   2000        8     256         8             10        216,064           1
//   4096       16     256         1            130        216,064           1
//   Registers: 255 a thread in all four instantiations (ptxas), none
//   spilled; [build] in chip_smoke.py fails on a spill.
//
// int8 mode (K4 int8: the int8 tile product _tile_raw_int8 of the same TPU
// kernels, reached under quant="int8"). The caller quantizes each embedding
// row once (symmetric int8, per-row f32 scale, ops/quant.py), and the logit
// tile is raw = (f32(Σ ziq·ztq) · zis) · zts: an exact int32 sum, converted
// once and dequantized by two separately rounded multiplies in JAX's order,
// image scale first. K4 forms the sum by wgmma m64n128k32 s8, K5/K6 by
// mma.sync m16n8k32 s8 products laid out as the f32 mode's wgmma
// accumulator (exact in int32 in any order, so the same raw, bitwise the
// plain version's). Everything after raw is the f32 mode's epilogue.
// K5/K6 recompute dlogits at the int8 raw (and dt′ sums dl·raw at it), but
// their gradient products read the full-precision f32 rows of the other
// operand: the straight-through contract of JAX's kernel; that product is
// the f32 mode's split-f32 one, within 1e-5 of the largest magnitude of the
// IEEE plain version. The int8 mode takes d % 16 == 0 and 16-byte aligned
// int8 operands (the dispatch hands it d % 128 == 0 only); rows are masked
// as in the f32 mode. Bound at the 4096 × 4096 × 512 ring hop: the
// forward's 17.2 G int8 operations are 8.7 µs at 1,979 TOP/s, but its
// epilogue binds: 61 SASS instructions a logit on the CUDA cores (dequantize,
// label, logit_of, softplus with precise expf and log1pf, mask, sum; counted
// by compare_sigmoid_loss.py --count-epilogue), 30.5 µs for 16.8 M logits at
// the f32 peak's instruction rate (67 TFLOP/s counts an FMA as two); bytes
// (4.2 MB, 1.3 µs) do not bind.
// K5/K6 keep one f32 gradient product each (2·b·n·d), 0.104 ms in 3xTF32
// at 495 TFLOP/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_f32.cuh"
#include "wgmma.cuh"

#include <cooperative_groups.h>

using namespace hopper;
using namespace split_f32;

namespace {

constexpr int kThreads = 256;        // every K4-K6 block: two warpgroups
constexpr int kReduceThreads = 256;

__host__ __device__ inline int ceil_div(int x, int m) { return (x + m - 1) / m; }

__device__ inline float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

// 1 / (1 + e^-x), the reciprocal as the hardware approximation refined by
// one Newton step (within an ulp of the IEEE quotient; 0 where 1 + e^-x
// overflows): the IEEE division's slow-path call made K5/K6, whose gradient
// rows fill the registers, spill around it.
__device__ inline float sigmoid(float x) {
  const float den = 1.f + expf(-x);
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(den));
  const float r = __fmaf_rn(y, __fmaf_rn(-den, y, 1.f), y);
  return isinf(den) ? 0.f : r;
}

// logit = raw·t + bias with both roundings kept (no contraction to an FMA).
__device__ inline float logit_of(float raw, float t, float bias) {
  return __fadd_rn(__fmul_rn(raw, t), bias);
}

// Sum over the block in a fixed order (warp trees, then the warps in turn);
// the result is valid in thread 0. `red` holds kThreads / 32 floats.
__device__ inline float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // `red` may alias staging the block has just read
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)blockDim.x / 32; ++w) s += red[w];
  return s;
}

// What the kernels read. f32 mode: own and other are the f32 rows of the
// logit product. int8 mode: own_q/other_q are the int8 rows (four a word)
// with their per-row scales own_s/other_s; `other` stays the f32 rows of
// the gradient product (K5/K6) and `own` is unused.
struct Operands {
  const float* own;
  const float* other;
  const int* own_q;
  const int* other_q;
  const float* own_s;
  const float* other_s;
};

// ---- K5/K6: split-f32 tensor-core products, dlogits and gradient rows in
// registers (their ring and plane layouts are K4's too) ------------------------

constexpr int kBwdRows = 128;                   // owned rows a block, 16 a warp
constexpr int kBwdTile = 64;                    // rows of the other operand a tile
constexpr int kMaxSlice = 256;                  // gradient columns a block keeps
constexpr int kStepCols = 32;                   // 32-bit columns of a logit step
constexpr int kLdStep = kStepCols + 4;          // their row stride in a stage, floats
constexpr int kGradRows = 32;                   // tile rows of a gradient step
constexpr int kLdGrad = kMaxSlice + 4;          // their row stride in a stage, floats
constexpr int kStages = 4;                      // cp.async ring
// Tiles the gradient accumulator sums before a fold: the tensor cores
// truncate as they accumulate, so the running sums are kept short (24 TF32
// products a tile); every fold_tiles<Q>() tiles a block adds its accumulator
// to its own rows of the output in IEEE f32 and starts it again at zero.
// The int8 mode folds after fewer tiles: its contract is ten times tighter
// (1e-5 of the largest magnitude), and at 8 tiles the 4096 × 32768 × 512
// block of the fused all-gather reached it.
constexpr int kFoldTilesInt8 = 4;
template <bool Q>
__host__ __device__ constexpr int fold_tiles() { return Q ? kFoldTilesInt8 : 8; }
// Resident waves of blocks the splits may fill at most: the scratch of the
// splits' partial gradients stays within about that many blocks' rows.
constexpr int kMaxSplitWaves = 2;
constexpr int kStageFloats = kGradRows * kLdGrad;
static_assert(kStageFloats >= (kBwdRows + kBwdTile) * kLdStep, "a logit step fits a stage");
// The wgmma operands: 128-byte-swizzled, K-major hi and lo planes of 32 TF32
// values a row: the tile's rows for a logit step, the slice's columns (the
// tile's rows transposed) for a gradient step.
constexpr int kLogitPlane = kBwdTile * 128;     // bytes
constexpr int kGradPlane = kMaxSlice * 128;     // bytes
constexpr size_t kPlaneBytes = 2 * (size_t)kGradPlane + 2 * (size_t)kLogitPlane;

// Gradient columns: d split into the fewest slices of at most kMaxSlice,
// each a whole number of 32-column groups.
__host__ __device__ inline int bwd_slices(int d) { return ceil_div(d, kMaxSlice); }
__host__ __device__ inline int bwd_slice(int d) { return ceil_div(ceil_div(d, bwd_slices(d)), 32) * 32; }

// Blocks of a cluster along grid.y (the slices that share the logits): all
// slices, up to the portable cluster size of 8, in the f32 mode; one in the
// int8 mode, whose logits are cheap.
__host__ __device__ inline int bwd_cluster(int d, bool q) {
  return !q && bwd_slices(d) <= 8 ? bwd_slices(d) : 1;
}

// The planes (1024-byte aligned: the slack below), then the ring.
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return 1024 + kPlaneBytes + (size_t)kStages * kStageFloats * sizeof(float);
}

// Rows [row0, row0 + rows) and 32-bit columns [col0, col0 + ncols) of a
// row-major (nrows × total) matrix into dst at row stride ld, zero outside
// it: 16 bytes a copy with `vec` (total % 4 == 0, a 16-byte aligned base),
// else 4 (ncols % 4 == 0, col0 % 4 == 0). The caller commits.
__device__ inline void load_tile(float* dst, const void* src_, int row0, int rows, int nrows,
                                 int col0, int ncols, int total, int ld, bool vec) {
  const float* src = static_cast<const float*>(src_);
  if (vec) {
    const int per = ncols / 4;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = i % per * 4, row = row0 + r, col = col0 + c;
      const bool in = row < nrows && col < total;
      cp_async16(dst + r * ld + c, in ? src + (size_t)row * total + col : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * ncols; i += kThreads) {
      const int r = i / ncols, c = i % ncols, row = row0 + r, col = col0 + c;
      const bool in = row < nrows && col < total;
      cp_async4(dst + r * ld + c, in ? src + (size_t)row * total + col : src, in ? 4 : 0);
    }
  }
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled plane.
__device__ inline int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// d += a · b: one m16n8k32 s8 product with exact int32 accumulation. a: rows
// g and g + 8 at k-words t, t + 4; b: k-words t, t + 4 at column g (a word
// is four int8 values along k).
__device__ inline void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Item i of a logit step's B operand: rows × 32 columns (stage rows at
// stride kLdStep) split into the hi and lo planes, 8 items a row. The A
// fragments read column 8t + s of the step's 32 as k-step s's k = t and
// 8t + 4 + s as k = t + 4; plane position 8s + u holds that column (u < 4:
// 8u + s, else 8(u − 4) + 4 + s). Item i writes 16-byte chunk c = i % 8 of
// row r = i / 8: columns c/2 + 8·(0..3) (+ 4 for odd c).
__device__ __forceinline__ void split_logit_chunk(unsigned char* hi, unsigned char* lo,
                                                  const float* x, int i) {
  const int r = i / 8, c = i % 8, col = c / 2 + 4 * (c & 1);
  uint4 h, l;
  split(x[r * kLdStep + col], h.x, l.x);
  split(x[r * kLdStep + col + 8], h.y, l.y);
  split(x[r * kLdStep + col + 16], h.z, l.z);
  split(x[r * kLdStep + col + 24], h.w, l.w);
  *reinterpret_cast<uint4*>(hi + sw128(r, c)) = h;
  *reinterpret_cast<uint4*>(lo + sw128(r, c)) = l;
}

// K5/K6's logit step: the tile's 64 rows.
__device__ inline void split_logit_plane(unsigned char* hi, unsigned char* lo, const float* x) {
#pragma unroll 1  // unrolled, the items' loads would crowd the gradient rows' registers
  for (int i = threadIdx.x; i < kBwdTile * 8; i += kThreads) split_logit_chunk(hi, lo, x, i);
}

// A gradient step's B operand: the step's 32 tile rows × 256 slice columns
// (stage rows at stride kLdGrad) transposed and split into the hi and lo
// planes, a row per slice column. The A fragments are dl's accumulator
// registers: k-step j's k = t is tile row 8j + 2t, k = t + 4 is 8j + 2t + 1,
// so plane position 8j + u holds row 8j + 2u (u < 4) or 8j + 2(u − 4) + 1:
// chunk c of column n holds rows 8(c/2) + (c odd) + 0, 2, 4, 6. A thread
// writes one chunk of each plane an item.
__device__ inline void split_grad_plane(unsigned char* hi, unsigned char* lo, const float* x) {
#pragma unroll 1  // as in split_logit_plane
  for (int i = threadIdx.x; i < kMaxSlice * 8; i += kThreads) {
    const int n = i % kMaxSlice, c = i / kMaxSlice;
    const float* col = x + (8 * (c / 2) + (c & 1)) * kLdGrad + n;
    uint4 h, l;
    split(col[0], h.x, l.x);
    split(col[2 * kLdGrad], h.y, l.y);
    split(col[4 * kLdGrad], h.z, l.z);
    split(col[6 * kLdGrad], h.w, l.w);
    *reinterpret_cast<uint4*>(hi + sw128(n, c)) = h;
    *reinterpret_cast<uint4*>(lo + sw128(n, c)) = l;
  }
}

// The int8 mode's logit step for one warp: raw[m] += own · otherᵀ over the
// step's 32 words (128 of d), own rows g, g + 8 of the warp's 16 at `a`,
// other rows 8m + g at `b`, by mma.sync m16n8k32 s8 products, exact in
// int32, kept as the bits of `raw` (the registers that then hold the f32
// logits); the accumulators are laid out as a wgmma m64n64 accumulator's
// share of the warp. Word 8t + s is k-step s's k-word t, 8t + 4 + s its
// k-word t + 4.
__device__ __forceinline__ void logit_step_int8(float (&raw)[32], const float* a,
                                                const float* b) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const unsigned* ar = reinterpret_cast<const unsigned*>(a) + g * kLdStep + 8 * t;
  const unsigned* br = reinterpret_cast<const unsigned*>(b) + g * kLdStep + 8 * t;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // Words read per k-step: all four k-steps' fragments at once crowd the
    // gradient rows' registers.
    const unsigned af[4] = {ar[s], ar[8 * kLdStep + s], ar[4 + s], ar[8 * kLdStep + 4 + s]};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      int d4[4] = {__float_as_int(raw[4 * m]), __float_as_int(raw[4 * m + 1]),
                   __float_as_int(raw[4 * m + 2]), __float_as_int(raw[4 * m + 3])};
      mma_s8(d4, af, br[8 * m * kLdStep + s], br[8 * m * kLdStep + 4 + s]);
#pragma unroll
      for (int e = 0; e < 4; ++e) raw[4 * m + e] = __int_as_float(d4[e]);
    }
  }
}

// The gradient rows of a warp (its accumulator share: columns 8j + 2t,
// 8j + 2t + 1 of rows g and g + 8 for each 8 columns j) into dst's rows
// from row0 and columns from d0, `width` of them: added to what the thread
// wrote there before unless `first`, then times `scale`. The values written
// before come back through `buf` (64 KB of shared memory no wgmma is still
// reading), half of them at a time, by cp.async: the copies need no
// registers, so a half's reads fly at once instead of a few at a time.
// Every thread of the block calls it alike (barriers).
static_assert(2 * (kMaxSlice / 16) * kThreads * sizeof(float2) <= 2 * (size_t)kGradPlane,
              "half of a fold's read-back fits the gradient planes");
__device__ inline void store_rows(const float (&acc)[kMaxSlice / 2], float* dst, float2* buf,
                                  int row0, int n_own, int d, int d0, int width, bool vec,
                                  bool first, float scale) {
  const int gr = threadIdx.x % 32 / 4, tc = threadIdx.x % 4;
  constexpr int kHalf = kMaxSlice / 16;  // column groups j of a half
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!first) {
      __syncthreads();  // buf is free: no wgmma reads it, no thread still reads the last half
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        const int col = 8 * (kHalf * half + jj) + 2 * tc;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + gr + 8 * h;
          if (col >= width || row >= n_own) continue;
          const float* p = dst + (size_t)row * d + d0 + col;
          float2* slot = buf + (2 * jj + h) * kThreads + threadIdx.x;
          if (vec) {
            cp_async8(slot, p, 8);
          } else {
            cp_async4(slot, p, 4);
            if (col + 1 < width) cp_async4(reinterpret_cast<float*>(slot) + 1, p + 1, 4);
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      const int j = kHalf * half + jj, col = 8 * j + 2 * tc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + gr + 8 * h;
        if (col >= width || row >= n_own) continue;
        float* p = dst + (size_t)row * d + d0 + col;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (!first) {
          const float2 old = buf[(2 * jj + h) * kThreads + threadIdx.x];
          v0 += old.x;
          v1 += old.y;
        }
        v0 *= scale;
        v1 *= scale;
        if (vec) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < width) p[1] = v1;
        }
      }
    }
  }
}

// K5 (TXT = false: own = zimg, other = ztxt) and K6 (TXT = true: own = ztxt,
// other = zimg). A block owns 128 rows of `own` from blockIdx.x·128 and
// gradient columns [d0, d0 + slice), d0 = blockIdx.y·slice, and walks split
// blockIdx.z's `split_tiles` 64-row tiles of `other`. With one split it
// writes t·Σ into dout, else Σ into dpart[split] (the caller sums the
// splits), folding its accumulator into those rows every fold_tiles<Q>()
// tiles. K5's blocks of slice 0 also write partials of dt′ and dbias:
// partials[i] and partials[count + i], with i = blockIdx.z·gridDim.x +
// blockIdx.x and count = gridDim.x·gridDim.z.
template <bool TXT, bool Q>
__global__ void __launch_bounds__(kThreads, 1)
sigmoid_loss_bwd_kernel(const Operands op, const float* __restrict__ t_prime,
                        const float* __restrict__ bias, const float* __restrict__ g, int n_own,
                        int n_other, int d, int off, int vec, int split_tiles,
                        float* __restrict__ dout, float* __restrict__ dpart,
                        float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Aligned by an offset, so the compiler still sees shared-memory pointers.
  unsigned char* planes =
      smem_raw + ((1024 - (unsigned)__cvta_generic_to_shared(smem_raw) % 1024) % 1024);
  unsigned char* grad_hi = planes;
  unsigned char* grad_lo = grad_hi + kGradPlane;
  unsigned char* logit_hi = grad_lo + kGradPlane;
  unsigned char* logit_lo = logit_hi + kLogitPlane;
  float* ring = reinterpret_cast<float*>(logit_lo + kLogitPlane);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tc = lane % 4;
  const int slice = bwd_slice(d);
  const int r0 = blockIdx.x * kBwdRows, d0 = blockIdx.y * slice, width = min(slice, d - d0);
  const int row0 = r0 + 16 * warp;  // the warp's first own row
  // The logit product's operands and their 32-bit columns (int8: words).
  const void* own = Q ? static_cast<const void*>(op.own_q) : op.own;
  const void* other = Q ? static_cast<const void*>(op.other_q) : op.other;
  const int cols = Q ? d / 4 : d;
  const bool lvec = Q || vec;
  // The f32 mode's blocks of one row block and split, one a slice, form a
  // cluster (grid.y) and share the logits: member `rank` of `members` sums
  // its share of the logit steps [k0, k0 + lsteps), and the members add
  // their partial sums in rank order. The int8 mode (clusters of one) sums
  // them all.
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int members = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int all_lsteps = ceil_div(cols, kStepCols);
  const int k0 = rank * all_lsteps / members, lsteps = (rank + 1) * all_lsteps / members - k0;
  const int per_tile = lsteps + kBwdTile / kGradRows;
  const int c_begin = blockIdx.z * split_tiles * kBwdTile;
  const int c_end = min(n_other, c_begin + split_tiles * kBwdTile);
  const int tiles = ceil_div(c_end - c_begin, kBwdTile), steps = tiles * per_tile;

  // Step i of the sweep: tile i / per_tile's logit step k = i % per_tile
  // (own's 128 rows and the tile's 64 over 32 columns), or for k ≥ lsteps
  // its gradient step k − lsteps (32 tile rows × 256 slice columns), into
  // stage i % kStages.
  const auto fetch = [&](int i) {
    float* st = ring + (i % kStages) * kStageFloats;
    const int tile = i / per_tile, k = i % per_tile, c0 = c_begin + tile * kBwdTile;
    if (k < lsteps) {
      const int col0 = (k0 + k) * kStepCols;
      load_tile(st, own, r0, kBwdRows, n_own, col0, kStepCols, cols, kLdStep, lvec);
      load_tile(st + kBwdRows * kLdStep, other, c0, kBwdTile, n_other, col0, kStepCols, cols,
                kLdStep, lvec);
    } else {
      load_tile(st, op.other, c0 + (k - lsteps) * kGradRows, kGradRows, n_other, d0, kMaxSlice,
                d, kLdGrad, vec);
    }
  };
  // Step i has landed for every thread, and every thread is done with step
  // i − 1 (its stage and the planes), whose stage step i + kStages − 1 then
  // refills.
  const auto advance = [&](int i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < steps) fetch(i + kStages - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) fetch(i);
    cp_async_commit();
  }

  float acc[kMaxSlice / 2];
#pragma unroll
  for (int n = 0; n < kMaxSlice / 2; ++n) acc[n] = 0.f;
  float s_raw = 0.f, s_dl = 0.f;
  // Where the gradient rows go: t·Σ into dout with one split, else Σ into
  // the split's scratch.
  const bool whole = gridDim.z == 1;
  float* dst = whole ? dout : dpart + (size_t)blockIdx.z * n_own * d;

  // Folds: the accumulator sums at most fold_tiles<Q>() tiles, then the block
  // adds it to its rows. The last fold, after the last tile (a split is
  // never empty), scales by t with one split.
  int i = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    const int c0 = c_begin + tile * kBwdTile;
    // The tile's logits, 16 rows × 64 a warp, in the registers of a
    // wgmma m64n64 accumulator (the int8 mode's mma.sync tiles share its
    // layout): element 4m + e is row g + 8(e / 2), column 8m + 2t + e % 2.
    float dl[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) dl[n] = 0.f;
    if constexpr (Q) {
      for (int k = 0; k < lsteps; ++k, ++i) {
        advance(i);
        const float* st = ring + (i % kStages) * kStageFloats;
        logit_step_int8(dl, st + 16 * warp * kLdStep, st + kBwdRows * kLdStep);
      }
      // Dequantized in JAX's order, the image scale first.
      float own_scale[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + gr + 8 * h;
        own_scale[h] = r < n_own ? __ldg(op.own_s + r) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * m + 2 * tc + (e & 1);
          const float f = __int2float_rn(__float_as_int(dl[4 * m + e])), so = own_scale[e >> 1];
          const float sc = c < n_other ? __ldg(op.other_s + c) : 0.f;
          dl[4 * m + e] = TXT ? __fmul_rn(__fmul_rn(f, sc), so) : __fmul_rn(__fmul_rn(f, so), sc);
        }
    } else {
      for (int k = 0; k < lsteps; ++k, ++i) {
        advance(i);
        const float* st = ring + (i % kStages) * kStageFloats;
        split_logit_plane(logit_hi, logit_lo, st + kBwdRows * kLdStep);
        // The warp's own rows (A), read and split per k-step.
        const float* ar = st + (16 * warp + gr) * kLdStep + 8 * tc;
        fence_proxy_async();
        __syncthreads();  // the planes are written
        // The step's 12 TF32 products are summed in `step`, then added to
        // the logits with IEEE adds.
        float step[32];
#pragma unroll
        for (int n = 0; n < 32; ++n) step[n] = 0.f;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          unsigned ahi[4], alo[4];
          split(ar[s], ahi[0], alo[0]);
          split(ar[8 * kLdStep + s], ahi[1], alo[1]);
          split(ar[4 + s], ahi[2], alo[2]);
          split(ar[8 * kLdStep + 4 + s], ahi[3], alo[3]);
          wgmma_fence();
          wgmma_tf32_n64(step, alo, sw128_desc(logit_hi + 32 * s, 16));
          wgmma_tf32_n64(step, ahi, sw128_desc(logit_lo + 32 * s, 16));
          wgmma_tf32_n64(step, ahi, sw128_desc(logit_hi + 32 * s, 16));
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(step);
          fence_operands(ahi);
          fence_operands(alo);
        }
#pragma unroll
        for (int n = 0; n < 32; ++n) dl[n] += step[n];
      }
    }
    if constexpr (!Q) {
      if (members > 1) {
        // The cluster's partial logits, summed in rank order (every member
        // gets the same sums): each thread's 32 values at stride 256 floats
        // in the grad planes' space, free until this tile's gradient steps.
        float* xch = reinterpret_cast<float*>(grad_hi);
#pragma unroll
        for (int n = 0; n < 32; ++n) xch[n * kThreads + threadIdx.x] = dl[n];
        cluster.sync();
        float sum[32];
#pragma unroll
        for (int n = 0; n < 32; ++n) sum[n] = 0.f;
        for (int r = 0; r < members; ++r) {
          const float* peer = cluster.map_shared_rank(xch, r);
#pragma unroll
          for (int n = 0; n < 32; ++n) sum[n] += peer[n * kThreads + threadIdx.x];
        }
#pragma unroll
        for (int n = 0; n < 32; ++n) dl[n] = sum[n];
        cluster.sync();  // every member has read the partials
      }
    }
    // dl in the same registers: logit_of, the label, the sigmoid; K5's sums.
    const float t = expf(__ldg(t_prime)), bb = __ldg(bias), gg = __ldg(g);
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Every element is computed, then masked: no branch in the loop.
        const int r = row0 + gr + 8 * (e >> 1), c = c0 + 8 * m + 2 * tc + (e & 1);
        const float rv = dl[4 * m + e];
        const bool pos = TXT ? r == c + off : c == r + off;
        const float label = pos ? 1.f : -1.f;
        const float x = label * logit_of(rv, t, bb);
        const float v = r < n_own && c < n_other ? gg * (-label * sigmoid(-x)) : 0.f;
        if (!TXT) {
          s_raw += v * rv;
          s_dl += v;
        }
        dl[4 * m + e] = v;
      }
    // The gradient product over the tile's two 32-row halves: k-step j's A
    // fragment is accumulator chunk j, (g, 2t), (g + 8, 2t), (g, 2t + 1),
    // (g + 8, 2t + 1), split.
#pragma unroll
    for (int half = 0; half < kBwdTile / kGradRows; ++half, ++i) {
      advance(i);
      split_grad_plane(grad_hi, grad_lo, ring + (i % kStages) * kStageFloats);
      fence_proxy_async();
      __syncthreads();  // the planes are written
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = 4 * half + s;
        unsigned ahi[4], alo[4];
        split(dl[4 * j], ahi[0], alo[0]);
        split(dl[4 * j + 2], ahi[1], alo[1]);
        split(dl[4 * j + 1], ahi[2], alo[2]);
        split(dl[4 * j + 3], ahi[3], alo[3]);
        wgmma_fence();
        wgmma_tf32_n256(acc, alo, sw128_desc(grad_hi + 32 * s, 16));
        wgmma_tf32_n256(acc, ahi, sw128_desc(grad_lo + 32 * s, 16));
        wgmma_tf32_n256(acc, ahi, sw128_desc(grad_hi + 32 * s, 16));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
        fence_operands(ahi);
        fence_operands(alo);
      }
    }
    if ((tile + 1) % fold_tiles<Q>() == 0 || tile + 1 == tiles) {
      // A fold: the accumulator's sums added to the block's rows in IEEE
      // f32 (each thread rereads only what it wrote); it starts again at 0.
      const float scale = tile + 1 == tiles && whole ? expf(__ldg(t_prime)) : 1.f;
      // The rows' addresses and bounds are formed here, not hoisted out of
      // the sweep, where they would crowd the registers.
      float* out = dst;
      int rows = n_own, cols = width;
      asm volatile("" : "+l"(out), "+r"(rows), "+r"(cols));
      // The gradient planes are free until the next tile's gradient step.
      store_rows(acc, out, reinterpret_cast<float2*>(grad_hi), row0, rows, d, d0, cols, vec,
                 tile < fold_tiles<Q>(), scale);
#pragma unroll
      for (int n = 0; n < kMaxSlice / 2; ++n) acc[n] = 0.f;
    }
  }

  if (!TXT && blockIdx.y == 0) {
    // `red` aliases the ring, unused from here on.
    const float t = expf(__ldg(t_prime));
    const int count = gridDim.x * gridDim.z, idx = blockIdx.z * gridDim.x + blockIdx.x;
    const float sr = block_sum(s_raw, ring);
    if (threadIdx.x == 0) partials[idx] = sr * t;
    const float sd = block_sum(s_dl, ring);
    if (threadIdx.x == 0) partials[count + idx] = sd;
  }
}

// ---- K4: the logits on the tensor cores (split f32, or int8), a persistent
// walk over 128 × 128 tiles --------------------------------------------------

constexpr int kFwdRows = 128;                   // zimg rows of a tile, 64 a warpgroup
constexpr int kFwdCols = 128;                   // ztxt rows of a tile
constexpr int kFwdPlane = kFwdCols * 128;       // bytes of one TF32 plane of a step's B
// A step in a stage: the tile's zimg rows, then its ztxt rows. f32: 32
// columns at stride kLdStep; int8: 32 words (128 values), 128-byte rows
// swizzled as the wgmma operands they are.
constexpr int kFwdStageFloats = (kFwdRows + kFwdCols) * kLdStep;
constexpr int kFwdStageInt8 = (kFwdRows + kFwdCols) * 128;
static_assert(kFwdRows == kFwdCols && kFwdRows * 8 % kThreads == 0,
              "a step's 16-byte chunks of either operand split evenly over the block");

// Stages of K4's ring and its resident blocks a SM. The f32 mode's planes
// and four stages fill an SM's shared memory, and its accumulators its
// registers (one block); the int8 mode takes three stages and two blocks
// (at most 128 registers a thread), so one block's epilogue runs beside the
// other's copies and products.
__host__ __device__ constexpr int fwd_stages(bool q) { return q ? 3 : 4; }
__host__ __device__ constexpr int fwd_blocks(bool q) { return q ? 2 : 1; }

// f32: two sets of B's hi and lo planes, used in turn, then the ring; int8:
// the ring. 1 KB of slack aligns the planes and stages to 1,024 bytes.
__host__ __device__ constexpr size_t fwd_smem_bytes(bool q) {
  return 1024 + (q ? (size_t)fwd_stages(q) * kFwdStageInt8
                   : 4 * (size_t)kFwdPlane +
                         (size_t)fwd_stages(q) * kFwdStageFloats * sizeof(float));
}

__host__ __device__ inline long long fwd_tiles(int b, int n) {
  return (long long)ceil_div(b, kFwdRows) * ceil_div(n, kFwdCols);
}

// Rows [row0, row0 + 128) and columns [col0, col0 + 32) of a row-major
// (nrows × total) f32 matrix into dst at row stride kLdStep, zero outside
// it: 16 bytes a copy with VEC (total % 4 == 0, a 16-byte aligned base),
// else 4. Straight-line code: K4 issues it while its products run. The
// caller commits.
template <bool VEC>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int row0, int nrows,
                                              int col0, int total) {
  constexpr int kPer = VEC ? 8 : 32;  // copies a row
#pragma unroll
  for (int k = 0; k < kFwdRows * kPer / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / kPer, c = (32 / kPer) * (i % kPer);
    const int row = row0 + r, col = col0 + c;
    const bool in = row < nrows && col < total;
    const float* from = in ? src + (size_t)row * total + col : src;
    if constexpr (VEC) cp_async16(dst + r * kLdStep + c, from, in ? 16 : 0);
    else cp_async4(dst + r * kLdStep + c, from, in ? 4 : 0);
  }
}

// Rows [row0, row0 + 128) and words [col0, col0 + 32) of a row-major (nrows ×
// total) int8 matrix (four values a word, total % 4 == 0, 16-byte aligned)
// into a 128-byte-swizzled K-major tile at dst, zero outside it. The caller
// commits.
__device__ inline void load_rows_int8(unsigned char* dst, const int* src, int row0, int nrows,
                                      int col0, int total) {
#pragma unroll
  for (int k = 0; k < kFwdRows * 8 / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / 8, c = i % 8;
    const int row = row0 + r, col = col0 + 4 * c;
    const bool in = row < nrows && col < total;
    cp_async16(dst + sw128(r, c), in ? src + (size_t)row * total + col : src, in ? 16 : 0);
  }
}

// K4: partials[tile] = Σ softplus(−label·logit) over the tile's logits. Block
// x walks tiles x, x + gridDim.x, …; tile t is row block t % (row blocks)
// and column block t / (row blocks) when zimg has no more row blocks than
// ztxt (so concurrent tiles share zimg, which stays in L2), else the other
// way round. VEC: the f32 rows are copied 16 bytes at a time (the int8
// mode's always are).
template <bool Q, bool VEC>
__global__ void __launch_bounds__(kThreads, Q ? 2 : 1)
sigmoid_loss_fwd_kernel(const Operands op, const float* __restrict__ t_prime,
                        const float* __restrict__ bias, int b, int n, int d, int off,
                        float* __restrict__ partials) {
  static_assert(fwd_blocks(Q) == (Q ? 2 : 1), "the launch bounds' blocks a SM");
  constexpr int kS = fwd_stages(Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kThreads / 32];
  // Aligned by an offset, so the compiler still sees shared-memory pointers.
  unsigned char* base =
      smem_raw + ((1024 - (unsigned)__cvta_generic_to_shared(smem_raw) % 1024) % 1024);
  unsigned char* planes = base;  // f32: [set][hi, lo]
  unsigned char* ring = Q ? base : base + 4 * kFwdPlane;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tc = lane % 4;
  const int tiles_r = ceil_div(b, kFwdRows), tiles_c = ceil_div(n, kFwdCols);
  const int tiles = tiles_r * tiles_c;
  const bool rows_fast = tiles_r <= tiles_c;
  const int cols = Q ? d / 4 : d;  // 32-bit columns of the product's operands
  const int ksteps = ceil_div(cols, kStepCols);
  const int my_tiles = ceil_div(tiles - (int)blockIdx.x, gridDim.x);
  const int steps = my_tiles * ksteps;
  const auto origin = [&](int j, int& r0, int& c0) {
    const int tile = blockIdx.x + j * gridDim.x;
    r0 = (rows_fast ? tile % tiles_r : tile / tiles_c) * kFwdRows;
    c0 = (rows_fast ? tile / tiles_r : tile % tiles_c) * kFwdCols;
  };

  // Step i: the block's tile i / ksteps, columns of step i % ksteps, into
  // stage i % kS. Past the block's last step it copies rows of tiles that
  // are not the block's (in bounds, or zero-filled) into a free stage: the
  // copies stay unconditional, so no branch lies in the products' way.
  const auto fetch = [&](int i) {
    int r0, c0;
    origin(i / ksteps, r0, c0);
    const int col0 = (i % ksteps) * kStepCols;
    if constexpr (Q) {
      unsigned char* st = ring + (i % kS) * kFwdStageInt8;
      load_rows_int8(st, op.own_q, r0, b, col0, cols);
      load_rows_int8(st + kFwdRows * 128, op.other_q, c0, n, col0, cols);
    } else {
      float* st = reinterpret_cast<float*>(ring) + (i % kS) * kFwdStageFloats;
      load_rows_f32<VEC>(st, op.own, r0, b, col0, d);
      load_rows_f32<VEC>(st + kFwdRows * kLdStep, op.other, c0, n, col0, d);
    }
  };
  // f32: step i's B (the stage's ztxt rows) into plane set i % 2.
  const auto split_b = [&](int i) {
    const float* x =
        reinterpret_cast<const float*>(ring) + (i % kS) * kFwdStageFloats + kFwdRows * kLdStep;
    unsigned char* hi = planes + (i % 2) * 2 * kFwdPlane;
#pragma unroll
    for (int k = 0; k < kFwdCols * 8 / kThreads; ++k)
      split_logit_chunk(hi, hi + kFwdPlane, x, threadIdx.x + k * kThreads);
    fence_proxy_async();
  };
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (i < steps) fetch(i);
    cp_async_commit();
  }
  if constexpr (!Q) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    split_b(0);
  }

  const float t = expf(__ldg(t_prime)), bb = __ldg(bias);
  // The accumulators: a step's products (f32) or the tile's int32 sums
  // (int8). Each step's first product overwrites them.
  float step[64];
  int acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    step[e] = 0.f;
    acc[e] = 0;
  }
  int i = 0;
  for (int j = 0; j < my_tiles; ++j) {
    int r0, c0;
    origin(j, r0, c0);
    // The tile's raw logits (int8: their int32 sums in `acc`), 16 rows × 128
    // a warp, in the layout of a wgmma m64n128 accumulator: element 4m + e
    // is row g + 8(e / 2), column 8m + 2t + e % 2.
    float raw[64], so[2];
    if constexpr (Q) {
      for (int k = 0; k < ksteps; ++k, ++i) {
        // Step i has landed for every thread (and is visible to the tensor
        // cores), and every warpgroup is done with step i − 1, whose stage
        // step i + kS − 1 refills while step i's products run.
        cp_async_wait<kS - 2>();
        fence_proxy_async();
        __syncthreads();
        const unsigned char* st = ring + (i % kS) * kFwdStageInt8;
        const unsigned char* a = st + (warp / 4) * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_s8_n128(acc, sw128_desc(a + 32 * s, 16),
                        sw128_desc(st + kFwdRows * 128 + 32 * s, 16), k > 0 || s > 0);
        wgmma_commit();
        fetch(i + kS - 1);
        cp_async_commit();
        wgmma_wait<0>();
        fence_operands(acc);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * warp + gr + 8 * h;
        so[h] = r < b ? __ldg(op.own_s + r) : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) raw[e] = 0.f;
      for (int k = 0; k < ksteps; ++k, ++i) {
        // Step i + 1 has landed for every thread, step i's B planes are
        // written, and every warpgroup is done with step i − 1 (its stage,
        // which step i + kS − 1 refills while step i's products run, and its
        // plane set, which step i + 1's B then takes).
        cp_async_wait<kS - 3>();
        __syncthreads();
        // The warp's 16 zimg rows (A), split in registers: row g's columns
        // 8t..8t + 3 are k = t of k-steps 0..3 and 8t + 4..8t + 7 their
        // k = t + 4; the same for row g + 8.
        const float* ar = reinterpret_cast<const float*>(ring) + (i % kS) * kFwdStageFloats +
                          (16 * warp + gr) * kLdStep + 8 * tc;
        const float4 g0 = *reinterpret_cast<const float4*>(ar);
        const float4 g4 = *reinterpret_cast<const float4*>(ar + 4);
        const float4 h0 = *reinterpret_cast<const float4*>(ar + 8 * kLdStep);
        const float4 h4 = *reinterpret_cast<const float4*>(ar + 8 * kLdStep + 4);
        const float x[4][4] = {{g0.x, h0.x, g4.x, h4.x}, {g0.y, h0.y, g4.y, h4.y},
                               {g0.z, h0.z, g4.z, h4.z}, {g0.w, h0.w, g4.w, h4.w}};
        unsigned ahi[4][4], alo[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int f = 0; f < 4; ++f) split(x[s][f], ahi[s][f], alo[s][f]);
        // The step's 12 TF32 products, summed in `step` (the first
        // overwrites it), then added to the logits with IEEE adds.
        const unsigned char* bhi = planes + (i % 2) * 2 * kFwdPlane;
        const unsigned char* blo = bhi + kFwdPlane;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          wgmma_tf32_n128(step, alo[s], sw128_desc(bhi + 32 * s, 16), s);
          wgmma_tf32_n128(step, ahi[s], sw128_desc(blo + 32 * s, 16), 1);
          wgmma_tf32_n128(step, ahi[s], sw128_desc(bhi + 32 * s, 16), 1);
        }
        wgmma_commit();
        // While they run: step i + kS − 1's copies, and step i + 1's B into
        // the other plane set (after the block's last step, a stale stage
        // into planes nobody reads).
        fetch(i + kS - 1);
        cp_async_commit();
        split_b(i + 1);
        wgmma_wait<0>();
        fence_operands(step);
        fence_operands(ahi);
        fence_operands(alo);
#pragma unroll
        for (int e = 0; e < 64; ++e) raw[e] += step[e];
      }
    }
    // The epilogue, in registers: (int8: dequantize, in JAX's order, the
    // image scale first, element by element, so no second array of 64
    // lives beside the sums) logit_of, the label, softplus, masked.
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < 16; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * warp + gr + 8 * (e >> 1), c = c0 + 8 * m + 2 * tc + (e & 1);
        float x;
        if constexpr (Q) {
          const float sc = c < n ? __ldg(op.other_s + c) : 0.f;
          x = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * m + e]), so[e >> 1]), sc);
        } else {
          x = raw[4 * m + e];
        }
        const float label = c == r + off ? 1.f : -1.f;
        const float v = softplus(-label * logit_of(x, t, bb));
        sum += r < b && c < n ? v : 0.f;
      }
    const float s = block_sum(sum, red);
    if (threadIdx.x == 0) partials[blockIdx.x + j * gridDim.x] = s;
  }
}

// dout[i] = t · Σ_s dpart[s·count + i], the splits summed in order.
__global__ void __launch_bounds__(kReduceThreads)
sigmoid_loss_sum_splits_kernel(const float* __restrict__ dpart, int splits, size_t count,
                               const float* __restrict__ t_prime, float* __restrict__ dout) {
  const float t = expf(__ldg(t_prime));
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += dpart[k * count + i];
    dout[i] = s * t;
  }
}

// out[v] = Σ_i partials[v·count + i], summed in a fixed order; one block per v.
__global__ void __launch_bounds__(kReduceThreads)
sigmoid_loss_reduce_kernel(const float* __restrict__ partials, int count, float* __restrict__ out) {
  __shared__ float red[kReduceThreads / 32];
  const float* p = partials + (size_t)blockIdx.x * count;
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) s += p[i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

bool bad_shape(int b, int n, int d) {
  return b < 1 || n < 1 || d < 1 || fwd_tiles(b, n) > 0x7FFFFFFF || bwd_slices(d) > 65535;
}

// Resident K5/K6 blocks on the current device: the f32 kernel's clusters
// at width d (bwd_cluster) that fit at once, times their blocks.
long long bwd_slots(int d) {
  const int members = bwd_cluster(d, false);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1, members, 1);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bwd_smem_bytes();
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = members;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  int clusters = 0;
  if (configure(sigmoid_loss_bwd_kernel<false, false>, bwd_smem_bytes()) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, sigmoid_loss_bwd_kernel<false, false>, &config) !=
          cudaSuccess)
    clusters = 1;
  return (long long)(clusters > 0 ? clusters : 1) * members;
}

// Splits of the other operand's tiles over grid.z: of the counts that fill
// at most kMaxSplitWaves resident waves of blocks (at least one split), the
// one with the fewest waves × tiles per split, the fewest splits on a tie,
// no split empty. Returns the tiles per split through `split_tiles`. Both
// modes take the f32 kernel's residency, so a call's scratch size does not
// depend on the mode.
int bwd_splits(int n_own, int n_other, int d, int* split_tiles) {
  const int tiles = ceil_div(n_other, kBwdTile);
  const long long slots = bwd_slots(d);
  const long long blocks = (long long)ceil_div(n_own, kBwdRows) * bwd_slices(d);
  const long long most = (kMaxSplitWaves * slots + blocks - 1) / blocks;
  long long best = -1;
  int splits = 1;
  *split_tiles = tiles;
  for (int s = 1; s <= most && s <= tiles && s <= 65535; ++s) {
    const int per = ceil_div(tiles, s);
    if (ceil_div(tiles, per) != s) continue;  // the same split as a smaller s
    const long long cost = (blocks * s + slots - 1) / slots * per;
    if (best < 0 || cost < best) {
      best = cost;
      splits = s;
      *split_tiles = per;
    }
  }
  return splits;
}

// `splits` and `split_tiles`: bwd_splits(n_own, n_other, d).
template <bool TXT, bool Q>
cudaError_t launch_bwd(const Operands& op, const float* t_prime, const float* bias,
                       const float* g, int n_own, int n_other, int d, int off, int vec,
                       int splits, int split_tiles, float* dout, float* scratch,
                       cudaStream_t stream) {
  cudaError_t err = configure(sigmoid_loss_bwd_kernel<TXT, Q>, bwd_smem_bytes());
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(n_own, kBwdRows), bwd_slices(d), splits);
  // Scratch: the splits' partial gradients (when more than one), then K5's
  // partials of dt′ and dbias.
  const size_t count = (size_t)n_own * d;
  float* dpart = splits > 1 ? scratch : nullptr;
  float* partials = scratch + (splits > 1 ? (size_t)splits * count : 0);
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bwd_smem_bytes();
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = bwd_cluster(d, Q);
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, sigmoid_loss_bwd_kernel<TXT, Q>, op, t_prime, bias, g, n_own,
                           n_other, d, off, vec, split_tiles, dout, dpart, partials);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks = (int)((count + kReduceThreads - 1) / kReduceThreads);
  sigmoid_loss_sum_splits_kernel<<<blocks < 65535 ? blocks : 65535, kReduceThreads, 0, stream>>>(
      dpart, splits, count, t_prime, dout);
  return cudaGetLastError();
}

// K4's persistent grid: fwd_blocks(Q) blocks a SM, at most one a tile; then
// the partials summed in tile order.
template <bool Q>
int launch_fwd(const Operands& op, const void* t_prime, const void* bias, int b, int n, int d,
               int off, int vec, void* partials, void* out, void* stream) {
  if (bad_shape(b, n, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = Q ? sigmoid_loss_fwd_kernel<true, true>
                       : vec ? sigmoid_loss_fwd_kernel<false, true>
                             : sigmoid_loss_fwd_kernel<false, false>;
  cudaError_t err = configure(kernel, fwd_smem_bytes(Q));
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (int)fwd_tiles(b, n), slots = sms * fwd_blocks(Q);
  kernel<<<tiles < slots ? tiles : slots, kThreads, fwd_smem_bytes(Q), st>>>(
      op, static_cast<const float*>(t_prime), static_cast<const float*>(bias), b, n, d, off,
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sigmoid_loss_reduce_kernel<<<1, kReduceThreads, 0, st>>>(static_cast<const float*>(partials),
                                                            tiles, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <bool Q>
int launch_bwd_img(const Operands& op, const void* t_prime, const void* bias, const void* g,
                   int b, int n, int d, int off, int vec, void* dzimg, void* scratch, void* out2,
                   void* stream) {
  if (bad_shape(b, n, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  int split_tiles = 0;
  const int splits = bwd_splits(b, n, d, &split_tiles);
  cudaError_t err = launch_bwd<false, Q>(
      op, static_cast<const float*>(t_prime), static_cast<const float*>(bias),
      static_cast<const float*>(g), b, n, d, off, vec, splits, split_tiles,
      static_cast<float*>(dzimg), sc, st);
  if (err != cudaSuccess) return (int)err;
  const float* partials = sc + (splits > 1 ? (size_t)splits * b * d : 0);
  sigmoid_loss_reduce_kernel<<<2, kReduceThreads, 0, st>>>(
      partials, ceil_div(b, kBwdRows) * splits, static_cast<float*>(out2));
  return (int)cudaGetLastError();
}

template <bool Q>
int launch_bwd_txt(const Operands& op, const void* t_prime, const void* bias, const void* g,
                   int b, int n, int d, int off, int vec, void* dztxt, void* scratch,
                   void* stream) {
  if (bad_shape(n, b, d)) return (int)cudaErrorInvalidValue;
  int split_tiles = 0;
  const int splits = bwd_splits(n, b, d, &split_tiles);
  return (int)launch_bwd<true, Q>(
      op, static_cast<const float*>(t_prime), static_cast<const float*>(bias),
      static_cast<const float*>(g), n, b, d, off, vec, splits, split_tiles,
      static_cast<float*>(dztxt), static_cast<float*>(scratch),
      static_cast<cudaStream_t>(stream));
}

Operands f32_operands(const void* own, const void* other) {
  return Operands{static_cast<const float*>(own), static_cast<const float*>(other), nullptr,
                  nullptr, nullptr, nullptr};
}

// own_q/own_s and other_q/other_s: the int8 rows and scales of the logit
// product; other: the f32 rows of K5/K6's gradient product (null for K4).
Operands int8_operands(const void* own_q, const void* own_s, const void* other_q,
                       const void* other_s, const void* other) {
  return Operands{nullptr, static_cast<const float*>(other), static_cast<const int*>(own_q),
                  static_cast<const int*>(other_q), static_cast<const float*>(own_s),
                  static_cast<const float*>(other_s)};
}

bool bad_int8(int d, const void* a, const void* b) {
  return d % 16 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(b) % 16 != 0;
}

}  // namespace

extern "C" {

// Partials K4 writes, one a 128 × 128 tile (mirrored in
// ops/streaming_sigmoid_loss.py).
long long sigmoid_loss_fwd_partials(int b, int n) { return fwd_tiles(b, n); }

// Dynamic shared memory of one K4 block in the f32 (q = 0) or int8 (q = 1)
// mode, bytes.
long long sigmoid_loss_fwd_smem_bytes(int q) { return (long long)fwd_smem_bytes(q != 0); }

// Scratch floats of a K5 (img = 1) or K6 (img = 0) call on the current
// device: the splits' partial gradients when the text (K6: image) tiles are
// split over several blocks, then K5's partials of dt′ and dbias. The same
// in both modes.
long long sigmoid_loss_bwd_scratch_floats(int n_own, int n_other, int d, int img) {
  if (n_own < 1 || n_other < 1 || d < 1) return 0;
  int split_tiles = 0;
  const int splits = bwd_splits(n_own, n_other, d, &split_tiles);
  long long floats = splits > 1 ? (long long)splits * n_own * d : 0;
  if (img) floats += 2LL * ceil_div(n_own, kBwdRows) * splits;
  return floats;
}

// Splits of the other operand's tiles a K5/K6 call uses on the current device.
int sigmoid_loss_bwd_splits(int n_own, int n_other, int d) {
  if (n_own < 1 || n_other < 1 || d < 1) return 0;
  int split_tiles = 0;
  return bwd_splits(n_own, n_other, d, &split_tiles);
}

// Dynamic shared memory of one K5/K6 block at width d, bytes.
long long sigmoid_loss_bwd_smem_bytes(int d) {
  return d < 1 ? 0 : (long long)bwd_smem_bytes();
}

// K4: zimg (b, d), ztxt (n, d) f32 contiguous; t_prime, bias: one f32 each on
// the device; partials: sigmoid_loss_fwd_partials(b, n) f32 scratch; out: one
// f32, the block's loss sum. Returns the cudaError_t of the launches (0 on
// success); they do not synchronise.
int sigmoid_loss_fwd(const void* zimg, const void* ztxt, const void* t_prime, const void* bias,
                     int b, int n, int d, int off, int vec, void* partials, void* out,
                     void* stream) {
  return launch_fwd<false>(f32_operands(zimg, ztxt), t_prime, bias, b, n, d, off, vec, partials,
                           out, stream);
}

// K5: dzimg (b, d) f32; g: the upstream gradient, one f32 on the device;
// scratch: sigmoid_loss_bwd_scratch_floats(b, n, d, 1) f32; out2: two f32,
// (dt′, dbias).
int sigmoid_loss_bwd_img(const void* zimg, const void* ztxt, const void* t_prime,
                         const void* bias, const void* g, int b, int n, int d, int off, int vec,
                         void* dzimg, void* scratch, void* out2, void* stream) {
  return launch_bwd_img<false>(f32_operands(zimg, ztxt), t_prime, bias, g, b, n, d, off, vec,
                               dzimg, scratch, out2, stream);
}

// K6: dztxt (n, d) f32; scratch: sigmoid_loss_bwd_scratch_floats(n, b, d, 0) f32.
int sigmoid_loss_bwd_txt(const void* zimg, const void* ztxt, const void* t_prime,
                         const void* bias, const void* g, int b, int n, int d, int off, int vec,
                         void* dztxt, void* scratch, void* stream) {
  return launch_bwd_txt<false>(f32_operands(ztxt, zimg), t_prime, bias, g, b, n, d, off, vec,
                               dztxt, scratch, stream);
}

// The int8 mode of K4, K5 and K6. ziq (b, d) and ztq (n, d) int8 and zis (b),
// zts (n) f32 scales, contiguous, d % 16 == 0, 16-byte aligned int8 rows;
// K5 also takes the f32 text rows ztxt (n, d) and K6 the f32 image rows zimg
// (b, d) of its gradient product. Outputs, scratch and errors as in the f32
// mode (cudaErrorInvalidValue for a d or alignment the mode does not take).
int sigmoid_loss_fwd_int8(const void* ziq, const void* zis, const void* ztq, const void* zts,
                          const void* t_prime, const void* bias, int b, int n, int d, int off,
                          void* partials, void* out, void* stream) {
  if (bad_int8(d, ziq, ztq)) return (int)cudaErrorInvalidValue;
  return launch_fwd<true>(int8_operands(ziq, zis, ztq, zts, nullptr), t_prime, bias, b, n, d,
                          off, 1, partials, out, stream);
}

int sigmoid_loss_bwd_img_int8(const void* ziq, const void* zis, const void* ztq, const void* zts,
                              const void* ztxt, const void* t_prime, const void* bias,
                              const void* g, int b, int n, int d, int off, int vec, void* dzimg,
                              void* scratch, void* out2, void* stream) {
  if (bad_int8(d, ziq, ztq)) return (int)cudaErrorInvalidValue;
  return launch_bwd_img<true>(int8_operands(ziq, zis, ztq, zts, ztxt), t_prime, bias, g, b, n,
                              d, off, vec, dzimg, scratch, out2, stream);
}

int sigmoid_loss_bwd_txt_int8(const void* ziq, const void* zis, const void* ztq, const void* zts,
                              const void* zimg, const void* t_prime, const void* bias,
                              const void* g, int b, int n, int d, int off, int vec, void* dztxt,
                              void* scratch, void* stream) {
  if (bad_int8(d, ziq, ztq)) return (int)cudaErrorInvalidValue;
  return launch_bwd_txt<true>(int8_operands(ztq, zts, ziq, zis, zimg), t_prime, bias, g, b, n,
                              d, off, vec, dztxt, scratch, stream);
}

// Resident blocks per SM of K4 (which = 0; its int8 mode, which = 2) or
// K5/K6 (which = 1) at width d (0 with an error), for the records.
int sigmoid_loss_occupancy(int d, int which) {
  if (d < 1) return 0;
  int blocks = 0;
  cudaError_t err;
  if (which == 0 || which == 2) {
    const bool q = which == 2;
    const auto kernel =
        q ? sigmoid_loss_fwd_kernel<true, true> : sigmoid_loss_fwd_kernel<false, true>;
    err = configure(kernel, fwd_smem_bytes(q));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                          fwd_smem_bytes(q));
  } else {
    err = configure(sigmoid_loss_bwd_kernel<false, false>, bwd_smem_bytes());
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sigmoid_loss_bwd_kernel<false, false>, kThreads, bwd_smem_bytes());
  }
  return err == cudaSuccess ? blocks : 0;
}

const char* sigmoid_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
