// f32 self-attention for Hopper (sm_90a): a forward on the CUDA cores and a
// two-pass backward (a di pass with dK/dV, then dQ) whose products run on the
// tensor cores in split f32 (3xTF32).
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
// Bound on this card: operations. At ViT-B/16 vision in f32 (b=128, s=196,
// h=12, dh=64) one s²·dh product is 2·128·12·196²·64 = 7.55 GFLOP against
// 4·128·196·768·4 B = 308 MB (92 µs at 3.35 TB/s) for four tensors.
//
// The forward: every product an IEEE f32 FMA on the CUDA cores, expf the
// precise one; its two products take 225 µs at the 67 TFLOP/s f32 peak. A
// block of 256 threads owns 64 query rows of one (batch row, head) and walks
// the 64-row key tiles, so shared memory stays O(64·dh) whatever s is. Every
// tile sits in shared memory transposed, column-major at a row stride of 65
// floats, so the loads from device memory and both reads of a product are
// free of bank conflicts; a thread computes a 4 × 4 patch of a 64 × 64 logit
// tile and a 4 × dh/16 patch of the output, and keeps the online-softmax
// state (m, l, the output rows) in registers.
//
// The backward: split-f32 products on the tensor cores. Each f32 operand x
// is split into hi = tf32(x) and lo = tf32(x − hi), both rounded as
// cvt.rna.tf32.f32 rounds (nearest, ties away; done on the integer bits,
// bitwise the same and cheaper), and every mma.sync m16n8k8 TF32 step adds
// lo·hi, hi·lo, then hi·hi into an f32 accumulator (the small terms first;
// the split, the step and the cp.async copies are in split_f32.cuh, shared
// with sigmoid_loss.cu). What is dropped, lo·lo and the rounding of lo, is about 2^-22 of each
// term; on the card the outputs stay within ~1.5e-5 of the largest magnitude
// of the f32 plain version at s = 1,024 (the tensor cores' own accumulation
// adds to it), inside the 1e-4 contract. Plain TF32 (hi·hi alone) keeps
// about three digits, ~8e-4 here, and would not hold. (This is the fast-f32
// scheme of PyTorch's memory-efficient attention, its f32 yardstick on this
// card.) Bound: the three TF32 products of each of the four (dK/dV: x, dp,
// dv, dk) or three (dQ: x, dp, dq) s²·dh products at the 495 TFLOP/s TF32
// peak, 0.183 and 0.137 ms at B/16 vision; on the CUDA cores they would take
// 0.451 and 0.338.
//
// Design of the two backward kernels. A block of 128 threads (4 warps) owns
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

#include "split_f32.cuh"

using namespace split_f32;

namespace {

constexpr int kThreads = 256;  // 16 × 16
constexpr int kTile = 64;      // rows of a tile
constexpr int kLd = kTile + 1; // shared row stride of a transposed tile, floats
constexpr int kMaxHeadDim = 128;

__host__ __device__ inline int ceil_div(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ inline int round16(int x) { return ceil_div(x, 16) * 16; }

// Floats of one transposed tile: round16(dh) columns (zero past dh) of kLd.
__host__ __device__ inline int tile_floats(int dh) { return round16(dh) * kLd; }

__host__ __device__ inline size_t fwd_smem_bytes(int dh) {
  return (size_t)(3 * tile_floats(dh) + kTile * kLd) * sizeof(float);
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

// Rows [row0, row0 + 64) of one head's (s, dh) slice (rows at stride
// `width`) into dst[c·kLd + r], zero past s and for c in [dh, round16(dh)).
__device__ inline void load_t(float* dst, const float* __restrict__ src, int row0, int s,
                              int width, int dh) {
  const int dh16 = round16(dh);
  for (int i = threadIdx.x; i < kTile * dh16; i += kThreads) {
    const int r = i / dh16, c = i % dh16, row = row0 + r;
    dst[c * kLd + r] = (row < s && c < dh) ? __ldg(src + (size_t)row * width + c) : 0.f;
  }
}

// c[i][j] = Σ_{k<kd} a[k·kLd + ty + 16i] · b[k·kLd + tx + 16j]: a 64 × 64
// product over kd of two transposed tiles.
__device__ inline void tile_tt(float (&c)[4][4], const float* a, const float* b, int kd) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  for (int k = 0; k < kd; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[k * kLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// o[i][j] += Σ_{k<64} x[k·kLd + ty + 16i] · y[(tx + 16j)·kLd + k]: a 64-row
// tile x (transposed, k-major) times the transposed 64 × dh tile y.
template <int NC>
__device__ inline void tile_acc(float (&o)[4][NC], const float* x, const float* y) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float xv[4], yv[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = x[k * kLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NC; ++j) yv[j] = y[(tx + 16 * j) * kLd + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) o[i][j] = fmaf(xv[i], yv[j], o[i][j]);
  }
}

// Half-warp (16 lanes: one ty) reductions of a row's values.
__device__ inline float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Write o[i][j] (scaled by mul[i]) as rows row0 + ty + 16i < s, columns
// tx + 16j < dh of one head's slice.
template <int NC>
__device__ inline void store_rows(float* __restrict__ dst, const float (&o)[4][NC],
                                  const float (&mul)[4], int row0, int s, int width, int dh) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) dst[(size_t)row * width + col] = o[i][j] * mul[i];
    }
  }
}

// Forward: grid (query tiles, heads, b). out = softmax(x)·v; stats (b, h, 2,
// s) = (m, l) when not null.
template <int NC>
__global__ void __launch_bounds__(kThreads)
attention_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ stats, int s, int heads, int dh, float scale,
                         int causal) {
  extern __shared__ float smem[];
  const int tf = tile_floats(dh);
  float* qt = smem;
  float* kt = qt + tf;
  float* vt = kt + tf;
  float* pt = vt + tf;  // p[key][query]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int width = heads * dh, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  load_t(qt, q + slab, q0, s, width, dh);

  float o[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[i][j] = 0.f;
  }
  const int last = causal ? min(s, q0 + kTile) : s;
  for (int k0 = 0; k0 < last; k0 += kTile) {
    __syncthreads();  // the previous tile's products are done with kt, vt, pt
    load_t(kt, k + slab, k0, s, width, dh);
    load_t(vt, v + slab, k0, s, width, dh);
    __syncthreads();
    float x[4][4];
    tile_tt(x, qt, kt, dh);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = key < s && (!causal || key <= row);
        x[i][j] = live ? x[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, x[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = expf(x[i][j] - m_use);
        sum += x[i][j];
        pt[(tx + 16 * j) * kLd + ty + 16 * i] = x[i][j];
      }
      alpha[i] = expf(m[i] - m_use);
      l[i] = l[i] * alpha[i] + row_sum(sum);
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) o[i][j] *= alpha[i];
    __syncthreads();
    tile_acc<NC>(o, pt, vt);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  store_rows<NC>(out + slab, o, inv, q0, s, width, dh);
  if (stats != nullptr && tx == 0) {
    float* st = stats + ((size_t)b * heads + h) * 2 * s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < s) {
        st[row] = m[i];
        st[s + row] = l[i];
      }
    }
  }
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
    split(ar[8 * kc], ahi[0], alo[0]);
    split(ar[8 * kLdb + 8 * kc], ahi[1], alo[1]);
    split(ar[8 * kc + 4], ahi[2], alo[2]);
    split(ar[8 * kLdb + 8 * kc + 4], ahi[3], alo[3]);
    unsigned bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      split(br[8 * n * kLdb + 8 * kc], bh[n][0], bl[n][0]);
      split(br[8 * n * kLdb + 8 * kc + 4], bh[n][1], bl[n][1]);
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
    split(p[kc][0], ahi[0], alo[0]);
    split(p[kc][2], ahi[1], alo[1]);
    split(p[kc][1], ahi[2], alo[2]);
    split(p[kc][3], ahi[3], alo[3]);
    unsigned bh[2 * KC][2], bl[2 * KC][2];
#pragma unroll
    for (int n = 0; n < 2 * KC; ++n) {
      split(br[8 * kc * kLdb + 8 * n], bh[n][0], bl[n][0]);
      split(br[(8 * kc + 1) * kLdb + 8 * n], bh[n][1], bl[n][1]);
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

// 16-byte copies: dh % 4 == 0 and every tensor the backward streams is
// 16-byte aligned (then so is every row of every head).
bool bwd_vec(int dh, const void* q, const void* k, const void* v, const void* dout) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
  return dh % 4 == 0 && any % 16 == 0;
}

// NC = round16(dh) / 16: the forward's 16-column groups, the backward's KC.
#define ATTN_F32_SWITCH(NC_EXPR, CALL)                                              \
  switch (NC_EXPR) {                                                                \
    case 1: CALL(1) case 2: CALL(2) case 3: CALL(3) case 4: CALL(4) case 5: CALL(5) \
    case 6: CALL(6) case 7: CALL(7) case 8: CALL(8)                                 \
    default: return (int)cudaErrorInvalidValue;                                     \
  }

template <int NC>
int launch_fwd(const float* q, const float* k, const float* v, float* out, float* stats, int b,
               int s, int heads, int dh, float scale, int causal, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(dh);
  cudaError_t err = configure(attention_f32_fwd_kernel<NC>, smem);
  if (err != cudaSuccess) return (int)err;
  attention_f32_fwd_kernel<NC><<<dim3(ceil_div(s, kTile), heads, b), kThreads, smem, st>>>(
      q, k, v, out, stats, s, heads, dh, scale, causal);
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

template <int NC>
int occupancy(int which, int dh) {
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    err = configure(attention_f32_fwd_kernel<NC>, fwd_smem_bytes(dh));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attention_f32_fwd_kernel<NC>,
                                                          kThreads, fwd_smem_bytes(dh));
  } else if (which == 1) {
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
// or dQ (2) at head dim dh, bytes.
long long attention_f32_smem_bytes(int dh, int which) {
  if (dh < 1) return 0;
  return (long long)(which == 0 ? fwd_smem_bytes(dh)
                                : which == 1 ? dkv_smem_bytes(dh) : dq_smem_bytes(dh));
}

// Blocks of the forward (which = 0), dK/dV (1) or dQ (2) kernel that one SM
// of this card holds at head dim dh (registers and shared memory); 0 on error.
int attention_f32_occupancy(int dh, int which) {
  if (dh < 1 || dh > kMaxHeadDim) return 0;
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
#define FWD_CALL(NC) return launch_fwd<NC>(qf, kf, vf, of, sf, b, s, heads, dh, scale, causal, st);
  ATTN_F32_SWITCH(round16(dh) / 16, FWD_CALL)
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
