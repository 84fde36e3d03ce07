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
// with IEEE f32 arithmetic throughout: f32 FMA on the CUDA cores (no TF32, no
// tensor cores), precise expf/log1pf, softplus(x) = max(x, 0) +
// log1p(exp(−|x|)) as jax.nn.softplus computes it, and the products `raw·t`
// and `+ bias` rounded apart (no contraction into one FMA), as JAX rounds them.
//
// Bound on this card: operations. At one ring hop of a 32k global batch over
// 8 ranks (b = n = 4096, d = 512) the forward reads 16.8 MB and does
// 2·b·n·d = 17.2 GFLOP, ≈ 5 µs of memory against ≈ 256 µs at the 67 TFLOP/s
// f32 peak outside the tensor cores; each backward pass does twice that.
//
// Design. No logits matrix ever reaches device memory: every kernel
// recomputes its (rows × 64) logit tiles from the embeddings, so memory stays
// O(tile), as in the TPU kernels. The TPU kernels carried their sums from one
// grid step to the next; Hopper's blocks run in no order, so:
//   K4  one block per 64 × 64 tile writes that tile's loss partial;
//   K5  one block owns 32 image rows and a share of the text tiles, keeping
//       its dzimg rows in shared memory (32 × d f32: 144 KB at d = 1152); it
//       writes partials of dt′ and dbias;
//   K6  the same on the transposed problem: a block owns 32 text rows.
// The text (K6: image) tiles are split over grid.z, so that at b = 4096 the
// card holds ~2 waves of blocks rather than 128 blocks for 132 SMs; each
// split writes its rows' partial gradient to scratch, and a second kernel
// sums the splits. Every sum of partials is taken in a fixed order, so runs
// are bitwise repeatable (no float atomics). Each logit tile is a register-tiled
// f32 product (16 × 16 threads, each a 4 × 4 or 2 × 4 patch) over d in chunks
// of 16 staged in shared memory; the gradient product reads the tile's
// dlogits back from shared memory against 64-column chunks of the other
// operand. Ragged b, n and d are masked (zero-filled operands, masked loss
// and stores). A d wider than 1152 is split over blocks (grid.y), each
// recomputing the logits for its slice of the gradient columns. t′, bias and
// the upstream gradient g are read from device memory: no host sync.
// Tensor-core (3xTF32 or wgmma) products and pipelined loads are later work.
//
// int8 mode (K4 int8: the int8 tile product _tile_raw_int8 of the same TPU
// kernels, reached under quant="int8"). The caller quantizes each embedding
// row once (symmetric int8, per-row f32 scale, ops/quant.py), and the logit
// tile is raw = (f32(Σ ziq·ztq) · zis) · zts: an exact int32 sum by __dp4a
// (four int8 products a thread instruction), converted once and dequantized
// by two separately rounded multiplies in JAX's order, image scale first.
// Everything after raw is the f32 mode's epilogue. K5/K6 recompute dlogits at
// the int8 raw (and dt′ sums dl·raw at it), but their gradient products read
// the full-precision f32 rows of the other operand: the straight-through
// contract of JAX's kernel. The int8 mode takes d % 16 == 0 and 16-byte
// aligned operands (the dispatch hands it d % 128 == 0 only); rows are masked
// as in the f32 mode. Bound at the 4096 × 4096 × 512 ring hop: the forward's
// 17.2 G int8 operations are 8.7 µs at 1,979 TOP/s and its epilogue's ~0.2
// G f32 operations 3 µs at 67 TFLOP/s, so bytes (4.2 MB, 1.3 µs) do not bind;
// K5/K6 keep one f32 gradient product each, half of the f32 mode's work.
// __dp4a runs on the CUDA cores, not the tensor cores: this simple kernel
// reads far above that bound (mma.sync s8 tiles are later work).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 × 16 threads
constexpr int kBK = 16;         // contraction chunk of the logit product
constexpr int kBN = 64;         // tile columns (rows of the other operand)
constexpr int kTN = 4;          // tile columns per thread
constexpr int kDC = 64;         // gradient columns per chunk
constexpr int kPad = 4;         // floats of padding per shared row (keeps 16-byte rows)
constexpr int kFwdTM = 4;       // K4: 64-row tiles
constexpr int kBwdTM = 2;       // K5/K6: 32 owned rows per block
constexpr int kBwdRows = 16 * kBwdTM;
constexpr int kMaxSlice = 1152; // widest slice of gradient columns one block keeps
constexpr int kReduceThreads = 256;
constexpr int kWavesPerSplit = 2;  // target resident waves of K5/K6 blocks

__host__ __device__ inline int ceil_div(int x, int m) { return (x + m - 1) / m; }

// Gradient columns per block: d split into the fewest slices of at most
// kMaxSlice, each a whole number of kDC-column chunks.
__host__ __device__ inline int bwd_slice(int d) {
  const int slices = ceil_div(d, kMaxSlice);
  return ceil_div(ceil_div(d, slices), kDC) * kDC;
}

// Shared floats of one block: the staged operand chunks (aliased by the
// gradient product's chunk of the other operand), the tile's dlogits
// (transposed) and the owned rows' gradient accumulators.
__host__ __device__ inline size_t fwd_smem_floats() {
  return (size_t)kBK * (16 * kFwdTM + kPad) + (size_t)kBK * (kBN + kPad);
}

__host__ __device__ inline size_t bwd_stage_floats() {
  const size_t operands = (size_t)kBK * (kBwdRows + kPad) + (size_t)kBK * (kBN + kPad);
  const size_t other = (size_t)kBN * (kDC + kPad);
  return operands > other ? operands : other;
}

__host__ __device__ inline size_t bwd_smem_floats(int d) {
  return bwd_stage_floats() + (size_t)kBN * (kBwdRows + kPad) +
         (size_t)kBwdRows * (bwd_slice(d) + kPad);
}

// Four consecutive floats of row `row`, columns [col, col + 4), of a row-major
// (rows × cols) matrix; zeros outside it. `vec`: cols % 4 == 0 and a 16-byte
// aligned base, so the four are one aligned load.
__device__ inline float4 load4(const float* __restrict__ base, int row, int rows, int col,
                               int cols, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows || col >= cols) return v;
  const float* p = base + (size_t)row * cols + col;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = __ldg(p);
  if (col + 1 < cols) v.y = __ldg(p + 1);
  if (col + 2 < cols) v.z = __ldg(p + 2);
  if (col + 3 < cols) v.w = __ldg(p + 3);
  return v;
}

__device__ inline float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

// acc[i][j] = Σ_k own[r0 + ty·TM + i, k] · other[c0 + tx·4 + j, k] over all d,
// with rows past n_own / n_other and columns past d read as zero. As and Bs
// stage one kBK-wide chunk of each operand, transposed (k-major).
template <int TM>
__device__ inline void tile_product(float (&acc)[TM][kTN], const float* __restrict__ own,
                                    int r0, int n_own, const float* __restrict__ other, int c0,
                                    int n_other, int d, bool vec, float* As, float* Bs) {
  constexpr int BM = 16 * TM, lda = BM + kPad, ldb = kBN + kPad;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int s = tid; s < BM * (kBK / 4); s += kThreads) {
      const int row = s / (kBK / 4), kq = (s % (kBK / 4)) * 4;
      const float4 v = load4(own, r0 + row, n_own, k0 + kq, d, vec);
      As[(kq + 0) * lda + row] = v.x;
      As[(kq + 1) * lda + row] = v.y;
      As[(kq + 2) * lda + row] = v.z;
      As[(kq + 3) * lda + row] = v.w;
    }
    for (int s = tid; s < kBN * (kBK / 4); s += kThreads) {
      const int row = s / (kBK / 4), kq = (s % (kBK / 4)) * 4;
      const float4 v = load4(other, c0 + row, n_other, k0 + kq, d, vec);
      Bs[(kq + 0) * ldb + row] = v.x;
      Bs[(kq + 1) * ldb + row] = v.y;
      Bs[(kq + 2) * ldb + row] = v.z;
      Bs[(kq + 3) * ldb + row] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM];
      if constexpr (TM == 4) {
        const float4 av = *reinterpret_cast<const float4*>(As + k * lda + ty * TM);
        a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
      } else {
        const float2 av = *reinterpret_cast<const float2*>(As + k * lda + ty * TM);
        a[0] = av.x; a[1] = av.y;
      }
      const float4 bv = *reinterpret_cast<const float4*>(Bs + k * ldb + tx * kTN);
      const float b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Four int8 words (16 int8 values) of row `row` at word column `col` of a
// row-major (rows × cols) int matrix, cols % 4 == 0 and a 16-byte aligned
// base; zeros outside it.
__device__ inline int4 load4i(const int* __restrict__ base, int row, int rows, int col,
                              int cols) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const int4*>(base + (size_t)row * cols + col));
}

// The int8 mode's tile_product: acc[i][j] = Σ_k own[r][k]·other[c][k] over
// int8 rows packed four to an int32 word (dw words a row), exact in int32.
// As and Bs stage kBK words (64 int8 values) of each operand, transposed.
template <int TM>
__device__ inline void tile_product_int8(int (&acc)[TM][kTN], const int* __restrict__ own, int r0,
                                         int n_own, const int* __restrict__ other, int c0,
                                         int n_other, int dw, int* As, int* Bs) {
  constexpr int BM = 16 * TM, lda = BM + kPad, ldb = kBN + kPad;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < dw; k0 += kBK) {
    for (int s = tid; s < BM * (kBK / 4); s += kThreads) {
      const int row = s / (kBK / 4), kq = (s % (kBK / 4)) * 4;
      const int4 v = load4i(own, r0 + row, n_own, k0 + kq, dw);
      As[(kq + 0) * lda + row] = v.x;
      As[(kq + 1) * lda + row] = v.y;
      As[(kq + 2) * lda + row] = v.z;
      As[(kq + 3) * lda + row] = v.w;
    }
    for (int s = tid; s < kBN * (kBK / 4); s += kThreads) {
      const int row = s / (kBK / 4), kq = (s % (kBK / 4)) * 4;
      const int4 v = load4i(other, c0 + row, n_other, k0 + kq, dw);
      Bs[(kq + 0) * ldb + row] = v.x;
      Bs[(kq + 1) * ldb + row] = v.y;
      Bs[(kq + 2) * ldb + row] = v.z;
      Bs[(kq + 3) * ldb + row] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      int a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k * lda + ty * TM + i];
      const int4 bv = *reinterpret_cast<const int4*>(Bs + k * ldb + tx * kTN);
      const int b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
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

// The block's (16·TM × 64) tile of raw = own·otherᵀ at rows r0, columns c0:
// the f32 product, or (Q) the dequantized int8 product
// (f32(acc) · image scale) · text scale, each multiply rounded on its own
// (TXT: own is the text side).
template <int TM, bool Q, bool TXT>
__device__ inline void raw_tile(float (&raw)[TM][kTN], const Operands& op, int r0, int n_own,
                                int c0, int n_other, int d, bool vec, float* As, float* Bs) {
  if constexpr (!Q) {
    tile_product<TM>(raw, op.own, r0, n_own, op.other, c0, n_other, d, vec, As, Bs);
  } else {
    int acc[TM][kTN];
    tile_product_int8<TM>(acc, op.own_q, r0, n_own, op.other_q, c0, n_other, d / 4,
                          reinterpret_cast<int*>(As), reinterpret_cast<int*>(Bs));
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float so[TM], sc[kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty * TM + i;
      so[i] = r < n_own ? __ldg(op.own_s + r) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = c0 + tx * kTN + j;
      sc[j] = c < n_other ? __ldg(op.other_s + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float f = __int2float_rn(acc[i][j]);
        raw[i][j] = TXT ? __fmul_rn(__fmul_rn(f, sc[j]), so[i])
                        : __fmul_rn(__fmul_rn(f, so[i]), sc[j]);
      }
  }
}

// K4: one block per 64 × 64 tile; partials[tile] = Σ softplus(−label·logit).
template <bool Q>
__global__ void __launch_bounds__(kThreads)
sigmoid_loss_fwd_kernel(const Operands op, const float* __restrict__ t_prime,
                        const float* __restrict__ bias, int b, int n, int d, int off, int vec,
                        float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kBK * (16 * kFwdTM + kPad);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * 16 * kFwdTM, c0 = blockIdx.y * kBN;
  float acc[kFwdTM][kTN];
  raw_tile<kFwdTM, Q, false>(acc, op, r0, b, c0, n, d, vec, As, Bs);
  const float t = expf(__ldg(t_prime)), bb = __ldg(bias);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kFwdTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int r = r0 + ty * kFwdTM + i, c = c0 + tx * kTN + j;
      if (r < b && c < n) {
        const float label = c == r + off ? 1.f : -1.f;
        sum += softplus(-label * logit_of(acc[i][j], t, bb));
      }
    }
  const float s = block_sum(sum, As);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// K5 (TXT = false: own = zimg, other = ztxt) and K6 (TXT = true: own = ztxt,
// other = zimg). A block owns 32 rows of `own` and gradient columns
// [d0, d0 + slice), and loops over split blockIdx.z's `split_tiles` 64-row
// tiles of `other`. With one split it writes t·Σ into dout, else Σ into
// dpart[split] (the caller sums the splits). K5's blocks of slice 0 also
// write partials of dt′ and dbias: partials[i] and partials[count + i], with
// i = blockIdx.z·gridDim.x + blockIdx.x and count = gridDim.x·gridDim.z.
template <bool TXT, bool Q>
__global__ void __launch_bounds__(kThreads)
sigmoid_loss_bwd_kernel(const Operands op, const float* __restrict__ t_prime,
                        const float* __restrict__ bias,
                        const float* __restrict__ g, int n_own, int n_other, int d, int off,
                        int vec, int split_tiles, float* __restrict__ dout,
                        float* __restrict__ dpart, float* __restrict__ partials) {
  constexpr int TM = kBwdTM, BM = kBwdRows, ldg_ = BM + kPad, ldx = kDC + kPad;
  extern __shared__ float4 smem4[];
  const int slice = bwd_slice(d), ldacc = slice + kPad;
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kBK * (BM + kPad);
  float* Xs = As;  // the other operand's gradient chunk, after the product is done
  float* Gt = As + bwd_stage_floats();  // dlogits, transposed: Gt[col][row]
  float* Acc = Gt + kBN * ldg_;         // gradient rows: Acc[row][col - d0]
  const float* __restrict__ other = op.other;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * BM, d0 = blockIdx.y * slice;
  const int width = min(slice, d - d0);

  for (int i = tid; i < BM * ldacc; i += kThreads) Acc[i] = 0.f;
  const float t = expf(__ldg(t_prime)), bb = __ldg(bias), gg = __ldg(g);
  float s_raw = 0.f, s_dl = 0.f;

  const int c_begin = blockIdx.z * split_tiles * kBN;
  const int c_end = min(n_other, c_begin + split_tiles * kBN);
  for (int c0 = c_begin; c0 < c_end; c0 += kBN) {
    float acc[TM][kTN];
    raw_tile<TM, Q, TXT>(acc, op, r0, n_own, c0, n_other, d, vec, As, Bs);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int r = r0 + ty * TM + i, c = c0 + tx * kTN + j;
        float dl = 0.f;
        if (r < n_own && c < n_other) {
          const bool pos = TXT ? r == c + off : c == r + off;
          const float label = pos ? 1.f : -1.f;
          const float x = label * logit_of(acc[i][j], t, bb);
          dl = gg * (-label * sigmoid(-x));
          if (!TXT) {
            s_raw += dl * acc[i][j];
            s_dl += dl;
          }
        }
        Gt[(tx * kTN + j) * ldg_ + ty * TM + i] = dl;
      }
    __syncthreads();
    for (int dc = 0; dc < width; dc += kDC) {
      for (int s = tid; s < kBN * (kDC / 4); s += kThreads) {
        const int row = s / (kDC / 4), col = (s % (kDC / 4)) * 4;
        *reinterpret_cast<float4*>(Xs + row * ldx + col) =
            load4(other, c0 + row, n_other, d0 + dc + col, d, vec);
      }
      __syncthreads();
      float o[TM][kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(Acc + (ty * TM + i) * ldacc + dc + tx * kTN);
        o[i][0] = v.x; o[i][1] = v.y; o[i][2] = v.z; o[i][3] = v.w;
      }
#pragma unroll 8
      for (int k = 0; k < kBN; ++k) {
        const float2 a = *reinterpret_cast<const float2*>(Gt + k * ldg_ + ty * TM);
        const float4 x = *reinterpret_cast<const float4*>(Xs + k * ldx + tx * kTN);
        const float av[TM] = {a.x, a.y}, xv[kTN] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) o[i][j] = fmaf(av[i], xv[j], o[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(Acc + (ty * TM + i) * ldacc + dc + tx * kTN) =
            make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      __syncthreads();  // Xs (aliasing the operand staging) and Gt are reused
    }
  }

  const bool whole = gridDim.z == 1;
  float* dst = whole ? dout : dpart + (size_t)blockIdx.z * n_own * d;
  const float scale = whole ? t : 1.f;
  for (int i = tid; i < BM * width; i += kThreads) {
    const int row = i / width, col = i % width;
    if (r0 + row < n_own) dst[(size_t)(r0 + row) * d + d0 + col] = Acc[row * ldacc + col] * scale;
  }
  if (!TXT && blockIdx.y == 0) {
    // `red` aliases the staging area, unused from here on.
    const int count = gridDim.x * gridDim.z, i = blockIdx.z * gridDim.x + blockIdx.x;
    const float sr = block_sum(s_raw, As);
    if (tid == 0) partials[i] = sr * t;
    const float sd = block_sum(s_dl, As);
    if (tid == 0) partials[count + i] = sd;
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
  return b < 1 || n < 1 || d < 1 || ceil_div(n, kBN) > 65535 || ceil_div(d, kMaxSlice) > 65535;
}

// Splits of the other operand's tiles over grid.z: enough blocks for
// kWavesPerSplit resident waves on this card, each split at least one tile.
// Returns the tiles per split through `split_tiles`. Both modes take the
// f32 kernel's occupancy, so a call's scratch size does not depend on them.
int bwd_splits(int n_own, int n_other, int d, int* split_tiles) {
  const int tiles = ceil_div(n_other, kBN);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t smem = bwd_smem_floats(d) * sizeof(float);
  if (configure(sigmoid_loss_bwd_kernel<false, false>, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sigmoid_loss_bwd_kernel<false, false>, kThreads, smem) != cudaSuccess)
    per_sm = 1;
  const int blocks = ceil_div(n_own, kBwdRows) * ceil_div(d, bwd_slice(d));
  int splits = ceil_div(kWavesPerSplit * (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1), blocks);
  splits = splits < 1 ? 1 : (splits > tiles ? tiles : splits);
  *split_tiles = ceil_div(tiles, splits);
  return ceil_div(tiles, *split_tiles);  // no empty split
}

template <bool TXT, bool Q>
cudaError_t launch_bwd(const Operands& op, const float* t_prime, const float* bias,
                       const float* g, int n_own, int n_other, int d, int off, int vec,
                       float* dout, float* scratch, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(d) * sizeof(float);
  cudaError_t err = configure(sigmoid_loss_bwd_kernel<TXT, Q>, smem);
  if (err != cudaSuccess) return err;
  int split_tiles = 0;
  const int splits = bwd_splits(n_own, n_other, d, &split_tiles);
  const dim3 grid(ceil_div(n_own, kBwdRows), ceil_div(d, bwd_slice(d)), splits);
  // Scratch: the splits' partial gradients (when more than one), then K5's
  // partials of dt′ and dbias.
  const size_t count = (size_t)n_own * d;
  float* dpart = splits > 1 ? scratch : nullptr;
  float* partials = scratch + (splits > 1 ? (size_t)splits * count : 0);
  sigmoid_loss_bwd_kernel<TXT, Q><<<grid, kThreads, smem, stream>>>(
      op, t_prime, bias, g, n_own, n_other, d, off, vec, split_tiles, dout, dpart, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks = (int)((count + kReduceThreads - 1) / kReduceThreads);
  sigmoid_loss_sum_splits_kernel<<<blocks < 65535 ? blocks : 65535, kReduceThreads, 0, stream>>>(
      dpart, splits, count, t_prime, dout);
  return cudaGetLastError();
}

template <bool Q>
int launch_fwd(const Operands& op, const void* t_prime, const void* bias, int b, int n, int d,
               int off, int vec, void* partials, void* out, void* stream) {
  if (bad_shape(b, n, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem_floats() * sizeof(float);
  cudaError_t err = configure(sigmoid_loss_fwd_kernel<Q>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(b, 16 * kFwdTM), ceil_div(n, kBN));
  sigmoid_loss_fwd_kernel<Q><<<grid, kThreads, smem, st>>>(
      op, static_cast<const float*>(t_prime), static_cast<const float*>(bias), b, n, d, off, vec,
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sigmoid_loss_reduce_kernel<<<1, kReduceThreads, 0, st>>>(
      static_cast<const float*>(partials), (int)ceil_div(b, 16 * kFwdTM) * ceil_div(n, kBN),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <bool Q>
int launch_bwd_img(const Operands& op, const void* t_prime, const void* bias, const void* g,
                   int b, int n, int d, int off, int vec, void* dzimg, void* scratch, void* out2,
                   void* stream) {
  if (bad_shape(b, n, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err = launch_bwd<false, Q>(
      op, static_cast<const float*>(t_prime), static_cast<const float*>(bias),
      static_cast<const float*>(g), b, n, d, off, vec, static_cast<float*>(dzimg), sc, st);
  if (err != cudaSuccess) return (int)err;
  int split_tiles = 0;
  const int splits = bwd_splits(b, n, d, &split_tiles);
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
  return (int)launch_bwd<true, Q>(
      op, static_cast<const float*>(t_prime), static_cast<const float*>(bias),
      static_cast<const float*>(g), n, b, d, off, vec, static_cast<float*>(dztxt),
      static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));
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

// Partials each pass writes (mirrored in ops/streaming_sigmoid_loss.py).
long long sigmoid_loss_fwd_partials(int b, int n) {
  return (long long)ceil_div(b, 16 * kFwdTM) * ceil_div(n, kBN);
}

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
  return d < 1 ? 0 : (long long)(bwd_smem_floats(d) * sizeof(float));
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

// Resident blocks per SM of K4 (which = 0) or K5/K6 (which = 1) at width d
// (0 with an error), for the records.
int sigmoid_loss_occupancy(int d, int which) {
  if (d < 1) return 0;
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    const size_t smem = fwd_smem_floats() * sizeof(float);
    err = configure(sigmoid_loss_fwd_kernel<false>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sigmoid_loss_fwd_kernel<false>,
                                                          kThreads, smem);
  } else {
    const size_t smem = bwd_smem_floats(d) * sizeof(float);
    err = configure(sigmoid_loss_bwd_kernel<false, false>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sigmoid_loss_bwd_kernel<false, false>, kThreads, smem);
  }
  return err == cudaSuccess ? blocks : 0;
}

const char* sigmoid_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
