// f32 self-attention for Hopper (sm_90a): a forward and a two-pass backward
// (a di pass with dK/dV, then dQ) in IEEE f32 on the CUDA cores.
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
// only (q, k, v). Every product is an IEEE f32 FMA (no TF32, no tensor
// cores), expf is the precise one, as JAX's f32 kernels are held at rtol 1e-4.
//
// Bound on this card: operations. At ViT-B/16 vision in f32 (b=128, s=196,
// h=12, dh=64) the forward's two products are 4·128·12·196²·64 = 15.1 GFLOP,
// 225 µs at the 67 TFLOP/s f32 peak, against 4·128·196·768·4 B = 308 MB, 92
// µs at 3.35 TB/s; the backward's five products (plus the forward it
// recomputes in the K2/K3 roles) likewise.
//
// Design: flash attention in f32. A block of 256 threads owns 64 rows (the
// forward and dQ: query rows; dK/dV: key rows) of one (batch row, head) and
// walks over the 64-row tiles of the other side, so shared memory stays
// O(64·dh) whatever s is: a per-head s × s chain in f32 (153 KB at s = 196)
// would not fit beside K and V. Every tile sits in shared memory transposed,
// column-major with a row stride of 65 floats, so the loads from device
// memory (consecutive threads on consecutive columns) and both reads of a
// product (a row index shared by a half-warp, or consecutive rows) are free of
// bank conflicts. A thread computes a 4 × 4 patch of a 64 × 64 logit tile
// (rows ty + 16i, columns tx + 16j) and a 4 × dh/16 patch of the 64 × dh
// outputs; row maxima and sums are half-warp shuffles. The forward keeps the
// online-softmax state (m, l, the output rows) in registers; the backward
// recomputes p from the saved (m, l), as K7's does. Every output element has
// one writer and there are no atomics: runs are bitwise repeatable. Ragged s
// is zero-filled and masked by index; causal tiles past the diagonal are
// skipped. wgmma-free by design: the tensor cores have no IEEE f32 product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__host__ __device__ inline size_t dkv_smem_bytes(int dh) {
  return (size_t)(4 * tile_floats(dh) + 2 * kTile * kLd + 3 * kTile) * sizeof(float);
}

__host__ __device__ inline size_t dq_smem_bytes(int dh) {
  return (size_t)(4 * tile_floats(dh) + kTile * kLd) * sizeof(float);
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

// dK/dV: grid (key tiles, heads, b); a block owns 64 key rows and walks the
// query tiles (causal: from its own diagonal on).
template <int NC>
__global__ void __launch_bounds__(kThreads)
attention_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ stats, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, int s, int heads,
                         int dh, float scale, int causal) {
  extern __shared__ float smem[];
  const int tf = tile_floats(dh);
  float* kt = smem;
  float* vt = kt + tf;
  float* qt = vt + tf;
  float* dot = qt + tf;
  float* pt = dot + tf;            // p[query][key]
  float* dst = pt + kTile * kLd;   // ds[query][key]
  float* rm = dst + kTile * kLd;   // the query tile's m, 1/l and di
  float* rl = rm + kTile;
  float* rd = rl + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int width = heads * dh, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  const size_t row_off = ((size_t)b * heads + h) * s;
  const float* st = stats + ((size_t)b * heads + h) * 2 * s;
  load_t(kt, k + slab, k0, s, width, dh);
  load_t(vt, v + slab, k0, s, width, dh);

  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) gk[i][j] = gv[i][j] = 0.f;
  for (int q0 = causal ? k0 : 0; q0 < s; q0 += kTile) {
    __syncthreads();
    load_t(qt, q + slab, q0, s, width, dh);
    load_t(dot, dout + slab, q0, s, width, dh);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int row = q0 + r;
      rm[r] = row < s ? st[row] : 0.f;
      rl[r] = row < s ? 1.f / st[s + row] : 0.f;
      rd[r] = row < s ? di[row_off + row] : 0.f;
    }
    __syncthreads();
    float x[4][4], dp[4][4];
    tile_tt(x, kt, qt, dh);   // x[key][query]
    tile_tt(dp, vt, dot, dh); // dp[key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cq = tx + 16 * j, row = q0 + cq;
        const bool live = !causal || key <= row;
        const float p = live ? expf(x[i][j] * scale - rm[cq]) * rl[cq] : 0.f;
        pt[cq * kLd + ty + 16 * i] = p;
        dst[cq * kLd + ty + 16 * i] = p * (dp[i][j] - rd[cq]) * scale;
      }
    }
    __syncthreads();
    tile_acc<NC>(gv, pt, dot);
    tile_acc<NC>(gk, dst, qt);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<NC>(dk + slab, gk, one, k0, s, width, dh);
  store_rows<NC>(dv + slab, gv, one, k0, s, width, dh);
}

// dQ: grid (query tiles, heads, b); a block owns 64 query rows and walks the
// key tiles (causal: up to its diagonal).
template <int NC>
__global__ void __launch_bounds__(kThreads)
attention_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ stats, const float* __restrict__ di,
                        float* __restrict__ dq, int s, int heads, int dh, float scale,
                        int causal) {
  extern __shared__ float smem[];
  const int tf = tile_floats(dh);
  float* qt = smem;
  float* dot = qt + tf;
  float* kt = dot + tf;
  float* vt = kt + tf;
  float* dst = vt + tf;  // ds[key][query]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int width = heads * dh, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t slab = (size_t)b * s * width + (size_t)h * dh;
  const size_t row_off = ((size_t)b * heads + h) * s;
  const float* st = stats + ((size_t)b * heads + h) * 2 * s;
  load_t(qt, q + slab, q0, s, width, dh);
  load_t(dot, dout + slab, q0, s, width, dh);
  float rm[4], rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    rm[i] = row < s ? st[row] : 0.f;
    rl[i] = row < s ? 1.f / st[s + row] : 0.f;
    rd[i] = row < s ? di[row_off + row] : 0.f;
  }

  float g[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) g[i][j] = 0.f;
  const int last = causal ? min(s, q0 + kTile) : s;
  for (int k0 = 0; k0 < last; k0 += kTile) {
    __syncthreads();
    load_t(kt, k + slab, k0, s, width, dh);
    load_t(vt, v + slab, k0, s, width, dh);
    __syncthreads();
    float x[4][4], dp[4][4];
    tile_tt(x, qt, kt, dh);   // x[query][key]
    tile_tt(dp, dot, vt, dh); // dp[query][key]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ck = tx + 16 * j, key = k0 + ck;
        const bool live = key < s && (!causal || key <= row);
        const float p = live ? expf(x[i][j] * scale - rm[i]) * rl[i] : 0.f;
        dst[ck * kLd + ty + 16 * i] = p * (dp[i][j] - rd[i]) * scale;
      }
    }
    __syncthreads();
    tile_acc<NC>(g, dst, kt);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<NC>(dq + slab, g, one, q0, s, width, dh);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int b, int s, int heads, int dh) {
  return b < 1 || b > 65535 || s < 1 || heads < 1 || heads > 65535 || dh < 1 ||
         dh > kMaxHeadDim;
}

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

template <int NC>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* stats, const float* di, float* dk, float* dv, int b, int s,
               int heads, int dh, float scale, int causal, cudaStream_t st) {
  const size_t smem = dkv_smem_bytes(dh);
  cudaError_t err = configure(attention_f32_dkv_kernel<NC>, smem);
  if (err != cudaSuccess) return (int)err;
  attention_f32_dkv_kernel<NC><<<dim3(ceil_div(s, kTile), heads, b), kThreads, smem, st>>>(
      q, k, v, dout, stats, di, dk, dv, s, heads, dh, scale, causal);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* stats, const float* di, float* dq, int b, int s, int heads, int dh,
              float scale, int causal, cudaStream_t st) {
  const size_t smem = dq_smem_bytes(dh);
  cudaError_t err = configure(attention_f32_dq_kernel<NC>, smem);
  if (err != cudaSuccess) return (int)err;
  attention_f32_dq_kernel<NC><<<dim3(ceil_div(s, kTile), heads, b), kThreads, smem, st>>>(
      q, k, v, dout, stats, di, dq, s, heads, dh, scale, causal);
  return (int)cudaGetLastError();
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
#define DKV_CALL(NC) \
  return launch_dkv<NC>(qf, kf, vf, gf, sf, df, dkf, dvf, b, s, heads, dh, scale, causal, st);
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
#define DQ_CALL(NC) \
  return launch_dq<NC>(qf, kf, vf, gf, sf, df, dqf, b, s, heads, dh, scale, causal, st);
  ATTN_F32_SWITCH(round16(dh) / 16, DQ_CALL)
#undef DQ_CALL
}

const char* attention_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
