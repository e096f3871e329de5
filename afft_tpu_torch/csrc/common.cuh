// Shared device code for the kernels of afft_tpu_torch.
//
// Every port entry (fused_block.cu, fused_gpt2.cu, attention.cu, seq_block.cu,
// fused_block_train.cu and fused_gpt2_train.cu through train_block.cuh) is a
// short sequence of launches on one stream, built from the pieces below, the
// wgmma / TMA GEMM of gemm_sm90.cuh (every bf16 product) and the attentions
// of staged_attention.cuh and fuser_attention.cuh:
//   * layernorm_rows: one warp per row, fp32 statistics, output in the
//     working dtype (the rounding the TPU kernels apply before each matmul);
//   * gemm_f32: C[M,N] = A[M,K] . W + bias with a fused epilogue (GELU,
//     residual add, cast), the fp32 products: W read as (N,K) row-major
//     (nn.Linear) or (K,N) row-major (HF Conv1D), chosen at compile time,
//     so neither weight layout is repacked per call. Plain FMA (no TF32),
//     so fp32 parity checks compare true fp32 products;
// and, for the training kernels:
//   * drop_scale: the dropout multiplier (0 or 1/keep) of one logical element,
//     from a counter-based Philox4x32-10 draw computed in registers, so the
//     forward and the backward regenerate the same mask with none in memory;
//   * gemm_tn_f32: C[I,J] = A[K,I]^T . B[K,J] in fp32, the fp32 weight
//     gradients (a reduction over the K = R*N rows of two activation
//     matrices; gemm_sm90.cuh's gemm_tn_sm90 in bf16);
//   * epilogues with dropout and drop-path (EPI_RES_DROP), with the stashed
//     pre-activation (EPI_PRE_GELU, EPI_PRE_GELU_TANH) and with the GELU
//     derivative (EPI_GELU_BWD, EPI_GELU_TANH_BWD), element for element as
//     gemm_sm90.cuh's epilogue8 applies them to 8 columns;
//   * column sums over rows in two deterministic stages (bias and LayerNorm
//     affine gradients) and the LayerNorm backward over rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace afft {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// conversions and warp reductions
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// LayerNorm over rows of C: y = (x - mu) * rsqrt(var + eps) [* g + b]
// ---------------------------------------------------------------------------

constexpr int LN_ROWS = 8;  // one warp per row, 8 warps per block

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(LN_ROWS * 32)
layernorm_rows(const TIn* __restrict__ x, const TOut* __restrict__ g,
               const TOut* __restrict__ b, TOut* __restrict__ y, int M, int C,
               float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS + warp;
  if (row >= M) return;
  const TIn* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / (float)C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / (float)C + eps);
  TOut* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    float o = (to_f32(xr[c]) - mu) * rs;
    if (g != nullptr) o = o * to_f32(g[c]) + to_f32(b[c]);
    yr[c] = from_f32<TOut>(o);
  }
}

template <typename TIn, typename TOut>
static void launch_layernorm(const TIn* x, const TOut* g, const TOut* b,
                             TOut* y, int M, int C, float eps,
                             cudaStream_t stream) {
  layernorm_rows<TIn, TOut><<<cdiv(M, LN_ROWS), LN_ROWS * 32, 0, stream>>>(
      x, g, b, y, M, C, eps);
}

// ---------------------------------------------------------------------------
// Dropout masks: a pure function of (two seed words, block index, site,
// logical element index). Philox4x32-10 with key (seed0, seed1) and counter
// (index low, index high, block, site); the first output word's top 24 bits
// are the uniform draw, kept when below the 24-bit threshold. thr = 2^24
// (rate 0) keeps everything without drawing. ``base`` is added to every
// local index: a process of a data-parallel step holds rows r0 .. of the
// global batch, and its elements are the global batch's from r0's first on.
// A tensor-parallel shard of the attention holds H of a row's Hg heads: its
// local index i of row (i / span) is moved on by (i / span) * gap, gap the
// other ranks' heads of a row ((Hg - H) N^2 elements), and base adds the
// rank's first head; span 0 (every other site) moves nothing.
// ---------------------------------------------------------------------------

struct DropSite {
  unsigned seed0, seed1, block, site;
  unsigned thr;             // keep iff (draw >> 8) < thr
  float inv;                // 1 / keep, the scale of a kept element
  unsigned long long base;  // logical index of this process's element 0
  unsigned long long span;  // local elements a row (0: no remap)
  unsigned long long gap;   // the other ranks' elements a row
};

constexpr unsigned DROP_KEEP_ALL = 1u << 24;

// The draw's constants: the round multipliers and the key schedule's Weyl
// increments. Every caller draws through philox_word0 below, the one copy.
constexpr unsigned PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr unsigned PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// hi:lo = a * m, one widening multiply (mul.wide.u32: IMAD.WIDE.U32, both
// halves from one instruction; on an H100 it takes about two issue slots of
// the FMA-heavy pipe, as IMAD.HI and IMAD would: philox_bound.py --probe)
__device__ __forceinline__ void philox_mul(unsigned a, unsigned m,
                                           unsigned& hi, unsigned& lo) {
  const unsigned long long p = (unsigned long long)a * m;
  hi = (unsigned)(p >> 32);
  lo = (unsigned)p;
}

// Word 0 of Philox4x32-10. Round r's keys are seed + r * W, each a function
// of the seed alone, so a loop over elements computes them once (or the
// compiler folds them into its operands); each round is two widening
// multiplies and two 3-input XORs (LOP3), and the last round keeps only the
// high half of the product that word 0 needs. Where a caller draws several
// elements whose counters share words 1-3 (drop_scales), the compiler shares
// round 0's product of the block word and round 1's of word 0 among them.
__device__ __forceinline__ unsigned philox_word0(unsigned k0, unsigned k1,
                                                 unsigned c0, unsigned c1,
                                                 unsigned c2, unsigned c3) {
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    unsigned hi0, lo0, hi1, lo1;
    philox_mul(c0, PHILOX_M0, hi0, lo0);
    philox_mul(c2, PHILOX_M1, hi1, lo1);
    c0 = hi1 ^ c1 ^ (k0 + (unsigned)r * PHILOX_W0);
    c1 = lo1;
    c2 = hi0 ^ c3 ^ (k1 + (unsigned)r * PHILOX_W1);
    c3 = lo0;
  }
  return __umulhi(c2, PHILOX_M1) ^ c1 ^ (k0 + 9u * PHILOX_W0);
}

// keep iff (draw >> 8) < thr, as draw < (thr << 8): thr < 2^24 here
__device__ __forceinline__ float drop_keep(const DropSite& d, unsigned w) {
  return w < (d.thr << 8) ? d.inv : 0.f;
}

__device__ __forceinline__ float drop_scale(const DropSite& d,
                                            unsigned long long idx) {
  if (d.thr >= DROP_KEEP_ALL) return d.inv;
  if (d.span != 0) idx += idx / d.span * d.gap;
  idx += d.base;
  return drop_keep(d, philox_word0(d.seed0, d.seed1, (unsigned)idx,
                                   (unsigned)(idx >> 32), d.block, d.site));
}

// The multipliers of V logical elements whose indices (after base; a site
// without a remap, span 0) are hi:lo .. hi:lo + V - 1, one high word: the
// caller keeps lo + V - 1 from carrying. drop_scale of each, bit for bit;
// the V chains are independent, so they interleave, and share their first
// two rounds' element-free products.
template <int V>
__device__ __forceinline__ void drop_scales(const DropSite& d, unsigned lo,
                                            unsigned hi, float (&m)[V]) {
  if (d.thr >= DROP_KEEP_ALL) {
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = d.inv;
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    m[j] = drop_keep(d, philox_word0(d.seed0, d.seed1, lo + (unsigned)j, hi,
                                     d.block, d.site));
}

// Whether the logical indices base + e .. base + e + count - 1 share one
// high word (the condition of drop_scales), for count >= 1.
__device__ __forceinline__ bool drop_one_word(const DropSite& d,
                                              unsigned long long e,
                                              unsigned count) {
  const unsigned lo = (unsigned)(d.base + e);
  return lo <= 0xFFFFFFFFu - (count - 1);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// d/dv [0.5 v (1 + erf(v / sqrt 2))]
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// gelu_new: 0.5 v (1 + tanh(u)), u = sqrt(2 / pi) (v + 0.044715 v^3)
__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v *
         (1.f + tanhf(0.79788456080286536f * (v + 0.044715f * v * v * v)));
}

// its derivative, 0.5 (1 + tanh u) + 0.5 v (1 - tanh^2 u) du/dv
// (pallas_gpt2_train.py:157-164)
__device__ __forceinline__ float gelu_tanh_grad(float v) {
  const float t = tanhf(0.79788456080286536f * (v + 0.044715f * v * v * v));
  const float du = 0.79788456080286536f * (1.f + 3.f * 0.044715f * v * v);
  return 0.5f * (1.f + t) + 0.5f * v * (1.f - t * t) * du;
}

// ---------------------------------------------------------------------------
// GEMM epilogues
// ---------------------------------------------------------------------------

enum Epi {
  EPI_BIAS = 0,        // out = acc + bias
  EPI_BIAS_RES = 1,    // out = res + (acc + bias)
  EPI_GELU_ERF = 2,    // out = gelu_exact(acc + bias)
  EPI_GELU_TANH = 3,   // out = gelu_new(acc + bias)
  // training: out = res + row_drop[row / tokens] * (drop[row, col] * (acc +
  // bias)), also written to out2 in the working dtype when out2 is given
  EPI_RES_DROP = 4,
  // training: out2 = acc + bias (the stashed pre-activation, rounded to the
  // working dtype), out = gelu_exact(acc + bias)
  EPI_PRE_GELU = 5,
  // backward: out = acc * gelu_exact'(res), res the stashed pre-activation
  EPI_GELU_BWD = 6,
  // EPI_PRE_GELU and EPI_GELU_BWD with gelu_new (tanh), the GPT-2 MLP's
  EPI_PRE_GELU_TANH = 7,
  EPI_GELU_TANH_BWD = 8,
};

struct EpiArgs {
  const void* bias;  // (N,) in the working dtype, or null
  const void* res;   // (M, N) residual or stashed pre-activation
  void* out;         // (M, N)
  void* out2;        // (M, N) second output in the working dtype, or null
  DropSite drop;     // per-element dropout, EPI_RES_DROP only
  DropSite row_drop; // drop-path of row / tokens, EPI_RES_DROP only
  int tokens;        // rows of the GEMM per drop-path row
};

template <typename T, int EPI, typename TRes, typename TOut>
__device__ __forceinline__ void epilogue(const EpiArgs& ea, int M, int N,
                                         int row, int col, float acc) {
  if (row >= M || col >= N) return;
  float v = acc;
  if (ea.bias != nullptr) v += to_f32(static_cast<const T*>(ea.bias)[col]);
  const size_t at = (size_t)row * N + col;
  if (EPI == EPI_GELU_ERF) {
    v = gelu_erf(v);
  } else if (EPI == EPI_PRE_GELU) {
    static_cast<T*>(ea.out2)[at] = from_f32<T>(v);
    v = gelu_erf(v);
  } else if (EPI == EPI_PRE_GELU_TANH) {
    static_cast<T*>(ea.out2)[at] = from_f32<T>(v);
    v = gelu_tanh(v);
  } else if (EPI == EPI_GELU_BWD) {
    v *= gelu_erf_grad(to_f32(static_cast<const TRes*>(ea.res)[at]));
  } else if (EPI == EPI_GELU_TANH_BWD) {
    v *= gelu_tanh_grad(to_f32(static_cast<const TRes*>(ea.res)[at]));
  } else if (EPI == EPI_RES_DROP) {
    v *= drop_scale(ea.drop, at);
    v *= drop_scale(ea.row_drop, (unsigned long long)(row / ea.tokens));
    // a tensor-parallel partial sum of a rank other than 0 has no residual
    if (ea.res != nullptr) v = to_f32(static_cast<const TRes*>(ea.res)[at]) + v;
    if (ea.out2 != nullptr) static_cast<T*>(ea.out2)[at] = from_f32<T>(v);
  } else if (EPI == EPI_GELU_TANH) {
    v = gelu_tanh(v);
  } else if (EPI == EPI_BIAS_RES) {
    v = to_f32(static_cast<const TRes*>(ea.res)[at]) + v;
  }
  static_cast<TOut*>(ea.out)[at] = from_f32<TOut>(v);
}

// ---------------------------------------------------------------------------
// fp32 GEMM: plain FMA, 64x64x16 tiles, 4x4 outputs per thread
// ---------------------------------------------------------------------------

constexpr int GF_M = 64, GF_N = 64, GF_K = 16, GF_THREADS = 256;

template <int EPI, bool B_KN, typename TRes, typename TOut>
__global__ void __launch_bounds__(GF_THREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ W, int M,
         int N, int K, EpiArgs ea) {
  __shared__ float As[GF_K][GF_M];
  __shared__ float Bs[GF_K][GF_N];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * GF_M, n0 = blockIdx.x * GF_N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GF_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * GF_THREADS;
      const int r = e >> 4, k = e & 15;
      const int gr = m0 + r, gk = k0 + k;
      As[k][r] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * GF_THREADS;
      if (B_KN) {
        const int k = e >> 6, n = e & 63;
        const int gk = k0 + k, gn = n0 + n;
        Bs[k][n] = (gk < K && gn < N) ? W[(size_t)gk * N + gn] : 0.f;
      } else {
        const int n = e >> 4, k = e & 15;
        const int gk = k0 + k, gn = n0 + n;
        Bs[k][n] = (gk < K && gn < N) ? W[(size_t)gn * K + gk] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GF_K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epilogue<float, EPI, TRes, TOut>(ea, M, N, m0 + ty + 16 * i,
                                       n0 + tx + 16 * j, acc[i][j]);
}

template <int EPI, bool B_KN, typename TRes, typename TOut>
static void launch_gemm(const float* A, const float* W, int M, int N, int K,
                        EpiArgs ea, cudaStream_t stream) {
  dim3 grid(cdiv(N, GF_N), cdiv(M, GF_M));
  gemm_f32<EPI, B_KN, TRes, TOut><<<grid, GF_THREADS, 0, stream>>>(A, W, M, N,
                                                                   K, ea);
}

// ---------------------------------------------------------------------------
// Weight-gradient GEMM in fp32: out[I,J] = A^T . B for A (K, I) and B (K, J),
// both row-major, reduced over the K rows, plain FMA (the bf16 route is
// gemm_sm90.cuh's gemm_tn_sm90). One block per 64x64 output tile walks all
// of K: the sum has a fixed order, so the result is the same from run to
// run. (Not a template, so static: every .cu that includes this header gets
// its own.)
// ---------------------------------------------------------------------------

static __global__ void __launch_bounds__(GF_THREADS)
gemm_tn_f32(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ out, int I, int J, int K) {
  __shared__ float As[GF_K][GF_M];
  __shared__ float Bs[GF_K][GF_N];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.y * GF_M, j0 = blockIdx.x * GF_N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GF_K) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = tid + t * GF_THREADS;
      const int k = e >> 6, c = e & 63;
      const int gk = k0 + k;
      As[k][c] = (gk < K && i0 + c < I) ? A[(size_t)gk * I + i0 + c] : 0.f;
      Bs[k][c] = (gk < K && j0 + c < J) ? B[(size_t)gk * J + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GF_K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = i0 + ty + 16 * i, col = j0 + tx + 16 * j;
      if (row < I && col < J) out[(size_t)row * J + col] = acc[i][j];
    }
}

static void launch_gemm_tn(const float* A, const float* B, float* out, int I,
                           int J, int K, cudaStream_t stream) {
  dim3 grid(cdiv(J, GF_N), cdiv(I, GF_M));
  gemm_tn_f32<<<grid, GF_THREADS, 0, stream>>>(A, B, out, I, J, K);
}

// ---------------------------------------------------------------------------
// Column sums over M rows in two stages, both in a fixed order (no atomics:
// the same bits from run to run). Stage 1: block (32 columns x 8 row lanes)
// sums one slice of rows into partial[slice, column]; stage 2 adds the
// slices. colsum: out[c] = sum_m a[m, c]. ln_colsum: with the rows'
// LayerNorm statistics, out[0, c] = sum_m d[m, c] * xhat[m, c] (the gain's
// gradient) and out[1, c] = sum_m d[m, c] (the bias's).
// ---------------------------------------------------------------------------

constexpr int CS_SLICES = 128;  // most slices; partial holds 2 * 128 * C

static inline int colsum_slices(int M) {
  const int n = cdiv(M, 32);
  return n < CS_SLICES ? n : CS_SLICES;
}

template <typename T>
__global__ void __launch_bounds__(256)
colsum_partial(const T* __restrict__ a, float* __restrict__ partial, int M,
               int C, int rows_per_slice) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const int m0 = blockIdx.y * rows_per_slice;
  const int m1 = min(M, m0 + rows_per_slice);
  float acc = 0.f;
  if (c < C)
    for (int m = m0 + ty; m < m1; m += 8) acc += to_f32(a[(size_t)m * C + c]);
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < C) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += red[i][tx];
    partial[(size_t)blockIdx.y * C + c] = s;
  }
}

template <typename TX>
__global__ void __launch_bounds__(256)
ln_colsum_partial(const float* __restrict__ d, const TX* __restrict__ x,
                  const float* __restrict__ mu, const float* __restrict__ rstd,
                  float* __restrict__ partial, int M, int C,
                  int rows_per_slice, int slices) {
  __shared__ float red_g[8][33];
  __shared__ float red_b[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const int m0 = blockIdx.y * rows_per_slice;
  const int m1 = min(M, m0 + rows_per_slice);
  float ag = 0.f, ab = 0.f;
  if (c < C)
    for (int m = m0 + ty; m < m1; m += 8) {
      const float dv = d[(size_t)m * C + c];
      ag += dv * ((to_f32(x[(size_t)m * C + c]) - mu[m]) * rstd[m]);
      ab += dv;
    }
  red_g[ty][tx] = ag;
  red_b[ty][tx] = ab;
  __syncthreads();
  if (ty == 0 && c < C) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sg += red_g[i][tx];
      sb += red_b[i][tx];
    }
    partial[(size_t)blockIdx.y * C + c] = sg;
    partial[((size_t)slices + blockIdx.y) * C + c] = sb;
  }
}

// out[o * C + c] = sum over the slices of partial[(o * slices + s) * C + c]
static __global__ void colsum_final(const float* __restrict__ partial,
                             float* __restrict__ out0, float* __restrict__ out1,
                             int slices, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float* out = blockIdx.y == 0 ? out0 : out1;
  const float* p = partial + (size_t)blockIdx.y * slices * C;
  float s = 0.f;
  for (int i = 0; i < slices; ++i) s += p[(size_t)i * C + c];
  out[c] = s;
}

template <typename T>
static void launch_colsum(const T* a, float* partial, float* out, int M, int C,
                          cudaStream_t stream) {
  const int slices = colsum_slices(M);
  const int rows = cdiv(M, slices);
  colsum_partial<T><<<dim3(cdiv(C, 32), slices), dim3(32, 8), 0, stream>>>(
      a, partial, M, C, rows);
  colsum_final<<<dim3(cdiv(C, 128), 1), 128, 0, stream>>>(partial, out, out,
                                                         slices, C);
}

template <typename TX>
static void launch_ln_colsum(const float* d, const TX* x, const float* mu,
                             const float* rstd, float* partial, float* dgain,
                             float* dbias, int M, int C, cudaStream_t stream) {
  const int slices = colsum_slices(M);
  const int rows = cdiv(M, slices);
  ln_colsum_partial<TX><<<dim3(cdiv(C, 32), slices), dim3(32, 8), 0, stream>>>(
      d, x, mu, rstd, partial, M, C, rows, slices);
  colsum_final<<<dim3(cdiv(C, 128), 2), 128, 0, stream>>>(partial, dgain,
                                                         dbias, slices, C);
}

// ---------------------------------------------------------------------------
// LayerNorm backward over rows, the statistics recomputed from the stashed
// input x: with dxhat = d * gain,
//   dx = add + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
// add being the gradient that reaches x through the residual (null: none,
// a tensor-parallel partial sum of a rank other than 0; dx is then an fp32
// TO). One warp per row; the row's mean and rstd are kept for ln_colsum.
// ---------------------------------------------------------------------------

template <typename T, typename TO = T>
__global__ void __launch_bounds__(LN_ROWS * 32)
layernorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ d,
                   const T* __restrict__ gain, const T* __restrict__ add,
                   TO* __restrict__ dx, float* __restrict__ mu_out,
                   float* __restrict__ rstd_out, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  const float* dr = d + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / (float)C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float t = to_f32(xr[c]) - mu;
    v += t * t;
  }
  const float rs = rsqrtf(warp_sum(v) / (float)C + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dxh = dr[c] * (gain != nullptr ? to_f32(gain[c]) : 1.f);
    s1 += dxh;
    s2 += dxh * ((to_f32(xr[c]) - mu) * rs);
  }
  const float m1 = warp_sum(s1) / (float)C, m2 = warp_sum(s2) / (float)C;
  const T* ar = add != nullptr ? add + (size_t)row * C : nullptr;
  TO* or_ = dx + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float dxh = dr[c] * (gain != nullptr ? to_f32(gain[c]) : 1.f);
    const float xh = (to_f32(xr[c]) - mu) * rs;
    or_[c] = from_f32<TO>((ar != nullptr ? to_f32(ar[c]) : 0.f) +
                          rs * (dxh - m1 - xh * m2));
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rs;
  }
}

}  // namespace afft

// Returns from the enclosing entry point with the launch's error, if any.
#define AFFT_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

// The same for a launcher that returns its own cudaError_t.
#define AFFT_CHECK(call)                        \
  do {                                          \
    cudaError_t err_ = (call);                  \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)
