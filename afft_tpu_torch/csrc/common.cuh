// Shared device code for the serving kernels of afft_tpu_torch.
//
// Every port entry (fused_block.cu, fused_gpt2.cu) is a short sequence of
// launches on one stream, built from the pieces below:
//   * layernorm_rows: one warp per row, fp32 statistics, output in the
//     working dtype (the rounding the TPU kernels apply before each matmul);
//   * gemm_bf16 / gemm_f32: C[M,N] = A[M,K] . W + bias with a fused
//     epilogue (GELU, residual add, cast). W is either (N,K) row-major
//     (nn.Linear) or (K,N) row-major (HF Conv1D), chosen at compile time,
//     so neither weight layout is repacked per call;
//   * small_attention: softmax attention over S <= 32 tokens, one block per
//     (sequence, head) and one warp per query token.
//
// The bf16 GEMM runs on the tensor cores through nvcuda::wmma (16x16x16,
// fp32 accumulation) with 128x128x32 shared-memory tiles, double-buffered by
// cp.async. The fp32 GEMM is plain FMA (no TF32), so fp32 parity checks
// compare true fp32 products. wgmma/TMA/warp specialisation are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
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
// GEMM epilogues
// ---------------------------------------------------------------------------

enum Epi {
  EPI_BIAS = 0,        // out = acc + bias
  EPI_BIAS_RES = 1,    // out = res + (acc + bias)
  EPI_GELU_ERF = 2,    // out = gelu_exact(acc + bias)
  EPI_GELU_TANH = 3,   // out = gelu_new(acc + bias)
};

struct EpiArgs {
  const void* bias;  // (N,) in the working dtype, or null
  const void* res;   // (M, N) residual, EPI_BIAS_RES only
  void* out;         // (M, N)
};

template <typename T, int EPI, typename TRes, typename TOut>
__device__ __forceinline__ void epilogue(const EpiArgs& ea, int M, int N,
                                         int row, int col, float acc) {
  if (row >= M || col >= N) return;
  float v = acc;
  if (ea.bias != nullptr) v += to_f32(static_cast<const T*>(ea.bias)[col]);
  if (EPI == EPI_GELU_ERF) {
    v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  } else if (EPI == EPI_GELU_TANH) {
    v = 0.5f * v *
        (1.f + tanhf(0.79788456080286536f * (v + 0.044715f * v * v * v)));
  } else if (EPI == EPI_BIAS_RES) {
    v = to_f32(static_cast<const TRes*>(ea.res)[(size_t)row * N + col]) + v;
  }
  static_cast<TOut*>(ea.out)[(size_t)row * N + col] = from_f32<TOut>(v);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core GEMM (wmma), 128x128x32 tiles, 8 warps of 64x32
// ---------------------------------------------------------------------------

constexpr int GB_M = 128, GB_N = 128, GB_K = 32, GB_PAD = 8;
constexpr int GB_THREADS = 256;
constexpr int GB_A_TILE = GB_M * (GB_K + GB_PAD);            // elements
constexpr int GB_B_TILE = GB_N * (GB_K + GB_PAD);            // >= KN tile
constexpr int GB_B_TILE_KN = GB_K * (GB_N + GB_PAD);
static_assert(GB_B_TILE_KN <= GB_B_TILE, "KN tile must fit the B stage");
constexpr int GB_SMEM = 2 * (GB_A_TILE + GB_B_TILE) * 2;      // bytes
static_assert(GB_SMEM <= 48 * 1024, "static shared memory limit");
static_assert(8 * 256 * 4 <= 2 * GB_A_TILE * 2, "epilogue staging fits");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A (M,K) row-major; W (K,N) row-major when B_KN else (N,K) row-major.
// Requires K % 8 == 0, N % 8 == 0 and 16-byte aligned A and W.
template <int EPI, bool B_KN, typename TRes, typename TOut>
__global__ void __launch_bounds__(GB_THREADS)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ W, int M,
          int N, int K, EpiArgs ea) {
  using namespace nvcuda;
  typedef typename std::conditional<B_KN, wmma::row_major,
                                    wmma::col_major>::type BLayout;
  __shared__ __align__(128) unsigned char smem[GB_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * GB_A_TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 2, warp_n = warp & 3;  // 2 x 4 warps
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * GB_K;
    bf16* as = As + stage * GB_A_TILE;
    bf16* bs = Bs + stage * GB_B_TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GB_THREADS;  // 512 chunks of 8 elements
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(as + r * (GB_K + GB_PAD) + kc,
                 ok ? A + (size_t)gr * K + gk : A, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GB_THREADS;
      if (B_KN) {
        const int r = c >> 4, nc = (c & 15) * 8;  // 32 k-rows x 16 chunks
        const int gk = k0 + r, gn = n0 + nc;
        const bool ok = gk < K && gn < N;
        cp_async16(bs + r * (GB_N + GB_PAD) + nc,
                   ok ? W + (size_t)gk * N + gn : W, ok);
      } else {
        const int r = c >> 2, kc = (c & 3) * 8;  // 128 n-rows x 4 chunks
        const int gn = n0 + r, gk = k0 + kc;
        const bool ok = gn < N && gk < K;
        cp_async16(bs + r * (GB_K + GB_PAD) + kc,
                   ok ? W + (size_t)gn * K + gk : W, ok);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + GB_K - 1) / GB_K;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = As + (kt & 1) * GB_A_TILE;
    const bf16* bs = Bs + (kt & 1) * GB_B_TILE;
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            fa[i], as + (warp_m * 64 + i * 16) * (GB_K + GB_PAD) + kk,
            GB_K + GB_PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nn = warp_n * 32 + j * 16;
        if (B_KN)
          wmma::load_matrix_sync(fb[j], bs + kk * (GB_N + GB_PAD) + nn,
                                 GB_N + GB_PAD);
        else
          wmma::load_matrix_sync(fb[j], bs + nn * (GB_K + GB_PAD) + kk,
                                 GB_K + GB_PAD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each warp stages one 16x16 fp32 fragment at a time
  float* stg = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stg, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + warp_m * 64 + i * 16 + r;
      const int col = n0 + warp_n * 32 + j * 16 + c0;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        epilogue<bf16, EPI, TRes, TOut>(ea, M, N, row, col + e,
                                        stg[r * 16 + c0 + e]);
      __syncwarp();
    }
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

template <int EPI, bool B_KN, typename TRes, typename TOut>
static void launch_gemm(const bf16* A, const bf16* W, int M, int N, int K,
                        EpiArgs ea, cudaStream_t stream) {
  dim3 grid(cdiv(N, GB_N), cdiv(M, GB_M));
  gemm_bf16<EPI, B_KN, TRes, TOut><<<grid, GB_THREADS, 0, stream>>>(A, W, M,
                                                                    N, K, ea);
}

// ---------------------------------------------------------------------------
// Attention over S <= 32 tokens: one block per (sequence, head), one warp per
// query. qkv rows are (seq * S + t) with [q | k | v] columns, heads minor.
// Scores and softmax in fp32; ROUND_P rounds the probabilities to T before
// the probability . v product (the GPT-2 kernel), else that product is fp32
// throughout (the fuser kernel).
// ---------------------------------------------------------------------------

template <typename T, bool ROUND_P>
__global__ void __launch_bounds__(1024)
small_attention(const T* __restrict__ qkv, const float* __restrict__ mask,
                T* __restrict__ out, int S, int H, int hd, float scale) {
  __shared__ float probs[32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * hd;
  const size_t ld = 3 * (size_t)C;
  const T* base = qkv + (size_t)seq * S * ld;
  const int tq = warp;
  const T* q = base + tq * ld + (size_t)h * hd;

  float mine = -INFINITY;  // lane tk keeps the score of key tk
  for (int tk = 0; tk < S; ++tk) {
    const T* k = base + tk * ld + C + (size_t)h * hd;
    float p = 0.f;
    for (int j = lane; j < hd; j += 32) p = fmaf(to_f32(q[j]), to_f32(k[j]), p);
    p = warp_sum(p);
    const float s = p * scale + (mask != nullptr ? mask[tq * S + tk] : 0.f);
    if (lane == tk) mine = s;
  }
  // every row keeps at least one finite score, so m is finite and the
  // masked lanes give exp(-inf) = 0
  const float m = warp_max(mine);
  const float e = lane < S ? expf(mine - m) : 0.f;
  float p = e / warp_sum(e);
  if (ROUND_P) p = to_f32(from_f32<T>(p));
  probs[warp][lane] = p;
  __syncwarp();

  const T* v = base + 2 * (size_t)C + (size_t)h * hd;
  T* o = out + ((size_t)seq * S + tq) * C + (size_t)h * hd;
  for (int j = lane; j < hd; j += 32) {
    float acc = 0.f;
    for (int tk = 0; tk < S; ++tk)
      acc = fmaf(probs[warp][tk], to_f32(v[tk * ld + j]), acc);
    o[j] = from_f32<T>(acc);
  }
}

template <typename T, bool ROUND_P>
static void launch_attention(const T* qkv, const float* mask, T* out,
                             int n_seq, int S, int H, int hd,
                             cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
  small_attention<T, ROUND_P><<<n_seq * H, S * 32, 0, stream>>>(
      qkv, mask, out, S, H, hd, scale);
}

}  // namespace afft

// Returns from the enclosing entry point with the launch's error, if any.
#define AFFT_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)
