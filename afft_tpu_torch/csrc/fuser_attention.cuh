// fuser_attention: the self-attention of the fuser blocks' serving forward,
// softmax(q . k^T * hd^-0.5 + mask) . v over packed qkv rows (seq * S + t)
// with [q | k | v] columns, heads minor: (n_seq * S, 3C) -> (n_seq * S, C).
//
// Replaces, for fused_block.cu (row 1: afft_tpu/ops/pallas_block.py
// _block_kernel) and seq_block.cu (row 5: pallas_seq_block.py
// _seq_block_kernel, and the self-attention stage of row 6), the attention
// that ran one warp per query with 2-byte loads and a serial loop over the
// keys, each query re-reading every key and value row of its (sequence,
// head) through L1 / L2. At the served shapes the step is bound by bytes:
// row 1 (R 4096 x 5 tokens, C 1024, bf16) reads 126 MB of qkv and writes 42
// MB (~0.05 ms at 3.35 TB/s) for ~0.2 GFLOP; row 5 (B 256, S 40, hd 256)
// reads 63 MB and writes 21 MB (~0.025 ms) for 1.7 GFLOP (17 GFLOP at S
// 128). Here every element of q, k and v is read from device memory once,
// 16 bytes at a time where the rows allow (hd a multiple of 8 in bf16, of 4
// in fp32; else one element at a time, so any hd is taken), into shared
// memory, and both products run from there:
//   * fuser_attention_rows (row 1, S <= 8): a block stages up to 32 tokens
//     of consecutive (row, head) pairs in chunks of 128 head columns; one
//     thread a (query, key) pair keeps its partial score in a register
//     across the chunks, one thread a query takes the softmax, and each
//     thread computes 16 bytes of P . V. The probabilities stay fp32
//     (pallas_block.py:164-176). Its DROP instance scales them by their
//     dropout multipliers first: the fuser's training forward and the
//     recomputation of it in the attention backward (train_block.cuh).
//   * fuser_attention_seq_mma (rows 5, 6 in bf16, S <= 1024): a block takes
//     a tile of up to 64 queries of one (sequence, head) and stages q and k
//     in chunks of 64 keys x 64 head columns; each warp multiplies a strip
//     of 16 queries by MT 8-key tiles on the tensor cores
//     (mma.sync.m16n8k16, bf16 in, fp32 accumulate). Every score of the
//     tile stays in shared memory, so the softmax is exact over all keys;
//     the probabilities are rounded to bf16 before P . V
//     (pallas_seq_block.py:90-99), so they enter the second product, which
//     runs the same way over 64-key chunks of v, exactly. The tile is 16
//     or 32 queries up to 16 or 32 keys and 64 up to 256 keys (k and v read
//     once up to 64 keys), then 32 and 16, so the scores fit the shared
//     memory.
//   * fuser_attention_seq_f32 (the same in fp32, for the parity checks):
//     tiles of 16 queries, q, k and v staged as fp32, each thread one query
//     x 4 keys (columns) of fp32 FMA on the CUDA cores.
// Scores and softmax in fp32, the scale applied after the dot, the row's
// max subtracted. A key whose mask entry is -inf scores -inf (its dot
// product is not used); a row whose keys are all masked gives zeros. Only
// the sums' order differs from the plain version (fused_block.py
// attention32).

#pragma once

#include "common.cuh"
#include "staged_attention.cuh"  // unpack16, pack16, dot_rows

namespace afft {

// ---------------------------------------------------------------------------
// row 1: S <= 8 tokens, fp32 probabilities
// ---------------------------------------------------------------------------

constexpr int FR_THREADS = 256;
constexpr int FR_TOKENS = 32;  // (pair, token) rows a block stages
constexpr int FR_HC = 128;     // head columns a chunk
constexpr int FR_MAX_N = 8;

// Rows r < rows of the block's pairs (pair g0 + r / N, token r % N), columns
// off + c0 .. off + c0 + w of each pair's head, into dst (row stride LD).
template <typename T>
__device__ __forceinline__ void stage_pairs(T* dst, const T* qkv, int g0,
                                            int rows, int N, int H, int hd,
                                            size_t ld, size_t off, int w,
                                            bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LD = FR_HC + V;
  const int step = vec ? V : 1, per_row = w / step;
  for (int i = threadIdx.x; i < rows * per_row; i += FR_THREADS) {
    const int r = i / per_row, c = (i % per_row) * step;
    const int g = g0 + r / N, t = r % N;
    const T* src = qkv + ((size_t)(g / H) * N + t) * ld + (size_t)(g % H) * hd +
                   off + c;
    if (vec)
      *reinterpret_cast<uint4*>(dst + r * LD + c) =
          *reinterpret_cast<const uint4*>(src);
    else
      dst[r * LD + c] = *src;
  }
}

// With DROP, each probability is then scaled by its keep multiplier
// drop_scale(drop, (g * N + tq) * N + tk), g = row * H + head: the fuser's
// training forward (pallas_block_train.py:156-187), still fp32.
template <typename T, bool DROP>
__global__ void __launch_bounds__(FR_THREADS)
fuser_attention_rows(const T* __restrict__ qkv, const float* __restrict__ mask,
                     T* __restrict__ out, int n_pairs, int N, int H, int hd,
                     float scale, DropSite drop) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LD = FR_HC + V;  // 16 bytes of padding a row
  __shared__ __align__(16) T qs[FR_TOKENS * LD];  // a q chunk, later v
  __shared__ __align__(16) T ks[FR_TOKENS * LD];
  __shared__ float pr[FR_TOKENS][FR_MAX_N + 1];    // scores, probabilities
  const int per = FR_TOKENS / N;                   // pairs a block
  const int g0 = blockIdx.x * per;
  const int rows = min(per, n_pairs - g0) * N;
  const int C = H * hd, tid = threadIdx.x;
  const size_t ld = 3 * (size_t)C;
  // every row and chunk start is then 16-byte aligned
  const bool vec = hd % V == 0;

  // thread tid < rows * N: the score of row r (token tq of its pair) and
  // key tk of the same pair
  const int r = tid / N, tk = tid % N, tq = r % N;
  const bool scorer = tid < rows * N;
  const float add =
      scorer && mask != nullptr ? mask[tq * N + tk] : 0.f;
  float acc = 0.f;
  for (int c0 = 0; c0 < hd; c0 += FR_HC) {
    const int w = min(FR_HC, hd - c0);
    stage_pairs<T>(qs, qkv, g0, rows, N, H, hd, ld, c0, w, vec);
    stage_pairs<T>(ks, qkv, g0, rows, N, H, hd, ld, C + c0, w, vec);
    __syncthreads();
    if (scorer && add != -INFINITY)
      acc = dot_rows<T>(qs + r * LD, ks + (r - tq + tk) * LD, w, vec, acc);
    __syncthreads();
  }
  if (scorer) pr[r][tk] = add != -INFINITY ? acc * scale + add : -INFINITY;
  // the keep multiplier of this thread's (query, key), drawn meanwhile
  const float keep =
      DROP && scorer
          ? drop_scale(drop,
                       ((unsigned long long)(g0 + r / N) * N + tq) * N + tk)
          : 1.f;
  __syncthreads();

  // softmax, one thread a row; the probabilities are not rounded
  if (tid < rows) {
    float m = -INFINITY;
    for (int k = 0; k < N; ++k) m = fmaxf(m, pr[tid][k]);
    if (m == -INFINITY) m = 0.f;  // every key masked: all exp() below are 0
    float sum = 0.f;
    for (int k = 0; k < N; ++k) {
      const float e = expf(pr[tid][k] - m);
      pr[tid][k] = e;
      sum += e;
    }
    for (int k = 0; k < N; ++k)
      pr[tid][k] = sum > 0.f ? pr[tid][k] / sum : 0.f;
  }
  __syncthreads();
  // dropout after the division; the staging barrier below orders it
  // before P . V reads pr
  if (DROP && scorer) pr[r][tk] *= keep;

  // P . V: a thread takes V consecutive columns of one row (one column
  // where the rows are not 16-byte aligned)
  const int step = vec ? V : 1;
  for (int c0 = 0; c0 < hd; c0 += FR_HC) {
    const int w = min(FR_HC, hd - c0), groups = w / step;
    stage_pairs<T>(qs, qkv, g0, rows, N, H, hd, ld, 2 * (size_t)C + c0, w,
                   vec);
    __syncthreads();
    for (int e = tid; e < rows * groups; e += FR_THREADS) {
      const int rr = e / groups, j = (e % groups) * step;
      const int g = g0 + rr / N, t = rr % N;
      const T* v0 = qs + (rr - t) * LD + j;  // the pair's token 0
      T* o = out + ((size_t)(g / H) * N + t) * C + (size_t)(g % H) * hd +
             c0 + j;
      if (vec) {
        float a[V];
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = 0.f;
        for (int k = 0; k < N; ++k) {
          const float p = pr[rr][k];
          float v[V];
          unpack16<T>(*reinterpret_cast<const uint4*>(v0 + k * LD), v);
#pragma unroll
          for (int i = 0; i < V; ++i) a[i] = fmaf(p, v[i], a[i]);
        }
        *reinterpret_cast<uint4*>(o) = pack16<T>(a);
      } else {
        float a = 0.f;
        for (int k = 0; k < N; ++k)
          a = fmaf(pr[rr][k], to_f32(v0[k * LD]), a);
        *o = from_f32<T>(a);
      }
    }
    __syncthreads();
  }
}

// With DROP, dropout on the probabilities at ``drop``. Returns
// cudaErrorInvalidValue for S outside 1..8 (nothing launched).
template <typename T, bool DROP = false>
static cudaError_t launch_fuser_attention_rows(const T* qkv, const float* mask,
                                               T* out, int n_seq, int S, int H,
                                               int hd, cudaStream_t stream,
                                               DropSite drop = DropSite{}) {
  if (S < 1 || S > FR_MAX_N) return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
  const int pairs = n_seq * H;
  fuser_attention_rows<T, DROP><<<cdiv(pairs, FR_TOKENS / S), FR_THREADS, 0,
                                  stream>>>(qkv, mask, out, pairs, S, H, hd,
                                            scale, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// rows 5 and 6: S <= 1024 tokens, probabilities rounded to T
// ---------------------------------------------------------------------------

constexpr int FS_THREADS = 256;  // 8 warps
constexpr int FS_KC = 64;        // keys a chunk
constexpr int FS_HC = 64;        // head columns a chunk
constexpr int FS_MAX_KEYS = 1024;

// Softmax of rows 0 .. QT of sc (row stride SP; keys past S hold -inf), one
// warp a row: fp32, the max subtracted, divided, rounded to T.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* sc, int QT, int SP,
                                             int kend) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += FS_THREADS / 32) {
    float* row = sc + r * SP;
    float m = -INFINITY;
    for (int k = lane; k < kend; k += 32) m = fmaxf(m, row[k]);
    m = warp_max(m);
    if (m == -INFINITY) m = 0.f;  // every key masked: all exp() below are 0
    float sum = 0.f;
    for (int k = lane; k < kend; k += 32) {
      const float e = expf(row[k] - m);
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < kend; k += 32) {
      const float p = sum > 0.f ? row[k] / sum : 0.f;
      row[k] = to_f32(from_f32<T>(p));
    }
  }
}

// The score of query q and key k from their fp32 dot: scaled, masked, -inf
// past S or where the mask is -inf.
__device__ __forceinline__ float masked_score(float dot, const float* mask,
                                              int q, int k, int S,
                                              float scale) {
  if (q >= S || k >= S) return -INFINITY;
  const float add = mask != nullptr ? mask[(size_t)q * S + k] : 0.f;
  return add != -INFINITY ? dot * scale + add : -INFINITY;
}

// D(16x8, fp32) += A(16x16, row) . B(16x8, col), bf16 operands
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two consecutive bf16 as one register (the lower column in the low half)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair_of(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pair_of(float lo, float hi) {
  return pair_of(__float2bfloat16(lo), __float2bfloat16(hi));
}

constexpr int FM_LD = FS_HC + 8;  // bf16 row stride: 16 bytes of padding,
                                  // so the 8 rows of a fragment load fall in
                                  // 8 different bank quads

// Rows r0 .. r0 + n of one bf16 operand (row stride ld, column offset folded
// into src), columns 0 .. FS_HC, into dst (row stride FM_LD): zeros at or
// past S and at or past column w, so every 16-column step of the products
// reads zeros there.
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           size_t ld, int r0, int n, int S,
                                           int w, bool vec) {
  if (vec) {  // w % 8 == 0
    for (int i = threadIdx.x; i < n * (FS_HC / 8); i += FS_THREADS) {
      const int r = i / (FS_HC / 8), c = (i % (FS_HC / 8)) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < S && c < w)
        u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c);
      *reinterpret_cast<uint4*>(dst + r * FM_LD + c) = u;
    }
  } else {
    for (int i = threadIdx.x; i < n * FS_HC; i += FS_THREADS) {
      const int r = i / FS_HC, c = i % FS_HC;
      dst[r * FM_LD + c] = r0 + r < S && c < w
                               ? src[(size_t)(r0 + r) * ld + c]
                               : __float2bfloat16(0.f);
    }
  }
}

// One block a (sequence, head, tile of 16 * MT queries), bf16. Warp w takes
// the 16 queries of strip w / (8 / MT) and MT of the 8-wide key (column)
// tiles, from tile (w % (8 / MT)) * MT on. Dynamic shared memory:
// fuser_attention_seq_mma_smem(MT, S) bytes.
template <int MT>
__global__ void __launch_bounds__(FS_THREADS)
fuser_attention_seq_mma(const bf16* __restrict__ qkv,
                        const float* __restrict__ mask, bf16* __restrict__ out,
                        int S, int H, int hd, float scale) {
  constexpr int QT = 16 * MT, WPM = 8 / MT;  // queries; warps a strip
  extern __shared__ __align__(16) float fs_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fs_smem);    // [QT][FM_LD]: a q chunk
  bf16* ks = qs + QT * FM_LD;                     // [FS_KC][FM_LD]: k, or v
  float* sc = reinterpret_cast<float*>(ks + FS_KC * FM_LD);  // [QT][SP]
  const int nkc = (S + FS_KC - 1) / FS_KC, kend = nkc * FS_KC;
  const int SP = kend + 1;
  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * hd, q0 = blockIdx.y * QT;
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)seq * S * ld + (size_t)h * hd;
  const bool vec = hd % 8 == 0;  // then every row and chunk start is aligned
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' row and pair
  const int m0 = (warp / WPM) * 16;       // the warp's strip in the tile
  const int n0 = (warp % WPM) * MT * 8;   // its first key (column) in 64

  // 1. the tile's scores against every key, 64 keys at a time
  for (int kc = 0; kc < nkc; ++kc) {
    const int k0 = kc * FS_KC;
    float acc[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += FS_HC) {
      const int w = min(FS_HC, hd - c0);
      __syncthreads();  // the previous chunk is read
      stage_bf16(qs, base + c0, ld, q0, QT, S, w, vec);
      stage_bf16(ks, base + C + c0, ld, k0, FS_KC, S, w, vec);
      __syncthreads();
      for (int kk = 0; kk < (w + 15) / 16; ++kk) {
        const bf16* qa = qs + (m0 + g) * FM_LD + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * FM_LD),
                               ld_pair(qa + 8), ld_pair(qa + 8 * FM_LD + 8)};
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const bf16* kb = ks + (n0 + j * 8 + g) * FM_LD + kk * 16 + 2 * t;
          const uint32_t b[2] = {ld_pair(kb), ld_pair(kb + 8)};
          mma_16816(acc[j], a, b);
        }
      }
    }
    // accumulator e: row m0 + g (+ 8 for e >= 2), key n0 + 8j + 2t (+ 1)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + g + (e >> 1) * 8, k = k0 + n0 + j * 8 + 2 * t +
                                                 (e & 1);
        sc[r * SP + k] = masked_score(acc[j][e], mask, q0 + r, k, S, scale);
      }
  }
  __syncthreads();

  // 2. softmax
  softmax_rows<bf16>(sc, QT, SP, kend);

  // 3. P . V, 64 head columns at a time, over every key chunk in order; the
  // probabilities are bf16 values, so packing them is exact
  bf16* obase = out + (size_t)seq * S * C + (size_t)h * hd;
  for (int c0 = 0; c0 < hd; c0 += FS_HC) {
    const int w = min(FS_HC, hd - c0);
    float o[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int kc = 0; kc < nkc; ++kc) {
      const int k0 = kc * FS_KC;
      __syncthreads();  // the softmax, or the previous chunk, is done
      stage_bf16(ks, base + 2 * (size_t)C + c0, ld, k0, FS_KC, S, w, vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FS_KC / 16; ++kk) {
        const float* pa = sc + (m0 + g) * SP + k0 + kk * 16 + 2 * t;
        const uint32_t a[4] = {pair_of(pa[0], pa[1]),
                               pair_of(pa[8 * SP], pa[8 * SP + 1]),
                               pair_of(pa[8], pa[9]),
                               pair_of(pa[8 * SP + 8], pa[8 * SP + 9])};
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          // B (keys x columns): keys 2t, 2t + 1 (+ 8) of column n0 + 8j + g
          const bf16* vb = ks + (kk * 16 + 2 * t) * FM_LD + n0 + j * 8 + g;
          const uint32_t b[2] = {pair_of(vb[0], vb[FM_LD]),
                                 pair_of(vb[8 * FM_LD], vb[9 * FM_LD])};
          mma_16816(o[j], a, b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + m0 + g + (e >> 1) * 8;
        const int c = n0 + j * 8 + 2 * t + (e & 1);
        if (q < S && c < w)
          obase[(size_t)q * C + c0 + c] = __float2bfloat16(o[j][e]);
      }
  }
}

static inline size_t fuser_attention_seq_mma_smem(int MT, int S) {
  const int QT = 16 * MT;
  return (size_t)(QT + FS_KC) * FM_LD * sizeof(bf16) +
         (size_t)QT * (cdiv(S, FS_KC) * FS_KC + 1) * sizeof(float);
}

template <int MT>
static cudaError_t launch_fuser_attention_seq_mma(const bf16* qkv,
                                                  const float* mask, bf16* out,
                                                  int n_seq, int S, int H,
                                                  int hd,
                                                  cudaStream_t stream) {
  const size_t smem = fuser_attention_seq_mma_smem(MT, S);
  const cudaError_t err = cudaFuncSetAttribute(
      fuser_attention_seq_mma<MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
  const dim3 grid(n_seq * H, cdiv(S, 16 * MT));
  fuser_attention_seq_mma<MT><<<grid, FS_THREADS, smem, stream>>>(
      qkv, mask, out, S, H, hd, scale);
  return cudaGetLastError();
}

// ---- fp32: the CUDA cores, a tile of 16 queries --------------------------

constexpr int FF_QT = 16;            // queries a block
constexpr int FF_QLD = FF_QT + 4;    // row stride of the transposed q chunk
constexpr int FF_KLD = FS_KC + 4;    // row stride of a staged k / v chunk

// Rows r0 .. r0 + n of one fp32 operand (row stride ld, column offset
// folded into src), columns 0 .. w, into dst: at [c * dld + r] with TRANS,
// else [r * dld + c]. Rows at or past S are zeros.
template <bool TRANS>
__device__ __forceinline__ void stage_f32(float* dst, int dld, const float* src,
                                          size_t ld, int r0, int n, int S,
                                          int w, bool vec) {
  const int step = vec ? 4 : 1, per_row = w / step;
  for (int i = threadIdx.x; i < n * per_row; i += FS_THREADS) {
    const int r = i / per_row, c = (i % per_row) * step;
    const bool in = r0 + r < S;
    const float* s = src + (size_t)(r0 + r) * ld + c;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (in && vec)
      unpack16<float>(*reinterpret_cast<const uint4*>(s), f);
    else if (in)
      f[0] = *s;
    for (int e = 0; e < step; ++e) {
      if (TRANS)
        dst[(c + e) * dld + r] = f[e];
      else
        dst[r * dld + c + e] = f[e];
    }
  }
}

// One block a (sequence, head, tile of 16 queries); thread (ty, tx) takes
// query ty and keys (columns) 4 tx .. 4 tx + 3 of a chunk. Dynamic shared
// memory: fuser_attention_seq_f32_smem(S) bytes. (Not a template, so static:
// every .cu that includes this header gets its own.)
static __global__ void __launch_bounds__(FS_THREADS)
fuser_attention_seq_f32(const float* __restrict__ qkv,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int S, int H, int hd,
                        float scale) {
  extern __shared__ __align__(16) float fs_smem[];
  float* qs = fs_smem;                  // [FS_HC][FF_QLD]: q, transposed
  float* ks = qs + FS_HC * FF_QLD;      // [FS_HC][FF_KLD]: k, transposed;
                                        // later [FS_KC][FF_KLD] v
  float* sc = ks + FS_HC * FF_KLD;      // [FF_QT][SP]: scores, probabilities
  const int nkc = (S + FS_KC - 1) / FS_KC, kend = nkc * FS_KC;
  const int SP = kend + 1;
  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * hd, q0 = blockIdx.y * FF_QT;
  const size_t ld = 3 * (size_t)C;
  const float* base = qkv + (size_t)seq * S * ld + (size_t)h * hd;
  const bool vec = hd % 4 == 0;  // then every row and chunk start is aligned
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  // 1. the tile's scores against every key, 64 keys at a time
  for (int kc = 0; kc < nkc; ++kc) {
    const int k0 = kc * FS_KC;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < hd; c0 += FS_HC) {
      const int w = min(FS_HC, hd - c0);
      __syncthreads();  // the previous chunk is read
      stage_f32<true>(qs, FF_QLD, base + c0, ld, q0, FF_QT, S, w, vec);
      stage_f32<true>(ks, FF_KLD, base + C + c0, ld, k0, FS_KC, S, w, vec);
      __syncthreads();
      for (int c = 0; c < w; ++c) {
        const float a = qs[c * FF_QLD + ty];
        const float4 b =
            *reinterpret_cast<const float4*>(ks + c * FF_KLD + tx * 4);
        acc[0] = fmaf(a, b.x, acc[0]);
        acc[1] = fmaf(a, b.y, acc[1]);
        acc[2] = fmaf(a, b.z, acc[2]);
        acc[3] = fmaf(a, b.w, acc[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[ty * SP + k0 + tx * 4 + j] =
          masked_score(acc[j], mask, q0 + ty, k0 + tx * 4 + j, S, scale);
  }
  __syncthreads();

  // 2. softmax
  softmax_rows<float>(sc, FF_QT, SP, kend);

  // 3. P . V, 64 head columns at a time, over every key chunk in order
  float* obase = out + (size_t)seq * S * C + (size_t)h * hd;
  for (int c0 = 0; c0 < hd; c0 += FS_HC) {
    const int w = min(FS_HC, hd - c0);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kc = 0; kc < nkc; ++kc) {
      const int k0 = kc * FS_KC;
      __syncthreads();  // the softmax, or the previous chunk, is done
      stage_f32<false>(ks, FF_KLD, base + 2 * (size_t)C + c0, ld, k0, FS_KC,
                       S, w, vec);
      __syncthreads();
      for (int k = 0; k < FS_KC; ++k) {
        const float p = sc[ty * SP + k0 + k];
        const float4 v =
            *reinterpret_cast<const float4*>(ks + k * FF_KLD + tx * 4);
        o[0] = fmaf(p, v.x, o[0]);
        o[1] = fmaf(p, v.y, o[1]);
        o[2] = fmaf(p, v.z, o[2]);
        o[3] = fmaf(p, v.w, o[3]);
      }
    }
    const int q = q0 + ty;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q < S && tx * 4 + j < w)
        obase[(size_t)q * C + c0 + tx * 4 + j] = o[j];
  }
}

static inline size_t fuser_attention_seq_f32_smem(int S) {
  return ((size_t)FS_HC * (FF_QLD + FF_KLD) +
          (size_t)FF_QT * (cdiv(S, FS_KC) * FS_KC + 1)) *
         sizeof(float);
}

// bf16 on the tensor cores, a tile of 16 or 32 queries up to 16 or 32 keys
// and of 64 up to 256 keys (k and v read once up to 64 keys), then 32 and 16
// (the tile's scores stay <= 64 KB); fp32 on the CUDA cores, 16 queries a
// tile. Returns cudaErrorInvalidValue for S outside 1..1024 (nothing
// launched).
template <typename T>
static cudaError_t launch_fuser_attention_seq(const T* qkv, const float* mask,
                                              T* out, int n_seq, int S, int H,
                                              int hd, cudaStream_t stream) {
  if (S < 1 || S > FS_MAX_KEYS) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    if (S <= 16 || S > 512)
      return launch_fuser_attention_seq_mma<1>(qkv, mask, out, n_seq, S, H,
                                               hd, stream);
    if (S <= 32 || S > 256)
      return launch_fuser_attention_seq_mma<2>(qkv, mask, out, n_seq, S, H,
                                               hd, stream);
    return launch_fuser_attention_seq_mma<4>(qkv, mask, out, n_seq, S, H, hd,
                                             stream);
  } else {
    const size_t smem = fuser_attention_seq_f32_smem(S);
    const cudaError_t err = cudaFuncSetAttribute(
        fuser_attention_seq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
    const dim3 grid(n_seq * H, cdiv(S, FF_QT));
    fuser_attention_seq_f32<<<grid, FS_THREADS, smem, stream>>>(
        qkv, mask, out, S, H, hd, scale);
    return cudaGetLastError();
  }
}

}  // namespace afft
