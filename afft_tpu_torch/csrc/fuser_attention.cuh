// fuser_attention: the attentions of the fuser blocks' serving forward and
// of the attention over separate q, k, v.
//
// Replaces the attentions of the TPU kernels of row 1 (afft_tpu/ops/
// pallas_block.py _block_kernel, for fused_block.cu), row 4 (pallas_attn.py
// _attn_kernel: the KV-cache rollout and CrossAttention, for attention.cu),
// row 5 (pallas_seq_block.py _seq_block_kernel) and row 6 (its
// _decoder_block_kernel's self-attention and cross-attention,
// pallas_seq_block.py:104-132; both for seq_block.cu). At the served shapes
// the step is bound by bytes: row 1 (R 4096 x 5 tokens, C 1024, bf16) reads
// 126 MB of qkv and writes 42 MB (~0.05 ms at 3.35 TB/s); row 5 (B 256, S
// 40, hd 256) reads 63 MB and writes 21 MB (~0.025 ms) for 1.7 GFLOP (17
// GFLOP at S 128); row 4 at the rollout (B 256, 4 heads of 512) reads and
// writes 67 MB at prefill (16 queries, 19 cache slots; ~0.020 ms) and 38 MB
// a decode step (one query; ~0.011 ms). Every element of q, k and v is read
// from device memory once a tile, 16 bytes at a time where the rows allow
// (hd a multiple of 8 in bf16, of 4 in fp32, with row strides to match;
// else one element at a time, so any hd is taken), into shared memory, and
// both products run from there:
//   * fuser_attention_rows (row 1, S <= 8, packed qkv; past 8 tokens the
//     entries take long_attention.cuh): a block stages up to
//     32 tokens of consecutive (row, head) pairs in chunks of 128 head
//     columns; one thread a (query, key) pair keeps its partial score in a
//     register across the chunks, one thread a query takes the softmax, and
//     each thread computes 16 bytes of P . V. The probabilities stay fp32
//     (pallas_block.py:164-176). Its DROP instance scales them by their
//     dropout multipliers first: the fuser's training forward
//     (train_block.cuh), whose output attention_bwd.cuh recomputes bit for
//     bit in the attention backward.
//   * fuser_attention_seq_mma (rows 4, 5, 6 in bf16, Nk <= 1024; past that
//     the long route of long_attention.cuh): q, k and
//     v are three strided operands (sequence, token and head strides: packed
//     qkv rows, a column slice of a packed projection, (B, Tmax, H, hd)
//     caches, three (M, C) buffers), nothing is copied first. A block takes
//     a tile of up to 64 queries of one (sequence, head). The tile's mask is
//     read once into the score buffer, which tells which keys some query of
//     the tile sees: a 64-key chunk that no query sees is neither read nor
//     multiplied (half the chunks of a causal tile at S 1024, the unwritten
//     cache slots of the rollout), and a key row no query sees is staged as
//     zeros, so what lies in a masked slot never reaches the result. Only
//     the rows of queries and keys that exist are staged. The chunks (64
//     keys x 128 or 64 head columns) of q and k, then of v, stream through
//     a ring of cp.async copies, one or two in flight while one is
//     multiplied: one barrier a chunk, and up to 64 keys (the rollout's 19,
//     the decoder's 10, row 5's 40) k and v are read from device memory
//     once a block. Each warp multiplies a strip of 16 queries by MT 8-key
//     tiles on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
//     accumulate; v's fragments through ldmatrix.trans). Every score of the
//     tile stays in shared memory, so the softmax is exact over all keys;
//     the probabilities are rounded to bf16 before P . V (pallas_attn.py:
//     64-70, pallas_seq_block.py:90-99), so they enter the second product
//     exactly. The tile is 16 queries up to 16 queries (a decode step's one
//     query takes a 16-row tile: the step is bound by its k and v bytes) or
//     beyond 512 keys, 32 up to 32 queries or beyond 256 keys, else 64, so
//     the scores fit the shared memory. At the rollout's shapes what bounds
//     a block is its work per chunk (barriers, index arithmetic), not the
//     copies in flight: wider chunks and more blocks an SM are what moved
//     its time (PERF.md).
//   * fuser_attention_seq_f32 (the same operands in fp32, for the parity
//     checks and the fp32 serving path): tiles of 16 queries staged
//     synchronously as fp32, each thread one query x 4 keys (columns) of fp32
//     FMA on the CUDA cores.
// Scores and softmax in fp32, the scale applied after the dot, the row's
// max subtracted, the probabilities divided in fp32. A key whose mask entry
// is -inf scores -inf (its dot product is not used); a row whose keys are
// all masked gives zeros. Only the sums' order differs from the plain
// versions (ops/_common.py softmax_attention32).

#pragma once

#include "common.cuh"
#include "long_attention.cuh"    // AttnStrides, the route past 1,024 keys
#include "mma_tiles.cuh"         // cp.async, mma.sync and fragment loads
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
// the sequence attention: Nq queries over 1 <= Nk <= 1024 keys (past that,
// long_attention.cuh), q / k / v strided, probabilities rounded to T (rows
// 4, 5, 6)
// ---------------------------------------------------------------------------

// AttnStrides (long_attention.cuh): the operands' sequence, token and head
// strides.

constexpr int FS_THREADS = 256;  // 8 warps
constexpr int FS_KC = 64;        // keys a chunk
constexpr int FS_HC = 64;        // head columns a chunk (fp32)
constexpr int FS_MAX_KEYS = 1024;
constexpr int FS_MAX_CHUNKS = FS_MAX_KEYS / FS_KC;
// blocks an SM holds: 64 registers a thread. More blocks in flight beat a
// few spilled registers (4 against 2 blocks: 20% less time at the
// rollout's shapes, NVIDIA H100 80GB HBM3)
constexpr int FS_MIN_BLOCKS = 4;

// The tile's mask, read from device memory once: sc[r][k] (row stride SP)
// = the additive mask of query q0 + r and key k (0 without a mask), -inf
// past Nk, for the tile's queries (the rows past Nq are left as they are:
// their scores are never used); live[k] = some query of the tile sees key
// k; chunks[] the 64-key chunks that hold a live key, in order. Returns
// their number (every thread); ends with a barrier. kend is a multiple of
// 64, so a warp's 32 keys take the same trips of the loop.
__device__ __forceinline__ int stage_mask(float* sc, int QT, int SP, int kend,
                                          const float* mask, int q0, int Nq,
                                          int Nk, unsigned char* live,
                                          unsigned char* live32, int* chunks,
                                          int* n_chunks) {
  const int tid = threadIdx.x, rows = min(QT, Nq - q0);
  for (int k = tid; k < kend; k += FS_THREADS) {
    bool l = false;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float m = -INFINITY;
      if (k < Nk) m = mask != nullptr ? mask[(size_t)(q0 + r) * Nk + k] : 0.f;
      sc[r * SP + k] = m;
      l |= m != -INFINITY;
    }
    live[k] = l;
    const bool any = __any_sync(0xffffffffu, l);
    if ((tid & 31) == 0) live32[k >> 5] = any;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int c = 0; c < kend / FS_KC; ++c)
      if (live32[2 * c] | live32[2 * c + 1]) chunks[n++] = c;
    *n_chunks = n;
  }
  __syncthreads();
  return *n_chunks;
}

// Softmax of rows 0 .. rows of sc (row stride SP; keys past Nk hold -inf),
// one warp a row: fp32, the max subtracted, divided, rounded to T. A masked
// key's probability is 0.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* sc, int rows, int SP,
                                             int kend) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += FS_THREADS / 32) {
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

// The score of a (query, key) from its fp32 dot and its mask entry m.
__device__ __forceinline__ float masked_score(float dot, float m, float scale) {
  return m != -INFINITY ? dot * scale + m : -INFINITY;
}

// One block a (sequence, head, tile of QT = 16 * MT queries), bf16. Warp w
// takes the 16 queries of strip w / (8 / MT) and MT of the 8-wide key (or
// column) tiles of each 64-wide group, from tile (w % (8 / MT)) * MT on.
// Scores: the chunks (live key chunk of 64, HC head columns) of q and k
// stream through a ring of NST stages of cp.async copies, NST - 1 in flight
// while one is multiplied (one barrier a chunk); every score stays in
// shared memory. P . V: the chunks (HC head columns, live key chunk) of v
// stream through the same ring. The chunks are walked with cursors, not
// divisions: at the rollout's shapes the block is bound by its work per
// chunk (index arithmetic, barriers), not by the copies in flight.
// Dynamic shared memory: fuser_attention_seq_mma_smem<MT, NST, HC>(Nk)
// bytes.
template <int MT, int NST, int HC>
__global__ void __launch_bounds__(FS_THREADS, FS_MIN_BLOCKS)
fuser_attention_seq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, AttnStrides qs,
                        AttnStrides ks, AttnStrides vs,
                        const float* __restrict__ mask, bf16* __restrict__ out,
                        int Nq, int Nk, int H, int hd, float scale, bool vec) {
  constexpr int QT = 16 * MT, WPM = 8 / MT;  // queries; warps a strip
  constexpr int LD = HC + 8;                   // bf16 row stride
  constexpr int STAGE = (QT + FS_KC) * LD;     // a q chunk, a k or v chunk
  constexpr int NG = HC / 64;                  // 64-column groups a chunk
  extern __shared__ __align__(16) float fs_smem[];
  __shared__ int chunks[FS_MAX_CHUNKS], n_chunks;
  __shared__ unsigned char live32[FS_MAX_KEYS / 32];
  bf16* stages = reinterpret_cast<bf16*>(fs_smem);
  const int nkc = (Nk + FS_KC - 1) / FS_KC, kend = nkc * FS_KC;
  const int SP = kend + 1;
  float* sc = reinterpret_cast<float*>(stages + NST * STAGE);  // [QT][SP]
  unsigned char* live = reinterpret_cast<unsigned char*>(sc + QT * SP);
  const int seq = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * QT;
  const bf16* qb = q + seq * qs.b + h * qs.h;
  const bf16* kb = k + seq * ks.b + h * ks.h;
  const bf16* vb = v + seq * vs.b + h * vs.h;
  const int nhc = (hd + HC - 1) / HC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' row and pair
  const int m0 = (warp / WPM) * 16;       // the warp's strip in the tile
  const int n0 = (warp % WPM) * MT * 8;   // its first key / column in 64
  const int nq = min(QT, Nq - q0);        // the tile's queries

  // the q chunk of the first item does not depend on the mask: its copies
  // are in flight while the mask is read
  stage_rows<FS_THREADS>(stages, LD, qb, qs.t, q0, nq, 0, Nq - 1, nullptr, HC,
                         min(HC, hd), vec);
  const int nlive = stage_mask(sc, QT, SP, kend, mask, q0, Nq, Nk, live,
                               live32, chunks, &n_chunks);

  // 1. the tile's scores against the live key chunks; item (ci, cc) = (key
  // chunk chunks[ci], head columns cc * HC), cc fastest; the items' q and
  // k chunks stream through the ring (mma_tiles.cuh), the k rows of keys
  // that are not live staged as zeros
  const int n1 = nlive * nhc;
  int ici = 0, icc = 0;  // the next item to issue
  auto issue1 = [&](int i, int buf) {
    bf16* st = stages + buf * STAGE;
    const int c0 = icc * HC, w = min(HC, hd - c0), k0 = chunks[ici] * FS_KC;
    if (i > 0)  // item 0's q chunk is staged above
      stage_rows<FS_THREADS>(st, LD, qb + c0, qs.t, q0, nq, 0, Nq - 1,
                             nullptr, HC, w, vec);
    stage_rows<FS_THREADS>(st + QT * LD, LD, kb + c0, ks.t, k0,
                           min(FS_KC, Nk - k0), 0, Nk - 1, live, HC, w, vec);
    if (++icc == nhc) icc = 0, ++ici;
  };
  float acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  int ci = 0, cc = 0;  // the item multiplied
  auto use1 = [&](int, int buf) {
    const bf16* qsm = stages + buf * STAGE;
    const bf16* ksm = qsm + QT * LD;
    const int k0 = chunks[ci] * FS_KC, w = min(HC, hd - cc * HC);
    if (k0 + n0 < Nk) {  // else every key of the warp's tiles is past Nk
      for (int kk = 0; kk < (w + 15) / 16; ++kk) {
        const bf16* qa = qsm + (m0 + g) * LD + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LD),
                               ld_pair(qa + 8), ld_pair(qa + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const bf16* kp = ksm + (n0 + j * 8 + g) * LD + kk * 16 + 2 * t;
          const uint32_t b[2] = {ld_pair(kp), ld_pair(kp + 8)};
          mma_16816(acc[j], a, b);
        }
      }
    }
    if (++cc == nhc) {
      // accumulator e: row m0 + g (+ 8 for e >= 2), key n0 + 8j + 2t (+ 1)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* s = sc + (m0 + g + (e >> 1) * 8) * SP + k0 + n0 + j * 8 +
                     2 * t + (e & 1);
          *s = masked_score(acc[j][e], *s, scale);
          acc[j][e] = 0.f;
        }
      cc = 0, ++ci;
    }
  };
  ring_run<NST>(n1, issue1, use1);  // every score is written; the ring is free

  // 3. P . V; item (cc, ci) = (head columns cc * HC, key chunk chunks[ci]),
  // ci fastest, v into the ring's k slots, its first chunks in flight
  // during the softmax
  const int n3 = nlive * nhc;
  ici = 0, icc = 0;
  auto issue3 = [&](int, int buf) {
    const int c0 = icc * HC, k0 = chunks[ici] * FS_KC;
    stage_rows<FS_THREADS>(stages + buf * STAGE + QT * LD, LD, vb + c0, vs.t,
                           k0, min(FS_KC, (Nk - k0 + 15) / 16 * 16), 0,
                           Nk - 1, live, HC, min(HC, hd - c0), vec);
    if (++ici == nlive) ici = 0, ++icc;
  };
  ring_fill<NST>(n3, issue3);

  // 2. softmax; the probabilities are bf16 values, so packing them is exact
  softmax_rows<bf16>(sc, nq, SP, kend);

  bf16* ob = out + ((size_t)seq * Nq * H + h) * hd;
  const size_t orow = (size_t)H * hd;  // elements between output rows
  float o[NG][MT][4];
  ci = 0, cc = 0;
  // the ring's barrier before the first item also orders the softmax
  // before the first P . V
  auto use3 = [&](int, int buf) {
    const bf16* vsm = stages + buf * STAGE + QT * LD;
    const int k0 = chunks[ci] * FS_KC;
    const int c0 = cc * HC, w = min(HC, hd - c0);
    if (ci == 0) {
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[gi][j][e] = 0.f;
    }
    const int ksteps = min(FS_KC / 16, (Nk - k0 + 15) / 16);
    for (int kk = 0; kk < ksteps; ++kk) {
      const float* pa = sc + (m0 + g) * SP + k0 + kk * 16 + 2 * t;
      const uint32_t a[4] = {pair_of(pa[0], pa[1]),
                             pair_of(pa[8 * SP], pa[8 * SP + 1]),
                             pair_of(pa[8], pa[9]),
                             pair_of(pa[8 * SP + 8], pa[8 * SP + 9])};
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        if (gi * 64 + n0 >= w) break;  // the warp's columns are past hd
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, vsm + (kk * 16 + (lane & 15)) * LD + gi * 64 +
                                   n0 + j * 8);
          mma_16816(o[gi][j], a, b);
        }
      }
    }
    if (++ci == nlive) {
      // accumulator e: row m0 + g (+ 8 for e >= 2), column gi * 64 + n0 +
      // 8j + 2t (+ 1)
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int qr = m0 + g + hr * 8;
            const int c = gi * 64 + n0 + j * 8 + 2 * t;
            if (qr >= nq || c >= w) continue;
            bf16* dst = ob + (q0 + qr) * orow + c0 + c;
            const float lo = o[gi][j][2 * hr], hi = o[gi][j][2 * hr + 1];
            if (vec) {  // c is even and hd a multiple of 8
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(lo, hi);
            } else {
              dst[0] = __float2bfloat16(lo);
              if (c + 1 < w) dst[1] = __float2bfloat16(hi);
            }
          }
      ci = 0, ++cc;
    }
  };
  ring_drain<NST>(n3, issue3, use3);
  // a tile whose keys are all masked has no item: its rows are zeros
  if (nlive == 0)
    for (int i = threadIdx.x; i < nq * hd; i += FS_THREADS)
      ob[(q0 + i / hd) * orow + i % hd] = __float2bfloat16(0.f);
}

template <int MT, int NST, int HC>
static inline size_t fuser_attention_seq_mma_smem(int Nk) {
  const int kend = cdiv(Nk, FS_KC) * FS_KC;
  return (size_t)NST * (16 * MT + FS_KC) * (HC + 8) * sizeof(bf16) +
         (size_t)16 * MT * (kend + 1) * sizeof(float) + kend;
}

template <int MT, int NST, int HC>
static cudaError_t launch_fuser_attention_seq_mma(
    const bf16* q, const bf16* k, const bf16* v, AttnStrides qs,
    AttnStrides ks, AttnStrides vs, const float* mask, bf16* out, int n_seq,
    int Nq, int Nk, int H, int hd, bool vec, cudaStream_t stream) {
  const size_t smem = fuser_attention_seq_mma_smem<MT, NST, HC>(Nk);
  const cudaError_t err = cudaFuncSetAttribute(
      fuser_attention_seq_mma<MT, NST, HC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
  const dim3 grid(n_seq * H, cdiv(Nq, 16 * MT));
  fuser_attention_seq_mma<MT, NST, HC><<<grid, FS_THREADS, smem, stream>>>(
      q, k, v, qs, ks, vs, mask, out, Nq, Nk, H, hd, scale, vec);
  return cudaGetLastError();
}

// ---- fp32: the CUDA cores, a tile of 16 queries --------------------------

constexpr int FF_QT = 16;            // queries a block
constexpr int FF_QLD = FF_QT + 4;    // row stride of the transposed q chunk
constexpr int FF_KLD = FS_KC + 4;    // row stride of a staged k / v chunk

// Rows r0 .. r0 + n of one fp32 operand (row t at src + t * ld, the chunk's
// column offset folded into src), columns 0 .. w, into dst: at
// [c * dld + r] with TRANS, else [r * dld + c]. A row at or past ``rows``,
// or whose key is not live, is zeros (and is not read).
template <bool TRANS>
__device__ __forceinline__ void stage_f32(float* dst, int dld, const float* src,
                                          long long ld, int r0, int n,
                                          int rows, const unsigned char* live,
                                          int w, bool vec) {
  const int step = vec ? 4 : 1, per_row = w / step;
  for (int i = threadIdx.x; i < n * per_row; i += FS_THREADS) {
    const int r = i / per_row, c = (i % per_row) * step, tr = r0 + r;
    const bool in = tr < rows && (live == nullptr || live[tr]);
    const float* s = src + tr * ld + c;
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
// query ty and keys (columns) 4 tx .. 4 tx + 3 of a chunk; the chunks are
// staged synchronously (the parity path). Dynamic shared memory:
// fuser_attention_seq_f32_smem(Nk) bytes. (Not a template, so static:
// every .cu that includes this header gets its own.)
static __global__ void __launch_bounds__(FS_THREADS)
fuser_attention_seq_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, AttnStrides qs,
                        AttnStrides ks, AttnStrides vs,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int Nq, int Nk, int H, int hd,
                        float scale, bool vec) {
  extern __shared__ __align__(16) float fs_smem[];
  __shared__ int chunks[FS_MAX_CHUNKS], n_chunks;
  __shared__ unsigned char live32[FS_MAX_KEYS / 32];
  float* qsm = fs_smem;                 // [FS_HC][FF_QLD]: q, transposed
  float* ksm = qsm + FS_HC * FF_QLD;    // [FS_HC][FF_KLD]: k, transposed;
                                        // later [FS_KC][FF_KLD] v
  float* sc = ksm + FS_HC * FF_KLD;     // [FF_QT][SP]: scores, probabilities
  const int nkc = (Nk + FS_KC - 1) / FS_KC, kend = nkc * FS_KC;
  const int SP = kend + 1;
  unsigned char* live = reinterpret_cast<unsigned char*>(sc + FF_QT * SP);
  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * FF_QT;
  const float* qb = q + seq * qs.b + h * qs.h;
  const float* kb = k + seq * ks.b + h * ks.h;
  const float* vb = v + seq * vs.b + h * vs.h;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nlive = stage_mask(sc, FF_QT, SP, kend, mask, q0, Nq, Nk, live,
                               live32, chunks, &n_chunks);

  // 1. the tile's scores against the live key chunks
  for (int ci = 0; ci < nlive; ++ci) {
    const int k0 = chunks[ci] * FS_KC;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < hd; c0 += FS_HC) {
      const int w = min(FS_HC, hd - c0);
      __syncthreads();  // the previous chunk is read
      stage_f32<true>(qsm, FF_QLD, qb + c0, qs.t, q0, FF_QT, Nq, nullptr, w,
                      vec);
      stage_f32<true>(ksm, FF_KLD, kb + c0, ks.t, k0, FS_KC, Nk, live, w,
                      vec);
      __syncthreads();
      for (int c = 0; c < w; ++c) {
        const float a = qsm[c * FF_QLD + ty];
        const float4 b =
            *reinterpret_cast<const float4*>(ksm + c * FF_KLD + tx * 4);
        acc[0] = fmaf(a, b.x, acc[0]);
        acc[1] = fmaf(a, b.y, acc[1]);
        acc[2] = fmaf(a, b.z, acc[2]);
        acc[3] = fmaf(a, b.w, acc[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* s = sc + ty * SP + k0 + tx * 4 + j;
      *s = masked_score(acc[j], *s, scale);
    }
  }
  __syncthreads();

  // 2. softmax
  softmax_rows<float>(sc, min(FF_QT, Nq - q0), SP, kend);

  // 3. P . V, 64 head columns at a time, over every live key chunk in order
  float* ob = out + ((size_t)seq * Nq * H + h) * hd;
  const size_t orow = (size_t)H * hd;
  for (int c0 = 0; c0 < hd; c0 += FS_HC) {
    const int w = min(FS_HC, hd - c0);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ci = 0; ci < nlive; ++ci) {
      const int k0 = chunks[ci] * FS_KC;
      __syncthreads();  // the softmax, or the previous chunk, is done
      stage_f32<false>(ksm, FF_KLD, vb + c0, vs.t, k0, FS_KC, Nk, live, w,
                       vec);
      __syncthreads();
      for (int kk = 0; kk < FS_KC; ++kk) {
        const float p = sc[ty * SP + k0 + kk];
        const float4 vv =
            *reinterpret_cast<const float4*>(ksm + kk * FF_KLD + tx * 4);
        o[0] = fmaf(p, vv.x, o[0]);
        o[1] = fmaf(p, vv.y, o[1]);
        o[2] = fmaf(p, vv.z, o[2]);
        o[3] = fmaf(p, vv.w, o[3]);
      }
    }
    const int qr = q0 + ty;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (qr < Nq && tx * 4 + j < w) ob[qr * orow + c0 + tx * 4 + j] = o[j];
  }
}

static inline size_t fuser_attention_seq_f32_smem(int Nk) {
  const int kend = cdiv(Nk, FS_KC) * FS_KC;
  return ((size_t)FS_HC * (FF_QLD + FF_KLD) + (size_t)FF_QT * (kend + 1)) *
             sizeof(float) + kend;
}

// out (n_seq, Nq, H, hd), contiguous = softmax(q . k^T * hd^-0.5 + mask) . v
// for q (n_seq, Nq, H, hd) and k, v (n_seq, Nk, H, hd) given by their
// strides (unit stride along hd), mask fp32 (Nq, Nk) or null. bf16 on the
// tensor cores: a tile of 16 queries up to 16 queries or beyond 512 keys
// (chunks of 128 head columns, two stages: the rollout's prefill and
// decode, the decoder block at S 10), of 32 up to 32 queries or beyond 256
// keys (64 columns, three stages), else of 64 (64 columns, two stages), so
// the tile's scores stay <= 64 KB and 4 blocks fit an SM; fp32 on the CUDA
// cores, 16 queries a tile. Past 1,024 keys the long route
// (long_attention.cuh, the probabilities rounded to T as here). Returns
// cudaErrorInvalidValue for Nq < 1 or Nk < 1 (nothing launched).
template <typename T>
static cudaError_t launch_fuser_attention_seq(const T* q, const T* k,
                                              const T* v, AttnStrides qs,
                                              AttnStrides ks, AttnStrides vs,
                                              const float* mask, T* out,
                                              int n_seq, int Nq, int Nk,
                                              int H, int hd,
                                              cudaStream_t stream) {
  if (Nq < 1 || Nk < 1) return cudaErrorInvalidValue;
  if (Nk > FS_MAX_KEYS) {
    LongAttn a{};
    a.q = q, a.k = k, a.v = v;
    a.qs = qs, a.ks = ks, a.vs = vs;
    a.mask = mask, a.out = out;
    a.n_seq = n_seq, a.Nq = Nq, a.Nk = Nk, a.H = H, a.hd = hd;
    a.scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
    return launch_long_attention<T, true, false>(a, stream);
  }
  const bool vec = attn_rows_aligned<T>(q, k, v, qs, ks, vs, hd);
  if constexpr (std::is_same<T, bf16>::value) {
    if (Nq <= 16 || Nk > 512)
      return launch_fuser_attention_seq_mma<1, 2, 128>(
          q, k, v, qs, ks, vs, mask, out, n_seq, Nq, Nk, H, hd, vec, stream);
    if (Nq <= 32 || Nk > 256)
      return launch_fuser_attention_seq_mma<2, 3, 64>(
          q, k, v, qs, ks, vs, mask, out, n_seq, Nq, Nk, H, hd, vec, stream);
    return launch_fuser_attention_seq_mma<4, 2, 64>(
        q, k, v, qs, ks, vs, mask, out, n_seq, Nq, Nk, H, hd, vec, stream);
  } else {
    const size_t smem = fuser_attention_seq_f32_smem(Nk);
    const cudaError_t err = cudaFuncSetAttribute(
        fuser_attention_seq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
    const dim3 grid(n_seq * H, cdiv(Nq, FF_QT));
    fuser_attention_seq_f32<<<grid, FS_THREADS, smem, stream>>>(
        q, k, v, qs, ks, vs, mask, out, Nq, Nk, H, hd, scale, vec);
    return cudaGetLastError();
  }
}

}  // namespace afft
