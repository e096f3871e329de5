// attention_bwd: the attention backward of both training layers
// (train_block.cuh run_bwd_attn), with dropout on the probabilities. From
// the stashed packed qkv (rows, 3C; [q | k | v], heads minor), the optional
// fp32 additive mask (N, N) and dao = d(attention output) (rows, C, fp32),
// per (row of N tokens, head):
//   s = q k^T * scale + mask; p = softmax(s); keep = the dropout multipliers
//   O = (p * keep) . V                       (the forward's attention output)
//   dv = (p * keep)^T . dao
//   dp = (dao . v^T) * keep; ds = p * (dp - sum_k dp * p)
//   dq = scale * ds . k; dk = scale * ds^T . q
// into out (rows, C) and the packed dqkv (rows, 3C), both in T.
//
// Replaces the attention backward of the TPU kernels of row 9
// (afft_tpu/ops/pallas_block_train.py _bwd_attn_kernel, :386-430) and row 15
// (pallas_gpt2_train.py _attn_bwd_kernel, :250-300), and the forward
// attention those entries launched again only for dWproj's operand: O is the
// A operand of dWproj (pallas_gpt2_train.py:270-271 exports it for the same
// product).
//
// Arithmetic. O is the forward's attention output bit for bit, so its
// chain is the forward's: the score a sequential fp32 sum over the head
// columns in order, the scale after the dot, then the forward's own softmax
// (ROUND, the GPT-2 layer: staged_attention.cuh, one warp a query, the sum
// of the exponentials by warp_sum, p * keep rounded to T; without ROUND, the
// fuser: fuser_attention_rows, the sum in key order, p * keep fp32), and P .
// V a sequential fp32 sum over the keys in order. With ROUND, dao is read
// rounded to T and ds rounded before its products (pallas_gpt2_train.py:
// 283-288); without it every step stays fp32 (pallas_block_train.py:397-
// 430). The element index of a keep multiplier is the forward's,
// ((pair * N) + tq) * N + tk, pair = row * H + head.
//
// Bound on an H100 by bytes: at the fuser's flagship shape (R 4096 x N 5,
// C 1024, 4 heads of 256, bf16) it reads qkv (126 MB) and the fp32 dao (84
// MB) and writes dqkv (126 MB) and O (42 MB): 0.113 ms at 3.35 TB/s, for
// ~1.3 GFLOP; at the GPT-2 layer's (B 256 x T 16, C 2048, 4 heads of 512)
// 151 MB, 0.045 ms. The design moves each of those bytes once, and what
// bounds it in practice is the latency of a block's steps (load, scores,
// softmax, products) more than the bytes (PERF.md):
//   * a block takes whole (row, head) pairs, as many as fill 16 (pair,
//     token) rows (3 pairs of 5 tokens on 4 warps, 4 to 5 blocks an SM; one
//     pair of 16, or of up to 32, on 8 warps), and stages their q, k, v and
//     dao rows, every head column of them where the shared memory holds
//     them (the flagship shapes: 42 KB and 71 KB), else in chunks of head
//     columns read twice; 16 bytes at a time where the head width allows (hd
//     a multiple of 8 in bf16, of 4 in fp32; else one element at a time, so
//     any hd is taken), through cp.async, dao rounded to T on the way in
//     with ROUND (a thread's loads all in flight before it rounds them).
//     Each row's source offset is computed once, so a 16-byte copy costs no
//     division; the keep multipliers are drawn while the copies fly;
//   * one thread two (query, key) scores and one two dao . v dots, each a
//     sequential fp32 sum (pairs of keys both masked skipped); a segment
//     of NMAX lanes (N rounded up to 4 / 8 / 16 / 32) then takes each
//     query's softmax and ds, 32 / NMAX queries a warp at once, into shared
//     memory, each also transposed;
//   * each thread then takes one product (O, dq, dk or dv) of W head
//     columns of one pair for all its N rows (W 8 up to 8 tokens, 4 up to
//     16, 2 up to 32): a staged row's W elements are read and converted
//     once and feed N multiply-adds each (an accumulator tile of N x W in
//     registers), the coefficients come as rows of the (transposed)
//     p * keep and ds, and each output row goes out as one vector.
// The ~1 GFLOP of products runs on the CUDA cores (the tensor cores would
// change O's summation order, and the fuser's operands are fp32). No
// atomics: the outputs are the same bit for bit from run to run.
//
// Limits: 1 <= N <= 32 with ROUND (the GPT-2 layer), 1 <= N <= 8 without
// (the fuser: past 8 tokens its forward and backward take the long route,
// long_attention.cu), H * hd = C (any hd), fp32 or bf16; rows of N
// consecutive tokens.

#pragma once

#include "common.cuh"
#include "fuser_attention.cuh"  // cp_async16, cp_async_commit / wait
#include "staged_attention.cuh"  // unpack16, pack16

namespace afft {

constexpr int AB_ROWS = 16;         // (pair, token) rows a block stages
constexpr int AB_MAX_N = 32;
constexpr int AB_MAX_ROWS = 32;     // max(AB_ROWS, AB_MAX_N)
constexpr int AB_SMEM = 96 * 1024;  // staged rows a block, at most
constexpr int AB_BATCH = 4;         // fp32 -> T loads a thread keeps in flight

// threads a block: 4 warps up to 8 tokens (the fuser: 3 pairs of 5 tokens a
// block, 5 blocks an SM), 8 beyond (the GPT-2 layer: one pair of 16)
template <int NMAX>
__host__ __device__ constexpr int ab_threads() {
  return NMAX <= 8 ? 128 : 256;
}

// two bf16 of a 32-bit word as fp32 (the low half first, as it lies)
__device__ __forceinline__ void bf16x2_f32(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// W consecutive elements (W * sizeof(TS) bytes, aligned to that size or to
// 16) as fp32, and back, rounded to nearest even as from_f32
template <int W, typename TS>
__device__ __forceinline__ void load_w(const TS* p, float* f) {
  constexpr int B = W * (int)sizeof(TS);
  if constexpr (B >= 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i)
      unpack16<TS>(reinterpret_cast<const uint4*>(p)[i],
                   f + i * (16 / (int)sizeof(TS)));
  } else if constexpr (W == 1) {
    f[0] = to_f32(p[0]);
  } else if constexpr (sizeof(TS) == 4) {  // W 2
    const float2 u = *reinterpret_cast<const float2*>(p);
    f[0] = u.x, f[1] = u.y;
  } else if constexpr (W == 2) {
    bf16x2_f32(*reinterpret_cast<const unsigned*>(p), f);
  } else {  // bf16, W 4
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16x2_f32(u.x, f);
    bf16x2_f32(u.y, f + 2);
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_w(T* p, const float* f) {
  constexpr int B = W * (int)sizeof(T);
  if constexpr (B >= 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = pack16<T>(f + i * (16 / (int)sizeof(T)));
  } else if constexpr (W == 1) {
    p[0] = from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {  // W 2
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {  // bf16, W 2 or 4
#pragma unroll
    for (int i = 0; i < W; i += 2)
      reinterpret_cast<__nv_bfloat162*>(p)[i / 2] =
          __halves2bfloat162(__float2bfloat16(f[i]), __float2bfloat16(f[i + 1]));
  }
}

// The sum and the max over each segment of S lanes (S a power of two), by
// the butterfly of warp_sum / warp_max restricted to the segment
template <int S>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int S>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// s0 + a . b0 and s1 + a . b1 over w columns of shared-memory rows, each a
// sequential fp32 sum in column order (the forward's score order); 16 bytes
// of b at a time where vec
template <typename TA, typename TB>
__device__ __forceinline__ void dot2(const TA* a, const TB* b0, const TB* b1,
                                     int w, bool vec, float& s0, float& s1) {
  constexpr int V = 16 / sizeof(TB);
  int j = 0;
  if (vec) {
    for (; j < w; j += V) {
      float x[V], y0[V], y1[V];
      load_w<V>(a + j, x);
      load_w<V>(b0 + j, y0);
      load_w<V>(b1 + j, y1);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s0 = fmaf(x[i], y0[i], s0);
        s1 = fmaf(x[i], y1[i], s1);
      }
    }
  }
  for (; j < w; ++j) {
    const float x = to_f32(a[j]);
    s0 = fmaf(x, to_f32(b0[j]), s0);
    s1 = fmaf(x, to_f32(b1[j]), s1);
  }
}

// Rows r < rows of the block (row r: token row rowid[r] of the source,
// its head's columns at hoff[r]), columns c0 .. c0 + w at column offset
// ``off`` of a source row (row stride ld), into dst (row stride LD),
// converted to TDst (T -> T copies through cp.async; fp32 -> T rounds, the
// loads of up to AB_BATCH rows a thread in flight at once). 16 bytes of dst
// at a time where vec, else one element. A thread keeps one column chunk
// over rows THREADS / per_row apart: no division per chunk.
template <int THREADS, typename TS, typename TDst>
__device__ __forceinline__ void stage_head_rows(TDst* dst, int LD,
                                                const TS* src, size_t ld,
                                                size_t off, const int* rowid,
                                                const int* hoff, int rows,
                                                int c0, int w, bool vec) {
  constexpr int E = 16 / sizeof(TDst);
  const int step = vec ? E : 1, per_row = w / step;
  // thread tid: chunk c of rows r0, r0 + dr, ...; chunks cs apart when a
  // row has more chunks than the block has threads
  const int dr = per_row < THREADS ? THREADS / per_row : 1;
  const int r0 = per_row < THREADS ? threadIdx.x / per_row : 0;
  const int cs = per_row < THREADS ? per_row : THREADS;
  const int cb = per_row < THREADS ? threadIdx.x - r0 * per_row : threadIdx.x;
  if (r0 >= dr) return;  // the threads past dr * per_row
  const auto src_at = [&](int r, int c) {
    return src + (size_t)rowid[r] * ld + hoff[r] + off + c0 + c * step;
  };
  for (int c = cb; c < per_row; c += cs) {
    if constexpr (std::is_same<TS, TDst>::value) {
      for (int r = r0; r < rows; r += dr) {
        const TS* s = src_at(r, c);
        TDst* d = dst + r * LD + c * step;
        if (vec)
          cp_async16(d, s, true);
        else
          *d = *s;
      }
    } else if (!vec) {
      for (int r = r0; r < rows; r += dr)
        dst[r * LD + c] = from_f32<TDst>(*src_at(r, c));
    } else {  // E fp32 values rounded to E of TDst, AB_BATCH rows in flight
      for (int rb = r0; rb < rows; rb += AB_BATCH * dr) {
        float f[AB_BATCH][E];
#pragma unroll
        for (int u = 0; u < AB_BATCH; ++u)
          if (rb + u * dr < rows) load_w<E>(src_at(rb + u * dr, c), f[u]);
#pragma unroll
        for (int u = 0; u < AB_BATCH; ++u)
          if (rb + u * dr < rows)
            *reinterpret_cast<uint4*>(dst + (rb + u * dr) * LD + c * step) =
                pack16<TDst>(f[u]);
      }
    }
  }
}

// One product of one pair's W head columns j .. j + W - 1 for all its N
// rows: dst row t (t < N) = sc * sum over k < N of coef[b + k][t] * src[b +
// k][j ..], each a sequential fp32 sum over k in order (for O, the
// forward's P . V), rounded to T.
template <int NMAX, int W, int CS, typename T, typename TS>
__device__ __forceinline__ void pair_product(const TS* src, int lds,
                                             const float* coef, int b, int j,
                                             int N, T* dst, size_t ldo,
                                             float sc) {
  float acc[NMAX][W];
#pragma unroll
  for (int t = 0; t < NMAX; ++t)
#pragma unroll
    for (int i = 0; i < W; ++i) acc[t][i] = 0.f;
  for (int k = 0; k < N; ++k) {
    float x[W];
    load_w<W>(src + (b + k) * lds + j, x);
    const float* cr = coef + (b + k) * CS;
    if constexpr (NMAX <= 8) {  // one coefficient at a time: no row past N
#pragma unroll
      for (int t = 0; t < NMAX; ++t) {
        if (t >= N) break;
        const float c = cr[t];
#pragma unroll
        for (int i = 0; i < W; ++i) acc[t][i] = fmaf(c, x[i], acc[t][i]);
      }
    } else {  // four at a time
#pragma unroll
      for (int t4 = 0; t4 < NMAX / 4; ++t4) {
        if (4 * t4 >= N) break;
        const float4 c = *reinterpret_cast<const float4*>(cr + 4 * t4);
        const float cc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < W; ++i)
            acc[4 * t4 + u][i] = fmaf(cc[u], x[i], acc[4 * t4 + u][i]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NMAX; ++t) {
    if (t >= N) break;
    if (sc != 1.f) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc[t][i] *= sc;
    }
    store_w<W>(dst + t * ldo, acc[t]);
  }
}

// One block: pairs g0 .. g0 + per - 1 of n_pairs (pair = row * H + head),
// N <= NMAX tokens, head columns in chunks of hc (a multiple of 16 bytes
// of T where hc < hd).
template <typename T, bool ROUND, int NMAX>
__global__ void __launch_bounds__(ab_threads<NMAX>(), NMAX <= 8 ? 4 : 2)
attention_bwd(const T* __restrict__ qkv, const float* __restrict__ mask,
              const float* __restrict__ dao, T* __restrict__ dqkv,
              T* __restrict__ out, int n_pairs, int per, int N, int H,
              int hd, int hc, float scale, DropSite drop) {
  typedef typename std::conditional<ROUND, T, float>::type TD;  // staged dao
  constexpr int THREADS = ab_threads<NMAX>(), WARPS = THREADS / 32;
  constexpr int V = 16 / sizeof(T), VD = 16 / sizeof(TD);
  constexpr int W = NMAX >= 8 ? 64 / NMAX : 8;  // head columns a product item
  constexpr int CS = NMAX + 4;  // coefficient rows: 16-byte aligned
  extern __shared__ __align__(16) unsigned char ab_smem[];
  const int g0 = blockIdx.x * per;
  const int pairs = min(per, n_pairs - g0), rows = pairs * N, cap = per * N;
  const int LD = (hc + V - 1) / V * V + V;  // 16 bytes of padding a row
  const int LDD = (hc + VD - 1) / VD * VD + VD;
  // coefficients by block row: P[r][k] = (p * keep) of query r and key k of
  // its pair (first the dots q . k), DS[r][k] = ds (first dao . v), and both
  // transposed (PT[b + k][t] = P[b + t][k]) for the products' row loads
  float* P = reinterpret_cast<float*>(ab_smem);
  float* PT = P + cap * CS;
  float* DS = PT + cap * CS;
  float* DST = DS + cap * CS;
  // row r's token row in qkv / dao / the outputs and its head's first
  // column, and each pair's: computed once
  __shared__ int rowid[AB_MAX_ROWS], hoff[AB_MAX_ROWS];
  T* qs = reinterpret_cast<T*>(DST + cap * CS);
  T* ks = qs + cap * LD;
  T* vs = ks + cap * LD;
  TD* gs = reinterpret_cast<TD*>(vs + cap * LD);
  const int C = H * hd, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t ld = 3 * (size_t)C;
  // every row and chunk start is then 16-byte aligned
  const bool vec = hd % V == 0;
  const bool one_chunk = hc >= hd;

  if (tid < rows) {
    const int g = g0 + tid / N;
    rowid[tid] = (g / H) * N + tid % N;
    hoff[tid] = (g % H) * hd;
  }
  __syncthreads();

  // q, k, v through cp.async first, then dao (rounded with ROUND: its loads
  // pass through registers meanwhile)
  auto stage = [&](int c0, int w) {
    stage_head_rows<THREADS, T, T>(qs, LD, qkv, ld, 0, rowid, hoff, rows, c0,
                                   w, vec);
    stage_head_rows<THREADS, T, T>(ks, LD, qkv, ld, C, rowid, hoff, rows, c0,
                                   w, vec);
    stage_head_rows<THREADS, T, T>(vs, LD, qkv, ld, 2 * (size_t)C, rowid,
                                   hoff, rows, c0, w, vec);
    stage_head_rows<THREADS, float, TD>(gs, LDD, dao, C, 0, rowid, hoff, rows,
                                        c0, w, vec);
    cp_async_commit();
  };

  // the softmax takes one segment of NMAX lanes a row, 32 / NMAX rows a
  // warp at once: lane = sub * NMAX + key, row warp * RPW + sub + WARPS *
  // RPW * i. The keep multipliers of those (row, key) are drawn while the
  // first chunk is in flight.
  constexpr int RPW = 32 / NMAX, KR = AB_MAX_ROWS / (WARPS * RPW);
  const int key = lane % NMAX, row0 = warp * RPW + lane / NMAX;
  float keep[KR];
  stage(0, min(hc, hd));
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int r = row0 + WARPS * RPW * i;
    keep[i] = r < rows && key < N
                  ? drop_scale(drop, ((unsigned long long)(g0 + r / N) * N +
                                      r % N) * N + key)
                  : 0.f;
  }

  // item it < items: the dots q[r] . k[k0], k[k0 + 1]; items + it: dao[r] .
  // v[k0], v[k0 + 1], summed into P and DS over the chunks by the same
  // thread in column order. A pair of keys both masked is skipped (0); the
  // dot of one masked key is computed and never used.
  const int KP = (N + 1) / 2, items = rows * KP;
  for (int c0 = 0; c0 < hd; c0 += hc) {
    const int w = min(hc, hd - c0);
    if (c0 > 0) stage(c0, w);
    cp_async_wait<0>();
    __syncthreads();
    for (int it = tid; it < 2 * items; it += THREADS) {
      const int e = it < items ? it : it - items;
      const int r = e / KP, k0 = 2 * (e % KP), tq = r % N, b = r - tq;
      const int k1 = min(k0 + 1, N - 1);
      float* acc = (it < items ? P : DS) + r * CS + k0;
      float s0 = c0 > 0 ? acc[0] : 0.f;
      float s1 = c0 > 0 && k0 + 1 < N ? acc[1] : 0.f;
      if (mask == nullptr || mask[tq * N + k0] != -INFINITY ||
          mask[tq * N + k1] != -INFINITY) {
        if (it < items)
          dot2(qs + r * LD, ks + (b + k0) * LD, ks + (b + k1) * LD, w, vec,
               s0, s1);
        else
          dot2(gs + r * LDD, vs + (b + k0) * LD, vs + (b + k1) * LD, w, vec,
               s0, s1);
      }
      acc[0] = s0;
      if (k0 + 1 < N) acc[1] = s1;
    }
    __syncthreads();  // before the next chunk is staged, or the softmax
  }

  // one segment a row (query tq of its pair): the forward's score and
  // softmax and the keep multipliers, then ds. The forward's sums over 32
  // lanes (staged_attention's warp_sum) add exact zeros past NMAX lanes, so
  // a segment's butterfly gives each key the same sum bit for bit.
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    if (warp * RPW + WARPS * RPW * i >= rows) break;  // the warp's rows
    const int r = row0 + WARPS * RPW * i;
    const int tq = r % N, b = r - tq;
    const bool in = r < rows && key < N;
    const float add = in && mask != nullptr ? mask[tq * N + key] : 0.f;
    const float dot = in ? P[r * CS + key] : 0.f;
    // staged_attention's score (a masked dot is 0 there, and any finite dot
    // gives -inf too), or fuser_attention_rows'
    const float s = !in ? -INFINITY
                        : ROUND ? dot * scale + add
                                : (add != -INFINITY ? dot * scale + add
                                                    : -INFINITY);
    float p;
    if (ROUND) {  // staged_attention
      const float m = seg_max<NMAX>(s);
      const float e = in ? expf(s - m) : 0.f;
      p = e / seg_sum<NMAX>(e);
    } else {  // fuser_attention_rows: the exponentials summed in key order
      float m = seg_max<NMAX>(s);
      if (m == -INFINITY) m = 0.f;
      const float e = in ? expf(s - m) : 0.f;
      __syncwarp();
      if (in) P[r * CS + key] = e;
      __syncwarp();
      float sum = 0.f;
      if (r < rows)
        for (int k = 0; k < N; ++k) sum += P[r * CS + k];
      p = sum > 0.f ? e / sum : 0.f;
    }
    const float dp = in ? DS[r * CS + key] * keep[i] : 0.f;
    const float sdot = seg_sum<NMAX>(dp * p);
    __syncwarp();
    if (in) {
      const float pk = to_f32(from_f32<TD>(p * keep[i]));
      const float ds = to_f32(from_f32<TD>(p * (dp - sdot)));
      P[r * CS + key] = pk;
      PT[(b + key) * CS + tq] = pk;
      DS[r * CS + key] = ds;
      DST[(b + key) * CS + tq] = ds;
    }
  }
  __syncthreads();

  // the products, a thread W head columns of one pair for all its rows:
  //   O[t]  = sum_k pk[t][k] v[k]        (PT rows; the forward's P . V)
  //   dq[t] = scale sum_k ds[t][k] k[k]  (DST rows)
  //   dk[t] = scale sum_u ds[u][t] q[u]  (DS rows)
  //   dv[t] = sum_u pk[u][t] dao[u]      (P rows)
  // item (q, jg): product q / pairs of pair q % pairs, columns jg * WW ..;
  // a cursor over the items, no division a step
  auto products = [&](auto wtag, int c0, int w) {
    constexpr int WW = decltype(wtag)::value;
    const int groups = w / WW;
    const int dq = THREADS / groups, dj = THREADS - dq * groups;
    int q = tid / groups, jg = tid - q * groups;
    for (; q < 4 * pairs; q += dq, jg += dj) {
      if (jg >= groups) jg -= groups, ++q;
      if (q >= 4 * pairs) break;
      const int prod = q / pairs, p = q - prod * pairs;
      const int j = jg * WW, b = p * N;
      const size_t row = (size_t)rowid[b];
      const size_t col = (size_t)hoff[b] + c0 + j;
      if (prod == 0)
        pair_product<NMAX, WW, CS>(vs, LD, PT, b, j, N, out + row * C + col,
                                   C, 1.f);
      else if (prod == 1)
        pair_product<NMAX, WW, CS>(ks, LD, DST, b, j, N,
                                   dqkv + row * ld + col, ld, scale);
      else if (prod == 2)
        pair_product<NMAX, WW, CS>(qs, LD, DS, b, j, N,
                                   dqkv + row * ld + C + col, ld, scale);
      else
        pair_product<NMAX, WW, CS>(gs, LDD, P, b, j, N,
                                   dqkv + row * ld + 2 * (size_t)C + col, ld,
                                   1.f);
    }
  };
  for (int c0 = 0; c0 < hd; c0 += hc) {
    const int w = min(hc, hd - c0);
    if (!one_chunk) {
      stage(c0, w);
      cp_async_wait<0>();
      __syncthreads();
    }
    if (hd % W == 0)
      products(std::integral_constant<int, W>{}, c0, w);
    else
      products(std::integral_constant<int, 1>{}, c0, w);
    if (!one_chunk) __syncthreads();  // before the next chunk is staged
  }
}

// O (n_seq * N, C) and dqkv (n_seq * N, 3C) from qkv, the optional (N, N)
// mask and the fp32 dao; ROUND the GPT-2 layer's arithmetic. Returns
// cudaErrorInvalidValue for N outside 1..ab_max_n (nothing launched).
template <typename T, bool ROUND, int NMAX>
static cudaError_t launch_attention_bwd_n(const T* qkv, const float* mask,
                                          const float* dao, T* dqkv, T* out,
                                          int n_seq, int N, int H, int hd,
                                          DropSite drop, cudaStream_t stream) {
  typedef typename std::conditional<ROUND, T, float>::type TD;
  constexpr int V = 16 / sizeof(T), VD = 16 / sizeof(TD), CS = NMAX + 4;
  const int per = max(1, AB_ROWS / N), cap = per * N;
  const auto bytes = [&](int hc) {
    return (size_t)cap * (4 * CS * sizeof(float) +
                          ((hc + V - 1) / V * V + V) * 3 * sizeof(T) +
                          ((hc + VD - 1) / VD * VD + VD) * sizeof(TD));
  };
  // every head column at once where it fits, else 64-column chunks
  int hc = hd;
  if (bytes(hd) > (size_t)AB_SMEM) {
    hc = (hd + 63) / 64 * 64;
    while (hc > 64 && bytes(hc) > (size_t)AB_SMEM) hc -= 64;
  }
  const size_t smem = bytes(hc);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd<T, ROUND, NMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
  const int pairs = n_seq * H;
  attention_bwd<T, ROUND, NMAX><<<cdiv(pairs, per), ab_threads<NMAX>(), smem,
                                  stream>>>(qkv, mask, dao, dqkv, out, pairs,
                                            per, N, H, hd, hc, scale, drop);
  return cudaGetLastError();
}

// The longest N of each layer's short route: the fuser's ends at 8 tokens
// (its forward's rows kernel; past it both take long_attention), the GPT-2
// layer's (ROUND) at 32.
template <bool ROUND>
constexpr int ab_max_n() {
  return ROUND ? AB_MAX_N : 8;
}

template <typename T, bool ROUND>
static cudaError_t launch_attention_bwd(const T* qkv, const float* mask,
                                        const float* dao, T* dqkv, T* out,
                                        int n_seq, int N, int H, int hd,
                                        DropSite drop, cudaStream_t stream) {
  if (N < 1 || N > ab_max_n<ROUND>() || hd < 1 || H < 1)
    return cudaErrorInvalidValue;
  if (N <= 4)
    return launch_attention_bwd_n<T, ROUND, 4>(qkv, mask, dao, dqkv, out,
                                               n_seq, N, H, hd, drop, stream);
  if constexpr (ROUND) {
    if (N <= 8)
      return launch_attention_bwd_n<T, ROUND, 8>(qkv, mask, dao, dqkv, out,
                                                 n_seq, N, H, hd, drop,
                                                 stream);
    if (N <= 16)
      return launch_attention_bwd_n<T, ROUND, 16>(qkv, mask, dao, dqkv, out,
                                                  n_seq, N, H, hd, drop,
                                                  stream);
    return launch_attention_bwd_n<T, ROUND, 32>(qkv, mask, dao, dqkv, out,
                                                n_seq, N, H, hd, drop, stream);
  } else {
    return launch_attention_bwd_n<T, ROUND, 8>(qkv, mask, dao, dqkv, out,
                                               n_seq, N, H, hd, drop, stream);
  }
}

}  // namespace afft
