// staged_attention: softmax attention over S <= 32 tokens (past that,
// long_attention.cuh) for the GPT-2
// entries (the serving attention half, fused_gpt2.cu, and the training
// layer, train_block.cuh with GPT2 = true), one block per (sequence, head).
//
// Replaces, for those entries, a one-warp-per-query attention (scalar
// 2-byte loads, q read again for each key; the fuser's training forward
// ran one until it moved to fuser_attention.cuh). At the
// flagship shape (B 256, T 16, 4 heads of 512) the step moves ~67 MB and
// does ~0.5 GFLOP: bound by bytes (~0.02 ms at 3.35 TB/s). Here q, k and v
// are staged through shared memory in chunks of 128 head columns (rows
// padded by 16 bytes, so 16-byte reads of different rows fall in different
// banks), each thread keeps the partial scores of its (query, key) pairs in
// registers across the chunks (pairs that the mask hides are skipped), one
// warp per query takes the softmax, and each thread computes 16 bytes of
// P . V from shared memory and stores them as one vector. Global loads,
// shared-memory reads and output stores move 16 bytes at a time where the
// head width allows (hd a multiple of 8 in bf16, 4 in fp32), else one
// element at a time, so any hd is taken.
//
// Arithmetic as the fuser's (fuser_attention.cuh): scores and softmax in
// fp32, the scale applied after the dot, the row's max subtracted; with
// DROP the probability times its keep multiplier (drop_scale at the element
// index ((seq * H + h) * S + tq) * S + tk), rounded to T before P . V (the
// GPT-2 cast chain), whose sum runs over the keys in order in fp32. Only
// the score's summation order differs (sequential over hd here).

#pragma once

#include "common.cuh"

namespace afft {

constexpr int AS_THREADS = 256;  // 8 warps
constexpr int AS_HC = 128;       // head columns a chunk
constexpr int AS_MAX_N = 32;     // past it the entries take long_attention

// 16 bytes of T as fp32, and back (round to nearest even, as from_f32)
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f) {
  uint4 u;
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __halves2bfloat162(__float2bfloat16(f[2 * i]),
                                __float2bfloat16(f[2 * i + 1]));
  } else {
    u.x = __float_as_uint(f[0]), u.y = __float_as_uint(f[1]);
    u.z = __float_as_uint(f[2]), u.w = __float_as_uint(f[3]);
  }
  return u;
}

// rows 0 .. S - 1 of w <= AS_HC columns (row stride ld elements) into dst
// (row stride LD, 16-byte aligned rows); 16 bytes at a time when vec
template <typename T, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int S, int w,
                                           size_t ld, bool vec) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  if (vec) {
    const int per_row = w / V;
    for (int i = threadIdx.x; i < S * per_row; i += AS_THREADS) {
      const int t = i / per_row, c = (i % per_row) * V;
      *reinterpret_cast<uint4*>(dst + t * LD + c) =
          *reinterpret_cast<const uint4*>(src + t * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < S * w; i += AS_THREADS) {
      const int t = i / w, c = i % w;
      dst[t * LD + c] = src[t * ld + c];
    }
  }
}

// acc + sum over j < w of a[j] * b[j] in fp32, two shared-memory rows
template <typename T>
__device__ __forceinline__ float dot_rows(const T* a, const T* b, int w,
                                          bool vec, float acc) {
  constexpr int V = 16 / sizeof(T);
  int j = 0;
  if (vec) {
    for (; j < w; j += V) {
      float x[V], y[V];
      unpack16<T>(*reinterpret_cast<const uint4*>(a + j), x);
      unpack16<T>(*reinterpret_cast<const uint4*>(b + j), y);
#pragma unroll
      for (int i = 0; i < V; ++i) acc = fmaf(x[i], y[i], acc);
    }
  }
  for (; j < w; ++j) acc = fmaf(to_f32(a[j]), to_f32(b[j]), acc);
  return acc;
}

// qkv rows (seq * S + t) with [q | k | v] columns, heads minor, (n_seq * S,
// 3C); out (n_seq * S, C).
template <typename T, bool DROP>
__global__ void __launch_bounds__(AS_THREADS)
staged_attention(const T* __restrict__ qkv, const float* __restrict__ mask,
                 T* __restrict__ out, int S, int H, int hd, float scale,
                 DropSite drop) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LD = AS_HC + V;  // 16 bytes of padding a row
  __shared__ __align__(16) T qs[32 * LD];  // a q chunk, later a v chunk
  __shared__ __align__(16) T ks[32 * LD];
  __shared__ float pr[32][33];              // scores, then probabilities
  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * hd, tid = threadIdx.x;
  const size_t ld = 3 * (size_t)C;
  const T* base = qkv + (size_t)seq * S * ld + (size_t)h * hd;
  // every row and chunk start is then 16-byte aligned
  const bool vec = hd % V == 0;
  const int pairs = S * S;  // <= 1024: four a thread

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < hd; c0 += AS_HC) {
    const int w = min(AS_HC, hd - c0);
    stage_rows<T, LD>(qs, base + c0, S, w, ld, vec);
    stage_rows<T, LD>(ks, base + C + c0, S, w, ld, vec);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = tid + i * AS_THREADS;
      if (p >= pairs) break;
      if (mask != nullptr && mask[p] == -INFINITY) continue;
      acc[i] = dot_rows<T>(qs + (p / S) * LD, ks + (p % S) * LD, w, vec,
                           acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tid + i * AS_THREADS;
    if (p < pairs)
      pr[p / S][p % S] = acc[i] * scale + (mask != nullptr ? mask[p] : 0.f);
  }
  __syncthreads();

  // softmax, one warp per query; every row keeps at least one finite score
  const int warp = tid >> 5, lane = tid & 31;
  for (int tq = warp; tq < S; tq += AS_THREADS / 32) {
    const float mine = lane < S ? pr[tq][lane] : -INFINITY;
    const float m = warp_max(mine);
    const float e = lane < S ? expf(mine - m) : 0.f;
    float p = e / warp_sum(e);
    if (DROP && lane < S)
      p *= drop_scale(drop,
                      (((unsigned long long)seq * H + h) * S + tq) * S + lane);
    pr[tq][lane] = to_f32(from_f32<T>(p));
  }
  __syncthreads();

  // P . V: a thread takes V consecutive columns of one query (one column
  // where the rows are not 16-byte aligned)
  T* obase = out + (size_t)seq * S * C + (size_t)h * hd;
  const int g = vec ? V : 1;
  for (int c0 = 0; c0 < hd; c0 += AS_HC) {
    const int w = min(AS_HC, hd - c0), groups = w / g;
    stage_rows<T, LD>(qs, base + 2 * (size_t)C + c0, S, w, ld, vec);
    __syncthreads();
    for (int e = tid; e < S * groups; e += AS_THREADS) {
      const int tq = e / groups, j = (e % groups) * g;
      T* o = obase + (size_t)tq * C + c0 + j;
      if (vec) {
        float a[V];
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = 0.f;
        for (int tk = 0; tk < S; ++tk) {
          const float p = pr[tq][tk];
          float v[V];
          unpack16<T>(*reinterpret_cast<const uint4*>(qs + tk * LD + j), v);
#pragma unroll
          for (int i = 0; i < V; ++i) a[i] = fmaf(p, v[i], a[i]);
        }
        *reinterpret_cast<uint4*>(o) = pack16<T>(a);
      } else {
        float a = 0.f;
        for (int tk = 0; tk < S; ++tk)
          a = fmaf(pr[tq][tk], to_f32(qs[tk * LD + j]), a);
        *o = from_f32<T>(a);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool DROP>
static void launch_staged_attention(const T* qkv, const float* mask, T* out,
                                    int n_seq, int S, int H, int hd,
                                    DropSite drop, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
  staged_attention<T, DROP><<<n_seq * H, AS_THREADS, 0, stream>>>(
      qkv, mask, out, S, H, hd, scale, drop);
}

}  // namespace afft
