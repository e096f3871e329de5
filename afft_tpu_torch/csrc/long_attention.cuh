// long_attention: softmax attention at any sequence length, forward and
// backward: the long route of every entry whose short attention kernel has
// a length limit (past 8 fuser tokens, 32 GPT-2 tokens, 1,024 keys). The
// kernels, their design and their bounds: long_attention.cu, which
// instantiates every form the entries call (explicit instantiations), so
// they build once, in their own nvcc process, and not inside every entry's
// file.

#pragma once

#include "common.cuh"

namespace afft {

// Element (seq, token, head, j) of an operand lies at seq * b + token * t +
// head * h + j: packed qkv rows, column slices of a packed projection and
// (B, Tmax, H, hd) caches are all read where they are.
struct AttnStrides {
  long long b, t, h;  // elements between sequences, tokens and heads
};

constexpr int LA_THREADS = 256;
constexpr int LA_TILE = 16;                // queries and keys a tile
constexpr int LA_COLS = 512;               // head columns a sweep keeps
constexpr int LA_PER = LA_COLS / LA_TILE;  // columns a thread keeps
constexpr int LA_PLD = LA_TILE + 1;        // row stride of a 16 x 16 tile
// Up to LA_RES_HD head columns the kernels keep whole operand rows in
// shared memory; past it they stream them in column chunks (LA_HC columns
// a chunk in the CUDA-core forms), so shared memory is bounded at any hd.
constexpr int LA_RES_HD = 768;
constexpr int LA_HC = 128;

// One attention at any length. out is (n_seq, Nq, H, hd) contiguous. The
// backward's fields: stats (n_seq * H * Nq, 2) fp32 (each query's row max
// and sum), dao (n_seq, Nq, H, hd) fp32, dsum (n_seq * H * Nq) fp32 (D),
// and dq / dk / dv with their strides.
struct LongAttn {
  const void* q;
  const void* k;
  const void* v;
  AttnStrides qs, ks, vs;
  const float* mask;  // (Nq, Nk) additive, or null
  void* out;
  int n_seq, Nq, Nk, H, hd;
  float scale;
  DropSite drop;
  float* stats;
  const float* dao;
  float* dsum;
  void* dq;
  void* dk;
  void* dv;
  AttnStrides dqs, dks, dvs;
};

// The forward: out = softmax(q . k^T * scale + mask) [* keep] . v, with the
// stash (m, l) and D where a.stats / a.dsum are set (see long_attention.cu).
// cudaErrorInvalidValue for Nq or Nk < 1, hd < 1 or more than 65,535 query
// tiles (nothing launched). ROUND: the probabilities
// rounded to T before P . V; DROP: the dropout multipliers of a.drop.
template <typename T, bool ROUND, bool DROP>
cudaError_t launch_long_attention(const LongAttn& a, cudaStream_t stream);

// The backward on the same fields (long_attention.cu): O again, bit for
// bit, into a.out; a.stats / a.dsum scratch; a.dq / a.dk / a.dv in T.
template <typename T, bool ROUND, bool DROP>
cudaError_t launch_long_attention_bwd(const LongAttn& a, cudaStream_t stream);

// The attention over packed qkv rows (n_seq * N, 3 * H * hd), [q | k | v]
// with heads minor, out (n_seq * N, H * hd): the training and serving
// blocks' operands as a LongAttn.
template <typename T>
static LongAttn packed_long_attn(const T* qkv, const float* mask, T* out,
                                 int n_seq, int N, int H, int hd,
                                 DropSite drop) {
  const long long C = (long long)H * hd;
  const AttnStrides st{N * 3 * C, 3 * C, hd};
  LongAttn a{};
  a.q = qkv;
  a.k = qkv + C;
  a.v = qkv + 2 * C;
  a.qs = a.ks = a.vs = st;
  a.mask = mask;
  a.out = out;
  a.n_seq = n_seq;
  a.Nq = a.Nk = N;
  a.H = H;
  a.hd = hd;
  a.scale = (float)(1.0 / sqrt((double)hd));  // hd ** -0.5
  a.drop = drop;
  return a;
}

// Every row and chunk start of the three operands is 16-byte aligned.
template <typename T>
static bool attn_rows_aligned(const T* q, const T* k, const T* v,
                              AttnStrides qs, AttnStrides ks, AttnStrides vs,
                              int hd) {
  constexpr long long V = 16 / sizeof(T);
  const auto on_grid = [](const AttnStrides& s) {
    return s.b % V == 0 && s.t % V == 0 && s.h % V == 0;
  };
  return hd % V == 0 && on_grid(qs) && on_grid(ks) && on_grid(vs) &&
         ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
}

}  // namespace afft
