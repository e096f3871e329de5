// long_attention: softmax attention at any sequence length, forward and
// backward: the long route of every entry whose short attention kernel has
// a length limit (declared in long_attention.cuh).
//
// Replaces, past those limits, the attentions of the TPU kernels of rows 1
// (afft_tpu/ops/pallas_block.py _block_kernel, past 8 tokens), 2
// (pallas_gpt2.py _attn_half_kernel, past 32), 4 (pallas_attn.py
// _attn_kernel, past 1,024 keys), 5 and 6 (pallas_seq_block.py
// _seq_block_kernel / _decoder_block_kernel, past 1,024 keys), 7 and 9
// (pallas_block_train.py _fwd_kernel / _bwd_attn_kernel, past 8 tokens), 11
// and 15 (pallas_gpt2_train.py _attn_half_train_kernel / _attn_bwd_kernel,
// past 32). The JAX package computes those lengths in XLA
// (afft_tpu/models/predictor.py:156-180, fusion.py:67-118): the short
// kernels keep every score of a tile in shared memory, which bounds their
// length; here nothing grows with the length but the grid.
//
// Two families, chosen by dtype and cast chain inside launch_long_attention
// / launch_long_attention_bwd (no fallback: a form is reached by its types):
//
// * The tensor-core forms (T = bf16 with ROUND: rows 2, 4, 5, 6, 11 and
//   15): long_attention_mma, long_attention_mma_dkdv, long_attention_mma_dq.
//   Every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulate, v's and
//   the other right-hand operands' fragments through ldmatrix.trans,
//   mma_tiles.cuh); the operands stream through rings of cp.async copies,
//   16 bytes at a time where the rows allow (else element by element, so any
//   hd is taken; the head columns are padded to the mma's k of 16 with
//   zeros). Shared memory never depends on the lengths, and past LA_RES_HD
//   (768) head columns not on hd either: there the rows each kernel keeps
//   resident below it (q in the forward and dQ, dao in dQ, k and v in dK /
//   dV) stream through the ring beside the chunk they multiply, chunk by
//   chunk in the same column order (the same products, so the same bits),
//   at 48-71 KB a block whatever hd is.
//   - Forward: one block a (sequence, head, tile of 16 or 32 queries), its q
//     rows resident (up to LA_RES_HD). The softmax takes two passes, which
//     keeps the plain version's rounding point: pass 1 streams the key chunks
//     (64 keys x 128 head columns) for each query's max m and sum l (online,
//     each warp over its keys, the warps' partials combined in a fixed order);
//     pass 2 rebuilds each chunk's scores on the same fragments in the same
//     order and forms p = exp(s - m) / l, times its keep multiplier, rounded to
//     bf16 into a shared P tile, then O += P . V over 16-key items of v. O
//     stays in registers, split over the warps: a warp keeps 16 queries x 64
//     columns (32 registers, so two blocks fit an SM); a tile of 32 queries
//     takes hd <= 256 in one sweep of O, 16 queries hd <= 512 (the tile is
//     chosen so), and past 512 head columns each further 512 take one more
//     sweep, which rebuilds the scores: 2 sweeps at hd 768 / 1,024, 4 at 2,048.
//     Two passes cost 1.5x the products of a one-pass online softmax (4 pairs
//     hd) in one sweep and need no rescaling of O; s sweeps cost (2 + s) / 2
//     times them (2x at hd 1,024, 3x at 2,048).
//   - Backward: three launches, no atomics. (1) The forward's own instance
//     again: O bit for bit (dWproj's operand), the stash (m, l), D =
//     rowsum(dao . O) (dao rounded to bf16, as the plain version reads it)
//     and dao rounded to bf16 into dQ's place, the other two kernels'
//     operand. (2) dK / dV: one block a tile of 16 keys (k, v resident),
//     looping over the 64-query chunks that see some key of it: S = q . k^T
//     and dP = dao . v^T on the forward's fragments in the forward's column
//     order (so P is the forward's bit for bit), dS = p (dP keep - D)
//     rounded, then dV += (P keep)^T . dao and dK += dS^T . q through
//     transposed shared tiles. Two 16 x hd fp32 accumulators split over 8
//     warps (64 registers at hd 512, two blocks an SM; each further 512
//     head columns take one more sweep, rebuilding S and dP: 8 pairs hd of
//     products at hd 512, 12 at 1,024, 20 at 2,048). (3) dQ over query
//     tiles (as the forward's, dQ kept as O), looping over key chunks: dQ
//     += dS . k, written over the block's own copy of dao. Every gradient
//     is the same bit for bit from run to run.
//   - Chunks: each tile first reads its rows of the (Nq, Nk) mask for the
//     first and last key (query) it sees; the chunks outside that range are
//     neither staged nor multiplied: the causal upper triangle, the
//     rollout's unwritten cache slots. The rows outside it are staged as
//     zeros, so NaN in an unwritten slot never reaches a result; a masked
//     pair's probability and dS are selected as exactly 0; a query whose
//     keys are all masked gives zeros. A key inside the range that no query
//     of the tile sees (a mask with holes; none of the entries' masks) is
//     staged as it lies.
//   - Dropout (DROP): the keep multiplier of (query tq, key tk) is
//     drop_scale(drop, ((seq * H + h) * Nq + tq) * Nk + tk), a 64-bit
//     logical index drawn from each thread's fragment coordinates, so a
//     tensor-parallel shard's span / gap remap (common.cuh) holds and the
//     keep pattern is the plain version's bit for bit.
//   - Bound on an H100: operations 4 . pairs . hd forward and 8 . pairs .
//     hd backward (pairs: the visible (query, key) pairs of all sequences
//     and heads; at T 1,024, C 2,048, 4 heads, B 4, causal: 17.2 / 34.4
//     GFLOP, 0.017 / 0.035 ms at 989 TFLOP/s) against bytes (q, k, v read
//     and out written once; the backward's fp32 dao read and dq, dk, dv and
//     O written once: 0.020 / 0.045 ms at 3.35 TB/s). Under DROP, Philox
//     adds one draw a visible pair and kernel (common.cuh drop_scale: ~19
//     multiplies on the FMA-heavy pipe, a widening one taking about two
//     issue slots, and ~20 ALU instructions; tools/philox_bound.py counts
//     the drop passes' draws): at T 1,024 8.4 M pairs, ~0.35 G FMA-heavy
//     slots, ~0.02 ms of that pipe. The kernels run 1.5x (forward), 2.5x (backward) the
//     bound's products: the second pass, the backward's recomputed forward
//     and scores. PERF.md has their times.
//
// * The CUDA-core forms (long_attention_f32rows, _dkdv, _dq): fp32, and the
//   fuser's ROUND = false chain (rows 1, 7, 9: fp32 probabilities, whose
//   1e-5 parity tolerance TF32 tensor cores cannot meet in fp32, and whose
//   rows launch 0 times on the served and trained paths). One block a
//   (sequence, head, tile of 16 queries), 256 threads, thread (r, c) =
//   (tid / 16, tid % 16): the tile's q rows staged once (fp32, all head
//   columns); the key tiles of 16 stream through shared memory, each thread
//   the score of query r and key c (past LA_RES_HD head columns, CH: q and
//   the key tile stream in chunks of LA_HC columns, the FMA chain carried in
//   a register across them, and v and the backward's row operands are
//   staged over one sweep's columns, so shared memory stays under 101 KB a
//   block whatever hd is); a first sweep keeps each query's running
//   max and sum, a second forms p = exp(s - max) / sum as the plain version
//   does (times the dropout multiplier, rounded to T under ROUND), and
//   thread (r, c) keeps O's columns c, c + 16, ... (up to 512 columns a
//   sweep) in registers. Every score is a sequential fp32 FMA chain over the
//   head columns in order, so the backward's kernels recompute the same
//   bits. Their backward: the forward again (O, the stash, D), then
//   long_attention_f32rows_dkdv (a tile of 16 keys over every query tile)
//   and long_attention_f32rows_dq (a tile of 16 queries over every key
//   tile). A masked key scores -inf and a zero
//   coefficient is skipped in every product. Products on the CUDA cores
//   from shared memory: PERF.md has their times.
//
// With ROUND, D sums (p * keep) rounded (the O of P . V) where the plain
// version sums p * keep unrounded: a difference of bf16 rounding in ds.
//
// Limits: any lengths (Nq, Nk >= 1; a grid's y takes cdiv(Nq, 16) and
// cdiv(Nk, 16) <= 65,535), any hd >= 1, any strides with unit stride along
// hd.

#include "long_attention.cuh"
#include "mma_tiles.cuh"

namespace afft {

// The sum and the max over each 16-lane half of a warp (a tile row)
__device__ __forceinline__ float la_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float la_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows r0 .. r0 + 16 of one operand (row t at base + t * ld), all hd
// columns, into dst (fp32, row stride lds); rows at or past n are zeros.
// With RND each value is rounded to T first (dao under the GPT-2 chain).
template <typename T, bool RND, typename TS>
__device__ __forceinline__ void la_stage(float* dst, int lds, const TS* base,
                                         long long ld, int r0, int n,
                                         int hd) {
  for (int i = threadIdx.x; i < LA_TILE * hd; i += LA_THREADS) {
    const int r = i / hd, c = i - r * hd, t = r0 + r;
    float f = 0.f;
    if (t < n) {
      f = to_f32(base[(long long)t * ld + c]);
      if (RND) f = to_f32(from_f32<T>(f));
    }
    dst[r * lds + c] = f;
  }
}

// a . b over hd columns: a sequential fp32 FMA chain in column order
__device__ __forceinline__ float la_dot(const float* a, const float* b,
                                        int hd) {
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < hd; ++j) acc = fmaf(a[j], b[j], acc);
  return acc;
}

// The mask entry of (query qi, key ki): -inf outside the tile's extent
__device__ __forceinline__ float la_mask(const LongAttn& a, int qi, int ki) {
  if (qi >= a.Nq || ki >= a.Nk) return -INFINITY;
  return a.mask != nullptr ? a.mask[(size_t)qi * a.Nk + ki] : 0.f;
}

// The score of a pair from its dot and mask entry mk
__device__ __forceinline__ float la_score_of(float dot, float mk,
                                             float scale) {
  return mk == -INFINITY ? -INFINITY : __fadd_rn(__fmul_rn(dot, scale), mk);
}

// The score of query row qr (of qsm) and key row kr (of ksm), mask entry mk
__device__ __forceinline__ float la_score(const float* qrow,
                                          const float* krow, int hd,
                                          float mk, float scale) {
  if (mk == -INFINITY) return -INFINITY;
  return la_score_of(la_dot(qrow, krow, hd), mk, scale);
}

// p = exp(s - m) / l from the row's max m and sum l
__device__ __forceinline__ float la_prob(float s, float m, float l) {
  return s != -INFINITY ? __fdiv_rn(expf(__fsub_rn(s, m)), l) : 0.f;
}

// p times its multiplier, rounded to T under ROUND: P . V's coefficient
template <typename T, bool ROUND, bool DROP>
__device__ __forceinline__ float la_coef(float p, float keep) {
  float x = DROP ? __fmul_rn(p, keep) : p;
  if (ROUND) x = to_f32(from_f32<T>(x));
  return x;
}

template <bool DROP>
__device__ __forceinline__ float la_keep(const LongAttn& a, int seq, int h,
                                         int qi, int ki) {
  if (!DROP || qi >= a.Nq || ki >= a.Nk) return 1.f;
  const unsigned long long idx =
      (((unsigned long long)seq * a.H + h) * a.Nq + qi) * a.Nk + ki;
  return drop_scale(a.drop, idx);
}

// The dots of thread (r, c)'s pair over all hd head columns, LA_HC columns
// a chunk (the CH forms, past LA_RES_HD): q row q0 + r . k row k0 + c (s)
// and, with TWO, dao row q0 + r (rounded to T under ROUND) . v row k0 + c
// (dp), each chunk's rows staged into buf (four [16][LA_HC + 1] tiles: q,
// k, dao, v). Each sum is la_dot's sequential fp32 FMA chain over the
// columns in order, carried across the chunks, so the bits are the same in
// the forward and in both backward kernels. Block-wide: it starts with a
// barrier (the block's earlier reads of shared memory are done) and leaves
// the last chunk's tiles in buf.
template <typename T, bool ROUND, bool TWO>
__device__ __forceinline__ void la_dots(float* buf, const LongAttn& a,
                                        const T* qb, const float* gb,
                                        long long gld, int q0, const T* kb,
                                        const T* vb, int k0, int r, int c,
                                        float& s, float& dp) {
  constexpr int L = LA_HC + 1;
  float* qc = buf;
  float* kc = qc + LA_TILE * L;
  float* gc = kc + LA_TILE * L;
  float* vc = gc + LA_TILE * L;
  s = 0.f, dp = 0.f;
  for (int c0 = 0; c0 < a.hd; c0 += LA_HC) {
    const int w = min(LA_HC, a.hd - c0);
    __syncthreads();  // the previous chunk (or the caller's tiles) is read
    la_stage<T, false>(qc, L, qb + c0, a.qs.t, q0, a.Nq, w);
    la_stage<T, false>(kc, L, kb + c0, a.ks.t, k0, a.Nk, w);
    if (TWO) {
      la_stage<T, ROUND>(gc, L, gb + c0, gld, q0, a.Nq, w);
      la_stage<T, false>(vc, L, vb + c0, a.vs.t, k0, a.Nk, w);
    }
    __syncthreads();
    const float *qr = qc + r * L, *kr = kc + c * L;
#pragma unroll 4
    for (int j = 0; j < w; ++j) s = fmaf(qr[j], kr[j], s);
    if (TWO) {
      const float *gr = gc + r * L, *vr = vc + c * L;
#pragma unroll 4
      for (int j = 0; j < w; ++j) dp = fmaf(gr[j], vr[j], dp);
    }
  }
}

static size_t la_lds(int hd) { return (size_t)hd + 1; }
// the row stride of a tile over one output sweep's columns (the CH forms)
__host__ __device__ __forceinline__ int la_sweep_ld(int hd) {
  return (hd < LA_COLS ? hd : LA_COLS) + 1;
}
// the elements of one of la_dots' chunk tiles
__host__ __device__ __forceinline__ int la_chunk_tile() {
  return LA_TILE * (LA_HC + 1);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// CH (past LA_RES_HD head columns): q and k stream through la_dots' chunk
// tiles and v through a tile of the sweep's columns, so shared memory does
// not grow with hd; else q's rows stay whole and k and v are staged whole.
template <typename T, bool ROUND, bool DROP, bool CH>
__global__ void __launch_bounds__(LA_THREADS)
long_attention_f32rows(LongAttn a) {
  extern __shared__ __align__(16) float la_smem[];
  const int hd = a.hd, lds = hd + 1;
  const int vld = CH ? la_sweep_ld(hd) : lds;
  float* qsm = la_smem;             // [16][lds] the tile's queries
  float* ksm = qsm + LA_TILE * lds;  // [16][lds] a key tile
  float* vsm = CH ? la_smem + 2 * la_chunk_tile()  // [16][vld] its values
                  : ksm + LA_TILE * lds;
  float* psm = vsm + LA_TILE * vld;  // [16][LA_PLD] coefficients
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = blockIdx.y * LA_TILE;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15, qi = q0 + r;
  const T* qb = static_cast<const T*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + seq * a.vs.b + h * a.vs.h;
  if constexpr (!CH) la_stage<T, false>(qsm, lds, qb, a.qs.t, q0, a.Nq, hd);

  // the score of (qi, key k0 + c)
  auto score = [&](int k0) {
    const float mk = la_mask(a, qi, k0 + c);
    if constexpr (CH) {
      float d, unused;
      la_dots<T, false, false>(la_smem, a, qb, nullptr, 0, q0, kb, nullptr,
                               k0, r, c, d, unused);
      return la_score_of(d, mk, a.scale);
    } else {
      return la_score(qsm + r * lds, ksm + c * lds, hd, mk, a.scale);
    }
  };

  // 1. each query's running max m and sum l over the key tiles
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < a.Nk; k0 += LA_TILE) {
    if constexpr (!CH) {
      __syncthreads();  // q is staged; the previous tile is read
      la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
      __syncthreads();
    }
    const float s = score(k0);
    const float mn = fmaxf(m, la_max16(s));
    const float e =
        mn != -INFINITY && s != -INFINITY ? expf(__fsub_rn(s, mn)) : 0.f;
    const float es = la_sum16(e);
    if (mn != -INFINITY) {
      l = __fadd_rn(m != -INFINITY ? __fmul_rn(l, expf(__fsub_rn(m, mn)))
                                   : 0.f,
                    es);
      m = mn;
    }
  }
  const size_t row = ((size_t)seq * a.H + h) * a.Nq + qi;
  if (a.stats != nullptr && c == 0 && qi < a.Nq) {
    a.stats[2 * row] = m;
    a.stats[2 * row + 1] = l;
  }

  // 2. P . V, LA_COLS head columns a sweep; with dao, D on the way
  const size_t orow = (((size_t)seq * a.Nq + qi) * a.H + h) * hd;
  float dsum = 0.f;
  for (int cb = 0; cb < hd; cb += LA_COLS) {
    float o[LA_PER];
#pragma unroll
    for (int i = 0; i < LA_PER; ++i) o[i] = 0.f;
    for (int k0 = 0; k0 < a.Nk; k0 += LA_TILE) {
      if constexpr (!CH) {
        __syncthreads();  // the previous tile is read
        la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
        la_stage<T, false>(vsm, lds, vb, a.vs.t, k0, a.Nk, hd);
        __syncthreads();
      }
      const int ki = k0 + c;
      const float s = score(k0);
      // CH: la_dots' first barrier ordered the previous tile's reads
      if constexpr (CH)
        la_stage<T, false>(vsm, vld, vb + cb, a.vs.t, k0, a.Nk,
                           min(LA_COLS, hd - cb));
      psm[r * LA_PLD + c] = la_coef<T, ROUND, DROP>(
          la_prob(s, m, l), la_keep<DROP>(a, seq, h, qi, ki));
      __syncthreads();
      for (int kk = 0; kk < LA_TILE; ++kk) {
        const float w = psm[r * LA_PLD + kk];
        if (w == 0.f) continue;  // a masked key, or one past Nk
        const float* vr = vsm + kk * vld + (CH ? 0 : cb) + c;
#pragma unroll
        for (int i = 0; i < LA_PER; ++i)
          if (cb + c + LA_TILE * i < hd)
            o[i] = fmaf(w, vr[LA_TILE * i], o[i]);
      }
    }
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < LA_PER; ++i) {
      const int col = cb + c + LA_TILE * i;
      if (qi < a.Nq && col < hd) {
        static_cast<T*>(a.out)[orow + col] = from_f32<T>(o[i]);
        if (a.dao != nullptr) {
          float g = a.dao[orow + col];
          if (ROUND) g = to_f32(from_f32<T>(g));
          part = fmaf(g, o[i], part);
        }
      }
    }
    if (a.dao != nullptr) dsum = __fadd_rn(dsum, la_sum16(part));
  }
  if (a.dsum != nullptr && c == 0 && qi < a.Nq) a.dsum[row] = dsum;
}

template <typename T, bool ROUND, bool DROP, bool CH>
static cudaError_t launch_long_f32rows_as(const LongAttn& a,
                                          cudaStream_t stream) {
  const size_t smem =
      (CH ? 2 * la_chunk_tile() + LA_TILE * la_sweep_ld(a.hd)
          : 3 * LA_TILE * la_lds(a.hd)) * sizeof(float) +
      LA_TILE * LA_PLD * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      long_attention_f32rows<T, ROUND, DROP, CH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_seq * a.H, (a.Nq + LA_TILE - 1) / LA_TILE);
  long_attention_f32rows<T, ROUND, DROP, CH>
      <<<grid, LA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool ROUND, bool DROP>
static cudaError_t launch_long_f32rows(const LongAttn& a,
                                       cudaStream_t stream) {
  return a.hd > LA_RES_HD
             ? launch_long_f32rows_as<T, ROUND, DROP, true>(a, stream)
             : launch_long_f32rows_as<T, ROUND, DROP, false>(a, stream);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The pair (query qi, key ki) of mask entry mk (not -inf) from its dots
// (q . k and dao . v): its coefficient of P . V (pk) and ds, from the stash
// (m, l) and D of the query.
template <typename T, bool ROUND, bool DROP>
__device__ __forceinline__ void la_pair_of(const LongAttn& a, int seq, int h,
                                           int qi, int ki, float mk,
                                           float sdot, float dpr, float& pk,
                                           float& ds) {
  const size_t row = ((size_t)seq * a.H + h) * a.Nq + qi;
  const float m = a.stats[2 * row], l = a.stats[2 * row + 1];
  const float p = la_prob(la_score_of(sdot, mk, a.scale), m, l);
  const float keep = la_keep<DROP>(a, seq, h, qi, ki);
  pk = la_coef<T, ROUND, DROP>(p, keep);
  const float dp = DROP ? __fmul_rn(dpr, keep) : dpr;
  ds = __fmul_rn(p, __fsub_rn(dp, a.dsum[row]));
  if (ROUND) ds = to_f32(from_f32<T>(ds));
}

// The pair (query qi = row r of qsm / gsm, key ki = row c of ksm / vsm):
// pk and ds, zeros for a masked pair or one past the extent.
template <typename T, bool ROUND, bool DROP>
__device__ __forceinline__ void la_pair_grad(const LongAttn& a, int seq,
                                             int h, int qi, int ki,
                                             const float* qrow,
                                             const float* grow,
                                             const float* krow,
                                             const float* vrow, float& pk,
                                             float& ds) {
  pk = 0.f, ds = 0.f;
  const float mk = la_mask(a, qi, ki);
  if (mk == -INFINITY) return;
  la_pair_of<T, ROUND, DROP>(a, seq, h, qi, ki, mk, la_dot(qrow, krow, a.hd),
                             la_dot(grow, vrow, a.hd), pk, ds);
}

// The pair of thread (r, c), query q0 + r and key k0 + c, in the CH forms:
// its dots streamed through la_dots (block-wide), then pk and ds.
template <typename T, bool ROUND, bool DROP>
__device__ __forceinline__ void la_pair_chunked(float* buf, const LongAttn& a,
                                                int seq, int h, const T* qb,
                                                const float* gb, long long gld,
                                                int q0, const T* kb,
                                                const T* vb, int k0, int r,
                                                int c, float& pk, float& ds) {
  float sd, dd;
  la_dots<T, ROUND, true>(buf, a, qb, gb, gld, q0, kb, vb, k0, r, c, sd, dd);
  pk = 0.f, ds = 0.f;
  const float mk = la_mask(a, q0 + r, k0 + c);
  if (mk != -INFINITY)
    la_pair_of<T, ROUND, DROP>(a, seq, h, q0 + r, k0 + c, mk, sd, dd, pk, ds);
}

// One block a tile of 16 keys: dK and dV over every query tile. CH: the
// dots through la_dots' chunk tiles, then the query tile's q and dao rows
// over the sweep's columns; else k, v whole and resident, q and dao whole.
template <typename T, bool ROUND, bool DROP, bool CH>
__global__ void __launch_bounds__(LA_THREADS)
long_attention_f32rows_dkdv(LongAttn a) {
  extern __shared__ __align__(16) float la_smem[];
  const int hd = a.hd, lds = CH ? la_sweep_ld(hd) : hd + 1;
  // resident: k, v, q, dao rows; CH: la_dots' tiles, then q and dao
  float* ksm = la_smem;              // [16][lds] this block's keys
  float* vsm = ksm + LA_TILE * lds;  // [16][lds] their values
  float* qsm = CH ? la_smem + 4 * la_chunk_tile()  // [16][lds] a query tile
                  : vsm + LA_TILE * lds;
  float* gsm = qsm + LA_TILE * lds;  // [16][lds] its dao rows
  float* psm = gsm + LA_TILE * lds;  // [16][LA_PLD] pk
  float* dsm = psm + LA_TILE * LA_PLD;  // [16][LA_PLD] ds
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int k0 = blockIdx.y * LA_TILE;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const T* qb = static_cast<const T*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + seq * a.vs.b + h * a.vs.h;
  const long long gld = (long long)a.H * hd;  // dao's row stride
  const float* gb = a.dao + (size_t)seq * a.Nq * gld + (size_t)h * hd;
  if constexpr (!CH) {
    la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
    la_stage<T, false>(vsm, lds, vb, a.vs.t, k0, a.Nk, hd);
  }
  const int kr = k0 + r;  // the key whose gradients this thread sums
  for (int cb = 0; cb < hd; cb += LA_COLS) {
    const int co = CH ? 0 : cb;  // the sweep's first column in q / dao rows
    float dk[LA_PER], dv[LA_PER];
#pragma unroll
    for (int i = 0; i < LA_PER; ++i) dk[i] = 0.f, dv[i] = 0.f;
    for (int q0 = 0; q0 < a.Nq; q0 += LA_TILE) {
      float pk, ds;
      if constexpr (CH) {
        la_pair_chunked<T, ROUND, DROP>(la_smem, a, seq, h, qb, gb, gld, q0,
                                        kb, vb, k0, r, c, pk, ds);
        const int w = min(LA_COLS, hd - cb);
        la_stage<T, false>(qsm, lds, qb + cb, a.qs.t, q0, a.Nq, w);
        la_stage<T, ROUND>(gsm, lds, gb + cb, gld, q0, a.Nq, w);
      } else {
        __syncthreads();  // k, v are staged; the previous tile is read
        la_stage<T, false>(qsm, lds, qb, a.qs.t, q0, a.Nq, hd);
        la_stage<T, ROUND>(gsm, lds, gb, gld, q0, a.Nq, hd);
        __syncthreads();
        la_pair_grad<T, ROUND, DROP>(a, seq, h, q0 + r, k0 + c,
                                     qsm + r * lds, gsm + r * lds,
                                     ksm + c * lds, vsm + c * lds, pk, ds);
      }
      psm[r * LA_PLD + c] = pk;
      dsm[r * LA_PLD + c] = ds;
      __syncthreads();
      // thread (key r, columns c + 16 i): sums over the tile's queries
      for (int qq = 0; qq < LA_TILE; ++qq) {
        const float wd = dsm[qq * LA_PLD + r], wp = psm[qq * LA_PLD + r];
        const float* qr = qsm + qq * lds + co + c;
        const float* gr = gsm + qq * lds + co + c;
        if (wd != 0.f) {
#pragma unroll
          for (int i = 0; i < LA_PER; ++i)
            if (cb + c + LA_TILE * i < hd)
              dk[i] = fmaf(wd, qr[LA_TILE * i], dk[i]);
        }
        if (wp != 0.f) {
#pragma unroll
          for (int i = 0; i < LA_PER; ++i)
            if (cb + c + LA_TILE * i < hd)
              dv[i] = fmaf(wp, gr[LA_TILE * i], dv[i]);
        }
      }
    }
    if (kr < a.Nk) {
      T* dkr = static_cast<T*>(a.dk) + seq * a.dks.b + kr * a.dks.t +
               h * a.dks.h;
      T* dvr = static_cast<T*>(a.dv) + seq * a.dvs.b + kr * a.dvs.t +
               h * a.dvs.h;
#pragma unroll
      for (int i = 0; i < LA_PER; ++i) {
        const int col = cb + c + LA_TILE * i;
        if (col < hd) {
          dkr[col] = from_f32<T>(__fmul_rn(dk[i], a.scale));
          dvr[col] = from_f32<T>(dv[i]);
        }
      }
    }
  }
}

// One block a tile of 16 queries: dQ over every key tile. CH: the dots
// through la_dots' chunk tiles, then the key tile's k rows over the sweep's
// columns; else q and dao whole and resident, k and v whole.
template <typename T, bool ROUND, bool DROP, bool CH>
__global__ void __launch_bounds__(LA_THREADS)
long_attention_f32rows_dq(LongAttn a) {
  extern __shared__ __align__(16) float la_smem[];
  const int hd = a.hd, lds = CH ? la_sweep_ld(hd) : hd + 1;
  float* qsm = la_smem;              // [16][lds] this block's queries
  float* gsm = qsm + LA_TILE * lds;  // [16][lds] their dao rows
  float* ksm = CH ? la_smem + 4 * la_chunk_tile()  // [16][lds] a key tile
                  : gsm + LA_TILE * lds;
  float* vsm = ksm + LA_TILE * lds;  // [16][lds] its values
  float* dsm = CH ? ksm + LA_TILE * lds  // [16][LA_PLD] ds
                  : vsm + LA_TILE * lds;
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = blockIdx.y * LA_TILE;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15, qi = q0 + r;
  const T* qb = static_cast<const T*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + seq * a.vs.b + h * a.vs.h;
  const long long gld = (long long)a.H * hd;
  const float* gb = a.dao + (size_t)seq * a.Nq * gld + (size_t)h * hd;
  if constexpr (!CH) {
    la_stage<T, false>(qsm, lds, qb, a.qs.t, q0, a.Nq, hd);
    la_stage<T, ROUND>(gsm, lds, gb, gld, q0, a.Nq, hd);
  }
  for (int cb = 0; cb < hd; cb += LA_COLS) {
    const int co = CH ? 0 : cb;  // the sweep's first column in k rows
    float dq[LA_PER];
#pragma unroll
    for (int i = 0; i < LA_PER; ++i) dq[i] = 0.f;
    for (int k0 = 0; k0 < a.Nk; k0 += LA_TILE) {
      float pk, ds;
      if constexpr (CH) {
        la_pair_chunked<T, ROUND, DROP>(la_smem, a, seq, h, qb, gb, gld, q0,
                                        kb, vb, k0, r, c, pk, ds);
        la_stage<T, false>(ksm, lds, kb + cb, a.ks.t, k0, a.Nk,
                           min(LA_COLS, hd - cb));
      } else {
        __syncthreads();  // q, dao are staged; the previous tile is read
        la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
        la_stage<T, false>(vsm, lds, vb, a.vs.t, k0, a.Nk, hd);
        __syncthreads();
        la_pair_grad<T, ROUND, DROP>(a, seq, h, qi, k0 + c, qsm + r * lds,
                                     gsm + r * lds, ksm + c * lds,
                                     vsm + c * lds, pk, ds);
      }
      dsm[r * LA_PLD + c] = ds;
      __syncthreads();
      // thread (query r, columns c + 16 i): sums over the tile's keys
      for (int kk = 0; kk < LA_TILE; ++kk) {
        const float w = dsm[r * LA_PLD + kk];
        if (w == 0.f) continue;
        const float* kr = ksm + kk * lds + co + c;
#pragma unroll
        for (int i = 0; i < LA_PER; ++i)
          if (cb + c + LA_TILE * i < hd)
            dq[i] = fmaf(w, kr[LA_TILE * i], dq[i]);
      }
    }
    if (qi < a.Nq) {
      T* dqr = static_cast<T*>(a.dq) + seq * a.dqs.b + qi * a.dqs.t +
               h * a.dqs.h;
#pragma unroll
      for (int i = 0; i < LA_PER; ++i) {
        const int col = cb + c + LA_TILE * i;
        if (col < hd) dqr[col] = from_f32<T>(__fmul_rn(dq[i], a.scale));
      }
    }
  }
}

// The CUDA-core backward: the forward kernel again (O, the stash, D), then
// dK / dV over key tiles and dQ over query tiles.
template <typename T, bool ROUND, bool DROP, bool CH>
static cudaError_t launch_long_f32rows_bwd_as(const LongAttn& a,
                                              cudaStream_t stream) {
  cudaError_t err = launch_long_f32rows_as<T, ROUND, DROP, CH>(a, stream);
  if (err != cudaSuccess) return err;
  const size_t rows =
      (CH ? 4 * la_chunk_tile() + 2 * LA_TILE * la_sweep_ld(a.hd)
          : 4 * LA_TILE * la_lds(a.hd)) * sizeof(float);
  const size_t rows_q =
      (CH ? 4 * la_chunk_tile() + LA_TILE * la_sweep_ld(a.hd)
          : 4 * LA_TILE * la_lds(a.hd)) * sizeof(float);
  const size_t smem_kv = rows + 2 * LA_TILE * LA_PLD * sizeof(float);
  const size_t smem_q = rows_q + LA_TILE * LA_PLD * sizeof(float);
  err = cudaFuncSetAttribute(long_attention_f32rows_dkdv<T, ROUND, DROP, CH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(long_attention_f32rows_dq<T, ROUND, DROP, CH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  const dim3 gk(a.n_seq * a.H, (a.Nk + LA_TILE - 1) / LA_TILE);
  long_attention_f32rows_dkdv<T, ROUND, DROP, CH>
      <<<gk, LA_THREADS, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq(a.n_seq * a.H, (a.Nq + LA_TILE - 1) / LA_TILE);
  long_attention_f32rows_dq<T, ROUND, DROP, CH>
      <<<gq, LA_THREADS, smem_q, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool ROUND, bool DROP>
static cudaError_t launch_long_f32rows_bwd(const LongAttn& a,
                                           cudaStream_t stream) {
  return a.hd > LA_RES_HD
             ? launch_long_f32rows_bwd_as<T, ROUND, DROP, true>(a, stream)
             : launch_long_f32rows_bwd_as<T, ROUND, DROP, false>(a, stream);
}

// ---------------------------------------------------------------------------
// the tensor-core forms: bf16 with the probabilities rounded (ROUND)
// ---------------------------------------------------------------------------

constexpr int LM_THREADS = 256;      // 8 warps
constexpr int LM_KC = 64;            // keys a chunk (queries in dK / dV)
constexpr int LM_HC = 128;           // head columns of a forward score item
constexpr int LM_HC2 = 64;           // of a backward score item (2 operands)
constexpr int LM_NT = 8;             // 8-column tiles of O / dQ a warp keeps
constexpr int LM_NTK = 8;            // of dK and of dV a warp keeps
constexpr int LM_KT = LA_TILE;       // keys a dK / dV block
constexpr int LM_KCW = 8 * LM_NTK * 8;  // head columns a dK / dV sweep
constexpr int LM_PLD = LM_KC + 8;    // row stride of a P or dS tile
constexpr int LM_NQ = LM_KC / 16;    // 16-row output items a chunk
// ring stages (two blocks an SM at <= 128 registers: more blocks in flight
// moved the time, deeper rings did not; NVIDIA H100 80GB HBM3, PERF.md)
constexpr int LM_NST = 3;            // forward
constexpr int LM_NST_DQ = 2;         // dQ
constexpr int LM_NST_KV = 2;         // dK / dV

// A block of MT (1 or 2) 16-query strips; WPM warps share a strip; an
// output sweep covers CW head columns (a warp keeps 16 x 8 LM_NT of O: 32
// registers). Two blocks an SM (<= 128 registers).
template <int MT>
struct LmTile {
  static constexpr int QT = 16 * MT, WPM = 8 / MT, CW = 8 * LM_NT * WPM;
};

// head columns padded to the mma's k of 16 (the padding staged as zeros)
__host__ __device__ __forceinline__ int lm_hdp(int hd) {
  return (hd + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int lm_max(int x, int y) {
  return x > y ? x : y;
}
__host__ __device__ __forceinline__ int lm_min(int x, int y) {
  return x < y ? x : y;
}
// the row stride of a 16-row output item over a sweep of cw columns
__host__ __device__ __forceinline__ int lm_old(int cw, int hdp) {
  return lm_min(cw, hdp) + 8;
}

// acc[j] += A . B_j^T over ksteps 16-column steps, in column order: A the
// 16 rows at a (row stride lda), B_j the 8 rows at b + 8 j ldb (row stride
// ldb), both along the columns; tiles j >= nt are left as they are.
template <int NT>
__device__ __forceinline__ void lm_mma_abt(float (&acc)[NT][4], const bf16* a,
                                           int lda, const bf16* b, int ldb,
                                           int ksteps, int nt) {
#pragma unroll 2
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t af[4];
    ldmatrix_a(af, a + kk * 16, lda);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {  // two tiles a load
      const int j = 2 * jj;
      if (j + 1 < nt) {
        uint32_t b0[2], b1[2];
        ldmatrix_b2(b0, b1, b + 8 * j * ldb + kk * 16, ldb);
        mma_16816(acc[j], af, b0);
        mma_16816(acc[j + 1], af, b1);
      } else if (j < nt) {
        uint32_t b0[2];
        ldmatrix_b1(b0, b + 8 * j * ldb + kk * 16, ldb);
        mma_16816(acc[j], af, b0);
      }
    }
    if constexpr (NT % 2 == 1) {
      if (NT - 1 < nt) {
        uint32_t b0[2];
        ldmatrix_b1(b0, b + 8 * (NT - 1) * ldb + kk * 16, ldb);
        mma_16816(acc[NT - 1], af, b0);
      }
    }
  }
}

// acc[j] += A . B[:, 8 j .. 8 j + 8] over ksteps 16-row steps of B: A the
// 16 rows at a (row stride lda, along k), B row-major at b (row stride ldb),
// its fragments through ldmatrix.trans; tiles j >= nt are left as they are.
template <int NT>
__device__ __forceinline__ void lm_mma_ab(float (&acc)[NT][4], const bf16* a,
                                          int lda, const bf16* b, int ldb,
                                          int ksteps, int nt) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t af[4];
    ldmatrix_a(af, a + kk * 16, lda);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, b + (kk * 16 + (lane & 15)) * ldb + 8 * j);
        mma_16816(acc[j], af, bf);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void lm_zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The score of (query qi, key ki) from its fp32 dot: explicitly rounded,
// so every kernel here gets the same bits from the same dot
__device__ __forceinline__ float lm_score(const LongAttn& a, int qi, int ki,
                                          float dot) {
  const float mk = la_mask(a, qi, ki);
  return mk == -INFINITY ? -INFINITY
                         : __fadd_rn(__fmul_rn(dot, a.scale), mk);
}

// p = exp(s - m) / l from the query's stash, 0 for a masked pair
__device__ __forceinline__ float lm_prob(float s, float m, float l) {
  return s != -INFINITY ? __fdiv_rn(expf(__fsub_rn(s, m)), l) : 0.f;
}

// The first and last key some query q0 .. q0 + nq of a tile sees (every key
// without a mask); hi < lo where it sees none. Block-wide; with a mask it
// ends with a barrier.
__device__ __forceinline__ void lm_key_range(const LongAttn& a, int q0,
                                             int nq, int* range, int& lo,
                                             int& hi) {
  lo = 0, hi = a.Nk - 1;
  if (a.mask == nullptr) return;
  if (threadIdx.x == 0) range[0] = 0x7fffffff, range[1] = -1;
  __syncthreads();
  int l = 0x7fffffff, h = -1;
  const float* mt = a.mask + (size_t)q0 * a.Nk;  // the tile's rows
  const int total = nq * a.Nk;
#pragma unroll 8
  for (int i = threadIdx.x; i < total; i += LM_THREADS)
    if (mt[i] != -INFINITY) {
      const int k = i % a.Nk;
      l = min(l, k), h = max(h, k);
    }
  l = __reduce_min_sync(0xffffffffu, l);
  h = __reduce_max_sync(0xffffffffu, h);
  if ((threadIdx.x & 31) == 0) atomicMin(&range[0], l), atomicMax(&range[1], h);
  __syncthreads();
  lo = range[0], hi = range[1];
}

// The first and last query that sees some key k0 .. k0 + nk of a tile
__device__ __forceinline__ void lm_query_range(const LongAttn& a, int k0,
                                               int nk, int* range, int& lo,
                                               int& hi) {
  lo = 0, hi = a.Nq - 1;
  if (a.mask == nullptr) return;
  if (threadIdx.x == 0) range[0] = 0x7fffffff, range[1] = -1;
  __syncthreads();
  int l = 0x7fffffff, h = -1;
  for (int r = threadIdx.x; r < a.Nq; r += LM_THREADS) {
    const float* mr = a.mask + (size_t)r * a.Nk + k0;
    for (int c = 0; c < nk; ++c)
      if (mr[c] != -INFINITY) {
        l = min(l, r), h = max(h, r);
        break;
      }
  }
  l = __reduce_min_sync(0xffffffffu, l);
  h = __reduce_max_sync(0xffffffffu, h);
  if ((threadIdx.x & 31) == 0) atomicMin(&range[0], l), atomicMax(&range[1], h);
  __syncthreads();
  lo = range[0], hi = range[1];
}

// -- forward ----------------------------------------------------------------

// QS: q's rows stream through the ring beside k's (past LA_RES_HD head
// columns), else they stay resident
template <int MT, bool QS>
static size_t lm_fwd_smem(int hd) {
  using Tile = LmTile<MT>;
  const int hdp = lm_hdp(hd);
  const int stage = lm_max((LM_KC + (QS ? Tile::QT : 0)) * (LM_HC + 8),
                           16 * lm_old(Tile::CW, hdp));
  return ((QS ? 0 : (size_t)Tile::QT * (hdp + 8)) + LM_NST * (size_t)stage +
          (size_t)Tile::QT * LM_PLD) * sizeof(bf16) +
         (size_t)Tile::QT * Tile::WPM * 2 * sizeof(float);
}

// One block a (sequence, head, tile of QT = 16 MT queries), 8 warps. Warp w
// takes the 16 queries of strip w / WPM; of a 64-key chunk's scores it takes
// the MT 8-key tiles from 8 MT (w % WPM) on, of an output sweep the LM_NT
// 8-column tiles from 8 LM_NT (w % WPM) on. The tile's q rows stay in shared
// memory; the items stream through a ring of LM_NST stages: the score items (a
// chunk's k rows, LM_HC head columns), then the output items (16 of its v
// rows, the sweep's columns). Pass 1 takes each query's max m and sum l
// over the chunks (online, each warp over its keys, the WPM partials
// combined in order); pass 2, once a sweep, rebuilds each chunk's scores
// and forms p = exp(s - m) / l (times its keep multiplier) rounded to bf16
// into a shared P tile, then O += P . V. With a.stats / a.dao / a.dsum the
// stash (m, l), D = rowsum(dao . O) and, with a.dq, dao rounded to bf16 in
// dQ's place (the backward's operand, read there before dQ overwrites it).
// QS (past LA_RES_HD head columns): each score item also stages the tile's
// q rows over its LM_HC columns, after the chunk's k rows, so shared memory
// does not grow with hd; the products and their order are the same.
template <int MT, bool DROP, bool QS>
__global__ void __launch_bounds__(LM_THREADS, 2)
long_attention_mma(LongAttn a, bool vec) {
  using Tile = LmTile<MT>;
  constexpr int QT = Tile::QT, WPM = Tile::WPM, CW = Tile::CW, NST = LM_NST;
  constexpr int KLD = LM_HC + 8;
  extern __shared__ __align__(16) unsigned char lm_smem[];
  __shared__ int range[2];
  const int hd = a.hd, hdp = lm_hdp(hd), QLD = hdp + 8;
  const int VLD = lm_old(CW, hdp);
  const int STAGE = lm_max((LM_KC + (QS ? QT : 0)) * KLD, 16 * VLD);
  bf16* qsm = reinterpret_cast<bf16*>(lm_smem);  // [QT][QLD] the tile's q
  bf16* ring = QS ? qsm : qsm + QT * QLD;          // NST stages
  bf16* psm = ring + NST * STAGE;                  // [QT][LM_PLD] P
  float* part = reinterpret_cast<float*>(psm + QT * LM_PLD);  // [QT][WPM][2]
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = blockIdx.y * QT, nq = min(QT, a.Nq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / WPM) * 16, kp = warp % WPM;
  const int n0 = kp * 8 * MT, oc0 = kp * 8 * LM_NT;
  const bool rows = m0 < nq;  // the warp's strip holds a query
  const bf16* qb = static_cast<const bf16*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + seq * a.vs.b + h * a.vs.h;
  bf16* out = static_cast<bf16*>(a.out);
  bf16* dqc = static_cast<bf16*>(a.dq);
  const size_t srow = ((size_t)seq * a.H + h) * a.Nq;  // stash of query 0
  const size_t obase = ((size_t)seq * a.Nq * a.H + h) * hd;
  const size_t orow = (size_t)a.H * hd;  // elements between output rows
  if constexpr (!QS)
    stage_rows<LM_THREADS>(qsm, QLD, qb, a.qs.t, q0, QT, 0, a.Nq - 1, nullptr,
                           hdp, hd, vec);
  int klo, khi;
  lm_key_range(a, q0, nq, range, klo, khi);
  const int c_lo = klo / LM_KC;
  const int nch = khi >= klo ? khi / LM_KC - c_lo + 1 : 0;
  const int nhc = (hdp + LM_HC - 1) / LM_HC, nsw = (hdp + CW - 1) / CW;
  const int ipc = nhc + LM_NQ, n1 = nch * nhc, n = n1 + nsw * nch * ipc;

  // item i: chunk ci of sweep sw (-1: pass 1); x < nhc the chunk's k
  // columns x LM_HC .., else its v rows 16 (x - nhc) .. over the sweep
  auto decode = [&](int i, int& ci, int& sw, int& x) {
    if (i < n1) {
      ci = i / nhc, x = i - ci * nhc, sw = -1;
      return;
    }
    int j = i - n1;
    sw = j / (nch * ipc);
    j -= sw * nch * ipc;
    ci = j / ipc, x = j - ci * ipc;
  };
  auto issue = [&](int i, int buf) {
    int ci, sw, x;
    decode(i, ci, sw, x);
    bf16* st = ring + buf * STAGE;
    const int k0 = (c_lo + ci) * LM_KC;
    if (x < nhc) {
      const int c0 = x * LM_HC;
      stage_rows<LM_THREADS>(st, KLD, kb + c0, a.ks.t, k0, LM_KC, klo, khi,
                             nullptr, lm_min(LM_HC, hdp - c0), hd - c0, vec);
      if constexpr (QS)
        stage_rows<LM_THREADS>(st + LM_KC * KLD, KLD, qb + c0, a.qs.t, q0, QT,
                               0, a.Nq - 1, nullptr, lm_min(LM_HC, hdp - c0),
                               hd - c0, vec);
    } else {
      const int c0 = sw * CW;
      stage_rows<LM_THREADS>(st, VLD, vb + c0, a.vs.t, k0 + 16 * (x - nhc), 16,
                             klo, khi, nullptr, lm_min(CW, hdp - c0), hd - c0,
                             vec);
    }
  };

  float acc[MT][4], o[LM_NT][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};
  float dpart[2] = {0.f, 0.f};
  bool combined = false;

  // a chunk's scores are whole: pass 1 updates the warp's (m, l), pass 2
  // writes the chunk's P
  auto scores = [&](int ci, int sw, int k0) {
    float s[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = lm_score(a, q0 + m0 + g + (e >> 1) * 8,
                           k0 + n0 + 8 * j + 2 * t + (e & 1), acc[j][e]);
    if (sw < 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < MT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m_run[hr], mx);
        float es = 0.f;
        if (mn != -INFINITY) {
#pragma unroll
          for (int j = 0; j < MT; ++j)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e)
              if (s[j][e] != -INFINITY)
                es = __fadd_rn(es, expf(__fsub_rn(s[j][e], mn)));
        }
        es = __fadd_rn(es, __shfl_xor_sync(0xffffffffu, es, 1));
        es = __fadd_rn(es, __shfl_xor_sync(0xffffffffu, es, 2));
        if (mn != -INFINITY) {
          l_run[hr] = __fadd_rn(
              m_run[hr] != -INFINITY
                  ? __fmul_rn(l_run[hr], expf(__fsub_rn(m_run[hr], mn)))
                  : 0.f,
              es);
          m_run[hr] = mn;
        }
        if (ci == nch - 1 && t == 0) {  // the warp's partial, for pass 2
          float* pr = part + ((m0 + g + 8 * hr) * WPM + kp) * 2;
          pr[0] = m_run[hr], pr[1] = l_run[hr];
        }
      }
      return;
    }
    if (!combined) {  // every partial was written before the last barrier
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr;
        const float* pr = part + r * WPM * 2;
        float m = -INFINITY, l = 0.f;
        for (int w = 0; w < WPM; ++w) m = fmaxf(m, pr[2 * w]);
        if (m != -INFINITY)
          for (int w = 0; w < WPM; ++w)
            if (pr[2 * w] != -INFINITY)
              l = __fadd_rn(l, __fmul_rn(pr[2 * w + 1],
                                         expf(__fsub_rn(pr[2 * w], m))));
        m_row[hr] = m, l_row[hr] = l;
        if (a.stats != nullptr && kp == 0 && t == 0 && q0 + r < a.Nq) {
          a.stats[2 * (srow + q0 + r)] = m;
          a.stats[2 * (srow + q0 + r) + 1] = l;
        }
      }
      combined = true;
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qi = q0 + m0 + g + 8 * hr, ki = k0 + n0 + 8 * j + 2 * t;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = lm_prob(s[j][2 * hr + e], m_row[hr], l_row[hr]);
          if (DROP && p[e] != 0.f)
            p[e] = __fmul_rn(p[e], la_keep<DROP>(a, seq, h, qi, ki + e));
        }
        *reinterpret_cast<__nv_bfloat162*>(
            psm + (m0 + g + 8 * hr) * LM_PLD + n0 + 8 * j + 2 * t) =
            __floats2bfloat162_rn(p[0], p[1]);
      }
  };

  // the sweep's columns of O: out (bf16); with dao, D's partial sums and
  // dao rounded into dQ's place
  auto write_sweep = [&](int sw, int nt) {
#pragma unroll
    for (int j = 0; j < LM_NT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qi = q0 + m0 + g + 8 * hr;
        const int col = sw * CW + oc0 + 8 * j + 2 * t;
        if (qi >= a.Nq) continue;
        const size_t at = obase + (size_t)qi * orow + col;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= hd) continue;
          const float ov = o[j][2 * hr + e];
          out[at + e] = __float2bfloat16(ov);
          if (a.dao != nullptr) {
            const bf16 gr = __float2bfloat16(a.dao[at + e]);
            dpart[hr] = fmaf(__bfloat162float(gr), ov, dpart[hr]);
            if (dqc != nullptr)
              dqc[seq * a.dqs.b + qi * a.dqs.t + h * a.dqs.h + col + e] = gr;
          }
        }
      }
    }
  };

  auto use = [&](int i, int buf) {
    int ci, sw, x;
    decode(i, ci, sw, x);
    const bf16* st = ring + buf * STAGE;
    const int k0 = (c_lo + ci) * LM_KC;
    if (x < nhc) {
      if (x == 0) lm_zero(acc);
      const int c0 = x * LM_HC;
      // a warp whose keys all lie outside [klo, khi] keeps zeros: its
      // scores are masked
      if (rows && k0 + n0 <= khi && k0 + n0 + 8 * MT > klo) {
        if constexpr (QS)
          lm_mma_abt<MT>(acc, st + (LM_KC + m0) * KLD, KLD, st + n0 * KLD,
                         KLD, lm_min(LM_HC, hdp - c0) / 16, MT);
        else
          lm_mma_abt<MT>(acc, qsm + m0 * QLD + c0, QLD, st + n0 * KLD, KLD,
                         lm_min(LM_HC, hdp - c0) / 16, MT);
      }
      if (x == nhc - 1) scores(ci, sw, k0);
    } else {
      const int xq = x - nhc;
      if (ci == 0 && xq == 0) lm_zero(o);
      const int nt = max(0, min(LM_NT, (hdp - sw * CW - oc0) / 8));
      if (rows && nt > 0)
        lm_mma_ab<LM_NT>(o, psm + m0 * LM_PLD + 16 * xq, LM_PLD, st + oc0,
                         VLD, 1, nt);
      if (ci == nch - 1 && xq == LM_NQ - 1) write_sweep(sw, nt);
    }
  };
  ring_run<NST>(n, issue, use);

  if (nch == 0) {  // no query of the tile sees a key: zeros
    for (int i = threadIdx.x; i < nq * hd; i += LM_THREADS) {
      const int r = i / hd, c = i - r * hd, qi = q0 + r;
      const size_t at = obase + (size_t)qi * orow + c;
      out[at] = __float2bfloat16(0.f);
      if (a.dao != nullptr && dqc != nullptr)
        dqc[seq * a.dqs.b + qi * a.dqs.t + h * a.dqs.h + c] =
            __float2bfloat16(a.dao[at]);
    }
    if (a.stats != nullptr)
      for (int r = threadIdx.x; r < nq; r += LM_THREADS) {
        a.stats[2 * (srow + q0 + r)] = -INFINITY;
        a.stats[2 * (srow + q0 + r) + 1] = 0.f;
      }
  }
  if (a.dsum != nullptr && a.dao != nullptr) {
    // D: this thread's columns, its quad's, then the WPM warps' in order
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      dpart[hr] = __fadd_rn(dpart[hr],
                            __shfl_xor_sync(0xffffffffu, dpart[hr], 1));
      dpart[hr] = __fadd_rn(dpart[hr],
                            __shfl_xor_sync(0xffffffffu, dpart[hr], 2));
      if (t == 0) part[(m0 + g + 8 * hr) * WPM + kp] = dpart[hr];
    }
    __syncthreads();
    if (threadIdx.x < nq) {
      float d = 0.f;
      for (int w = 0; w < WPM; ++w)
        d = __fadd_rn(d, part[threadIdx.x * WPM + w]);
      a.dsum[srow + q0 + threadIdx.x] = d;
    }
  }
}

template <int MT, bool DROP, bool QS>
static cudaError_t lm_launch_fwd(const LongAttn& a, bool vec,
                                 cudaStream_t stream) {
  const size_t smem = lm_fwd_smem<MT, QS>(a.hd);
  const cudaError_t err = cudaFuncSetAttribute(
      long_attention_mma<MT, DROP, QS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_seq * a.H, cdiv(a.Nq, LmTile<MT>::QT));
  long_attention_mma<MT, DROP, QS><<<grid, LM_THREADS, smem, stream>>>(a,
                                                                         vec);
  return cudaGetLastError();
}

// The forward's tile: 16 queries up to 16 queries or past 256 head columns
// (hd 512 in one sweep of O, hd 1,024 in two, ...), else 32 (hd 256 in one
// sweep), as dQ's; past LA_RES_HD head columns q streams (QS).
template <bool DROP>
static cudaError_t launch_long_mma(const LongAttn& a, bool vec,
                                   cudaStream_t stream) {
  if (a.hd > LA_RES_HD) return lm_launch_fwd<1, DROP, true>(a, vec, stream);
  return a.Nq <= 16 || lm_hdp(a.hd) > 256
             ? lm_launch_fwd<1, DROP, false>(a, vec, stream)
             : lm_launch_fwd<2, DROP, false>(a, vec, stream);
}

// Every row and 16-byte column group of q, k, v (and, with dq, of dQ's
// place, the backward's copy of dao) starts 16-byte aligned.
static bool lm_rows_aligned(const LongAttn& a, bool with_dq) {
  const bf16* q = static_cast<const bf16*>(a.q);
  bool ok = attn_rows_aligned<bf16>(q, static_cast<const bf16*>(a.k),
                                    static_cast<const bf16*>(a.v), a.qs, a.ks,
                                    a.vs, a.hd);
  if (with_dq)
    ok = ok && attn_rows_aligned<bf16>(static_cast<const bf16*>(a.dq), q, q,
                                       a.dqs, a.qs, a.qs, a.hd);
  return ok;
}

// -- backward ---------------------------------------------------------------

// Rows r0 .. r0 + n of an fp32 operand (row t at src + t * ld) rounded to
// bf16, columns 0 .. width, into dst (row stride ldd), element by element:
// rows past hi and the columns at or past w are zeros and are not read
template <int NTHR>
__device__ __forceinline__ void stage_rows_rounded(bf16* dst, int ldd,
                                                   const float* src,
                                                   long long ld, int r0, int n,
                                                   int hi, int width, int w) {
  for (int i = threadIdx.x; i < n * width; i += NTHR) {
    const int r = i / width, c = i - r * width, t = r0 + r;
    dst[r * ldd + c] =
        __float2bfloat16(t <= hi && c < w ? src[t * ld + c] : 0.f);
  }
}

// QS: q's and dao's rows stream through the ring (past LA_RES_HD head
// columns), else they stay resident
template <int MT, bool QS>
static size_t lm_dq_smem(int hd) {
  using Tile = LmTile<MT>;
  const int hdp = lm_hdp(hd);
  const int stage = lm_max(2 * (LM_KC + (QS ? Tile::QT : 0)) * (LM_HC2 + 8),
                           16 * lm_old(Tile::CW, hdp));
  return ((QS ? 0 : 2 * (size_t)Tile::QT * (hdp + 8)) +
          LM_NST_DQ * (size_t)stage + (size_t)Tile::QT * LM_PLD) *
         sizeof(bf16);
}

// dQ: one block a (sequence, head, tile of 16 MT queries), its q rows and
// dao rows (rounded, from dQ's place) in shared memory; the items stream
// through a ring of 2 stages: a chunk's score items (LM_HC2 head columns of
// its k and v rows: S = q . k^T and dao . v^T on the forward's fragments in
// the forward's column order), then its output items (16 of its k rows over
// the sweep's columns). dS = p (dp - D) (dp = dao . v^T * keep), rounded,
// into a shared tile; dQ += dS . k; dQ = scale * dQ, rounded, overwrites
// the block's own dao rows. QS (past LA_RES_HD head columns): each score
// item also stages the tile's q rows and its dao rows (from the fp32 dao,
// rounded as the forward rounded them, since a sweep's dQ overwrites the
// copy in dQ's place) over its LM_HC2 columns, after the chunk's k and v.
template <int MT, bool DROP, bool QS>
__global__ void __launch_bounds__(LM_THREADS, 2)
long_attention_mma_dq(LongAttn a, bool vec) {
  using Tile = LmTile<MT>;
  constexpr int QT = Tile::QT, WPM = Tile::WPM, CW = Tile::CW;
  constexpr int NST = LM_NST_DQ;
  constexpr int KLD = LM_HC2 + 8;
  extern __shared__ __align__(16) unsigned char lm_smem[];
  __shared__ int range[2];
  const int hd = a.hd, hdp = lm_hdp(hd), QLD = hdp + 8;
  const int VLD = lm_old(CW, hdp);
  const int STAGE = lm_max(2 * (LM_KC + (QS ? QT : 0)) * KLD, 16 * VLD);
  bf16* qsm = reinterpret_cast<bf16*>(lm_smem);  // [QT][QLD] q
  bf16* gsm = qsm + QT * QLD;                      // [QT][QLD] dao, rounded
  bf16* ring = QS ? qsm : gsm + QT * QLD;          // NST stages
  bf16* dssm = ring + NST * STAGE;                 // [QT][LM_PLD] dS
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = blockIdx.y * QT, nq = min(QT, a.Nq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / WPM) * 16, kp = warp % WPM;
  const int n0 = kp * 8 * MT, oc0 = kp * 8 * LM_NT;
  const bool rows = m0 < nq;
  const bf16* qb = static_cast<const bf16*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + seq * a.vs.b + h * a.vs.h;
  bf16* dqb = static_cast<bf16*>(a.dq) + seq * a.dqs.b + h * a.dqs.h;
  const size_t srow = ((size_t)seq * a.H + h) * a.Nq;
  const long long gld = (long long)a.H * hd;  // the fp32 dao's row stride
  const float* gb = a.dao + (size_t)seq * a.Nq * gld + (size_t)h * hd;
  if constexpr (!QS) {
    stage_rows<LM_THREADS>(qsm, QLD, qb, a.qs.t, q0, QT, 0, a.Nq - 1, nullptr,
                           hdp, hd, vec);
    stage_rows<LM_THREADS>(gsm, QLD, dqb, a.dqs.t, q0, QT, 0, a.Nq - 1,
                           nullptr, hdp, hd, vec);
  }
  int klo, khi;
  lm_key_range(a, q0, nq, range, klo, khi);
  const int c_lo = klo / LM_KC;
  const int nch = khi >= klo ? khi / LM_KC - c_lo + 1 : 0;
  const int nhc = (hdp + LM_HC2 - 1) / LM_HC2, nsw = (hdp + CW - 1) / CW;
  const int ipc = nhc + LM_NQ, n = nsw * nch * ipc;
  // the stash of the thread's two queries
  float m_r[2], l_r[2], d_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + m0 + g + 8 * hr;
    const bool in = qi < a.Nq;
    m_r[hr] = in ? a.stats[2 * (srow + qi)] : -INFINITY;
    l_r[hr] = in ? a.stats[2 * (srow + qi) + 1] : 0.f;
    d_r[hr] = in ? a.dsum[srow + qi] : 0.f;
  }

  auto decode = [&](int i, int& ci, int& sw, int& x) {
    sw = i / (nch * ipc);
    const int j = i - sw * nch * ipc;
    ci = j / ipc, x = j - ci * ipc;
  };
  auto issue = [&](int i, int buf) {
    int ci, sw, x;
    decode(i, ci, sw, x);
    bf16* st = ring + buf * STAGE;
    const int k0 = (c_lo + ci) * LM_KC;
    if (x < nhc) {
      const int c0 = x * LM_HC2, w = lm_min(LM_HC2, hdp - c0);
      stage_rows<LM_THREADS>(st, KLD, kb + c0, a.ks.t, k0, LM_KC, klo, khi,
                             nullptr, w, hd - c0, vec);
      stage_rows<LM_THREADS>(st + LM_KC * KLD, KLD, vb + c0, a.vs.t, k0, LM_KC,
                             klo, khi, nullptr, w, hd - c0, vec);
      if constexpr (QS) {
        stage_rows<LM_THREADS>(st + 2 * LM_KC * KLD, KLD, qb + c0, a.qs.t, q0,
                               QT, 0, a.Nq - 1, nullptr, w, hd - c0, vec);
        stage_rows_rounded<LM_THREADS>(st + (2 * LM_KC + QT) * KLD, KLD,
                                       gb + c0, gld, q0, QT, a.Nq - 1, w,
                                       hd - c0);
      }
    } else {
      const int c0 = sw * CW;
      stage_rows<LM_THREADS>(st, VLD, kb + c0, a.ks.t, k0 + 16 * (x - nhc), 16,
                             klo, khi, nullptr, lm_min(CW, hdp - c0), hd - c0,
                             vec);
    }
  };

  float acc_s[MT][4], acc_p[MT][4], dq[LM_NT][4];
  auto use = [&](int i, int buf) {
    int ci, sw, x;
    decode(i, ci, sw, x);
    const bf16* st = ring + buf * STAGE;
    const int k0 = (c_lo + ci) * LM_KC;
    if (x < nhc) {
      if (x == 0) lm_zero(acc_s), lm_zero(acc_p);
      const int c0 = x * LM_HC2, ks = lm_min(LM_HC2, hdp - c0) / 16;
      if (rows && k0 + n0 <= khi && k0 + n0 + 8 * MT > klo) {
        // q's and dao's fragments: resident, or this item's (QS)
        const bf16* qa = QS ? st + (2 * LM_KC + m0) * KLD : qsm + m0 * QLD + c0;
        const bf16* ga =
            QS ? st + (2 * LM_KC + QT + m0) * KLD : gsm + m0 * QLD + c0;
        const int lda = QS ? KLD : QLD;
        lm_mma_abt<MT>(acc_s, qa, lda, st + n0 * KLD, KLD, ks, MT);
        lm_mma_abt<MT>(acc_p, ga, lda, st + (LM_KC + n0) * KLD, KLD, ks, MT);
      }
      if (x == nhc - 1) {
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int qi = q0 + m0 + g + 8 * hr, ki = k0 + n0 + 8 * j + 2 * t;
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s = lm_score(a, qi, ki + e, acc_s[j][2 * hr + e]);
              ds[e] = 0.f;  // a masked pair: exactly 0, whatever dp holds
              if (s != -INFINITY) {
                const float p = lm_prob(s, m_r[hr], l_r[hr]);
                const float dpr = acc_p[j][2 * hr + e];
                const float dp =
                    DROP ? __fmul_rn(dpr, la_keep<DROP>(a, seq, h, qi, ki + e))
                         : dpr;
                ds[e] = __fmul_rn(p, __fsub_rn(dp, d_r[hr]));
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(
                dssm + (m0 + g + 8 * hr) * LM_PLD + n0 + 8 * j + 2 * t) =
                __floats2bfloat162_rn(ds[0], ds[1]);
          }
      }
    } else {
      const int xq = x - nhc;
      if (ci == 0 && xq == 0) lm_zero(dq);
      const int nt = max(0, min(LM_NT, (hdp - sw * CW - oc0) / 8));
      if (rows && nt > 0)
        lm_mma_ab<LM_NT>(dq, dssm + m0 * LM_PLD + 16 * xq, LM_PLD, st + oc0,
                         VLD, 1, nt);
      if (ci == nch - 1 && xq == LM_NQ - 1) {
#pragma unroll
        for (int j = 0; j < LM_NT; ++j) {
          if (j >= nt) continue;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int qi = q0 + m0 + g + 8 * hr;
            const int col = sw * CW + oc0 + 8 * j + 2 * t;
            if (qi >= a.Nq) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col + e < hd)
                dqb[qi * a.dqs.t + col + e] =
                    __float2bfloat16(__fmul_rn(dq[j][2 * hr + e], a.scale));
          }
        }
      }
    }
  };
  ring_run<NST>(n, issue, use);
  if (nch == 0)  // no query of the tile sees a key: dQ is zeros
    for (int i = threadIdx.x; i < nq * hd; i += LM_THREADS) {
      const int r = i / hd, c = i - r * hd;
      dqb[(q0 + r) * a.dqs.t + c] = __float2bfloat16(0.f);
    }
}

// KS: k's and v's rows stream through the ring (past LA_RES_HD head
// columns), else they stay resident
template <bool KS>
static size_t lm_dkdv_smem(int hd) {
  const int hdp = lm_hdp(hd);
  const int stage = lm_max(2 * (LM_KC + (KS ? LM_KT : 0)) * (LM_HC2 + 8),
                           2 * 16 * lm_old(LM_KCW, hdp));
  return ((KS ? 0 : 2 * (size_t)LM_KT * (hdp + 8)) +
          LM_NST_KV * (size_t)stage + 2 * (size_t)LM_KT * LM_PLD) *
         sizeof(bf16);
}

// dK and dV: one block a (sequence, head, tile of 16 keys), its k and v rows
// in shared memory; the items stream through a ring of 2 stages over the
// chunks of 64 queries that see some key of the tile: a chunk's score items
// (LM_HC2 head columns of its q rows and dao rows: S = q . k^T and dP = dao
// . v^T on the forward's fragments in the forward's column order; warp w
// takes query strip w / 2, key tile w % 2), then its output items (16 of
// its dao and q rows over the sweep's columns; warp w takes the LM_NTK
// 8-column tiles from 8 LM_NTK w on). P (times keep, rounded) and dS
// (rounded) go transposed into shared tiles; dV += (P keep)^T . dao, dK +=
// dS^T . q, dK = scale * dK. KS (past LA_RES_HD head columns): each score
// item also stages the tile's k and v rows over its LM_HC2 columns, after
// the chunk's q and dao rows.
template <bool DROP, bool KS>
__global__ void __launch_bounds__(LM_THREADS, 2)
long_attention_mma_dkdv(LongAttn a, bool vec) {
  constexpr int NST = LM_NST_KV, KLD = LM_HC2 + 8, CW = LM_KCW;
  extern __shared__ __align__(16) unsigned char lm_smem[];
  __shared__ int range[2];
  const int hd = a.hd, hdp = lm_hdp(hd), RLD = hdp + 8;
  const int OLD = lm_old(CW, hdp);
  const int STAGE =
      lm_max(2 * (LM_KC + (KS ? LM_KT : 0)) * KLD, 2 * 16 * OLD);
  bf16* ksm = reinterpret_cast<bf16*>(lm_smem);  // [16][RLD] the tile's k
  bf16* vsm = ksm + LM_KT * RLD;                   // [16][RLD] its v
  bf16* ring = KS ? ksm : vsm + LM_KT * RLD;       // NST stages
  bf16* ptsm = ring + NST * STAGE;                 // [16 keys][LM_PLD] P^T
  bf16* dstsm = ptsm + LM_KT * LM_PLD;             // [16 keys][LM_PLD] dS^T
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int k0 = blockIdx.y * LM_KT, nk = min(LM_KT, a.Nk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qs0 = (warp >> 1) * 16, n0 = (warp & 1) * 8;
  const int oc0 = warp * 8 * LM_NTK;
  const bf16* qb = static_cast<const bf16*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + seq * a.vs.b + h * a.vs.h;
  const bf16* gb = static_cast<const bf16*>(a.dq) + seq * a.dqs.b +
                   h * a.dqs.h;  // dao, rounded, in dQ's place
  const size_t srow = ((size_t)seq * a.H + h) * a.Nq;
  if constexpr (!KS) {
    stage_rows<LM_THREADS>(ksm, RLD, kb, a.ks.t, k0, LM_KT, 0, a.Nk - 1,
                           nullptr, hdp, hd, vec);
    stage_rows<LM_THREADS>(vsm, RLD, vb, a.vs.t, k0, LM_KT, 0, a.Nk - 1,
                           nullptr, hdp, hd, vec);
  }
  int qlo, qhi;
  lm_query_range(a, k0, nk, range, qlo, qhi);
  const int c_lo = qlo / LM_KC;
  const int nch = qhi >= qlo ? qhi / LM_KC - c_lo + 1 : 0;
  const int nhc = (hdp + LM_HC2 - 1) / LM_HC2, nsw = (hdp + CW - 1) / CW;
  const int ipc = nhc + LM_NQ, n = nsw * nch * ipc;

  auto decode = [&](int i, int& ci, int& sw, int& x) {
    sw = i / (nch * ipc);
    const int j = i - sw * nch * ipc;
    ci = j / ipc, x = j - ci * ipc;
  };
  auto issue = [&](int i, int buf) {
    int ci, sw, x;
    decode(i, ci, sw, x);
    bf16* st = ring + buf * STAGE;
    const int r0 = (c_lo + ci) * LM_KC;  // the chunk's first query
    if (x < nhc) {
      const int c0 = x * LM_HC2, w = lm_min(LM_HC2, hdp - c0);
      stage_rows<LM_THREADS>(st, KLD, qb + c0, a.qs.t, r0, LM_KC, qlo, qhi,
                             nullptr, w, hd - c0, vec);
      stage_rows<LM_THREADS>(st + LM_KC * KLD, KLD, gb + c0, a.dqs.t, r0, LM_KC,
                             qlo, qhi, nullptr, w, hd - c0, vec);
      if constexpr (KS) {
        bf16* kv = st + 2 * LM_KC * KLD;
        stage_rows<LM_THREADS>(kv, KLD, kb + c0, a.ks.t, k0, LM_KT, 0,
                               a.Nk - 1, nullptr, w, hd - c0, vec);
        stage_rows<LM_THREADS>(kv + LM_KT * KLD, KLD, vb + c0, a.vs.t, k0,
                               LM_KT, 0, a.Nk - 1, nullptr, w, hd - c0, vec);
      }
    } else {
      const int c0 = sw * CW, w = lm_min(CW, hdp - c0);
      const int rq = r0 + 16 * (x - nhc);
      stage_rows<LM_THREADS>(st, OLD, gb + c0, a.dqs.t, rq, 16, qlo, qhi,
                             nullptr, w, hd - c0, vec);
      stage_rows<LM_THREADS>(st + 16 * OLD, OLD, qb + c0, a.qs.t, rq, 16, qlo,
                             qhi, nullptr, w, hd - c0, vec);
    }
  };

  float acc_s[1][4], acc_p[1][4], dk[LM_NTK][4], dv[LM_NTK][4];
  auto use = [&](int i, int buf) {
    int ci, sw, x;
    decode(i, ci, sw, x);
    const bf16* st = ring + buf * STAGE;
    const int r0 = (c_lo + ci) * LM_KC;
    if (x < nhc) {
      if (x == 0) lm_zero(acc_s), lm_zero(acc_p);
      const int c0 = x * LM_HC2, ks = lm_min(LM_HC2, hdp - c0) / 16;
      if (n0 < nk && r0 + qs0 <= qhi && r0 + qs0 + 16 > qlo) {
        // k's and v's fragments: resident, or this item's (KS)
        const bf16* kf = KS ? st + (2 * LM_KC + n0) * KLD : ksm + n0 * RLD + c0;
        const bf16* vf =
            KS ? st + (2 * LM_KC + LM_KT + n0) * KLD : vsm + n0 * RLD + c0;
        const int ldb = KS ? KLD : RLD;
        lm_mma_abt<1>(acc_s, st + qs0 * KLD, KLD, kf, ldb, ks, 1);
        lm_mma_abt<1>(acc_p, st + (LM_KC + qs0) * KLD, KLD, vf, ldb, ks, 1);
      }
      if (x == nhc - 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int qr = qs0 + g + 8 * hr, qi = r0 + qr;
          const bool in = qi < a.Nq;
          const float m = in ? a.stats[2 * (srow + qi)] : -INFINITY;
          const float l = in ? a.stats[2 * (srow + qi) + 1] : 0.f;
          const float d = in ? a.dsum[srow + qi] : 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kr = n0 + 2 * t + e, ki = k0 + kr;
            const float s = lm_score(a, qi, ki, acc_s[0][2 * hr + e]);
            float pk = 0.f, ds = 0.f;  // a masked pair: exactly 0
            if (s != -INFINITY) {
              const float p = lm_prob(s, m, l);
              const float keep = la_keep<DROP>(a, seq, h, qi, ki);
              const float dpr = acc_p[0][2 * hr + e];
              pk = DROP ? __fmul_rn(p, keep) : p;
              ds = __fmul_rn(p, __fsub_rn(DROP ? __fmul_rn(dpr, keep) : dpr,
                                          d));
            }
            ptsm[kr * LM_PLD + qr] = __float2bfloat16(pk);
            dstsm[kr * LM_PLD + qr] = __float2bfloat16(ds);
          }
        }
      }
    } else {
      const int xq = x - nhc;
      if (ci == 0 && xq == 0) lm_zero(dk), lm_zero(dv);
      const int nt = max(0, min(LM_NTK, (hdp - sw * CW - oc0) / 8));
      if (nt > 0) {
        lm_mma_ab<LM_NTK>(dv, ptsm + 16 * xq, LM_PLD, st + oc0, OLD, 1, nt);
        lm_mma_ab<LM_NTK>(dk, dstsm + 16 * xq, LM_PLD, st + 16 * OLD + oc0,
                          OLD, 1, nt);
      }
      if (ci == nch - 1 && xq == LM_NQ - 1) {
#pragma unroll
        for (int j = 0; j < LM_NTK; ++j) {
          if (j >= nt) continue;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int ki = k0 + g + 8 * hr;
            const int col = sw * CW + oc0 + 8 * j + 2 * t;
            if (ki >= a.Nk) continue;
            bf16* dkr = static_cast<bf16*>(a.dk) + seq * a.dks.b +
                        ki * a.dks.t + h * a.dks.h + col;
            bf16* dvr = static_cast<bf16*>(a.dv) + seq * a.dvs.b +
                        ki * a.dvs.t + h * a.dvs.h + col;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col + e < hd) {
                dkr[e] = __float2bfloat16(__fmul_rn(dk[j][2 * hr + e],
                                                    a.scale));
                dvr[e] = __float2bfloat16(dv[j][2 * hr + e]);
              }
          }
        }
      }
    }
  };
  ring_run<NST>(n, issue, use);
  if (nch == 0)  // no query sees a key of the tile: dK and dV are zeros
    for (int i = threadIdx.x; i < nk * hd; i += LM_THREADS) {
      const int r = i / hd, c = i - r * hd, ki = k0 + r;
      static_cast<bf16*>(a.dk)[seq * a.dks.b + ki * a.dks.t + h * a.dks.h +
                               c] = __float2bfloat16(0.f);
      static_cast<bf16*>(a.dv)[seq * a.dvs.b + ki * a.dvs.t + h * a.dvs.h +
                               c] = __float2bfloat16(0.f);
    }
}

template <int MT, bool DROP, bool QS>
static cudaError_t lm_launch_dq(const LongAttn& a, bool vec,
                                cudaStream_t stream) {
  const size_t smem = lm_dq_smem<MT, QS>(a.hd);
  const cudaError_t err = cudaFuncSetAttribute(
      long_attention_mma_dq<MT, DROP, QS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_seq * a.H, cdiv(a.Nq, LmTile<MT>::QT));
  long_attention_mma_dq<MT, DROP, QS><<<grid, LM_THREADS, smem, stream>>>(
      a, vec);
  return cudaGetLastError();
}

template <bool DROP, bool KS>
static cudaError_t lm_launch_dkdv(const LongAttn& a, bool vec,
                                  cudaStream_t stream) {
  const size_t smem = lm_dkdv_smem<KS>(a.hd);
  const cudaError_t err = cudaFuncSetAttribute(
      long_attention_mma_dkdv<DROP, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_seq * a.H, cdiv(a.Nk, LM_KT));
  long_attention_mma_dkdv<DROP, KS><<<grid, LM_THREADS, smem, stream>>>(a,
                                                                        vec);
  return cudaGetLastError();
}

// The backward: (1) the forward's own instance again (O bit for bit, the
// stash, D, dao rounded into dQ's place), (2) dK / dV over key tiles, (3) dQ
// over query tiles (16 queries up to 16 or past 256 head columns, else
// 32), which overwrites the copy of dao. Past LA_RES_HD head columns each
// kernel streams the operand rows it otherwise keeps (QS / KS).
template <bool DROP>
static cudaError_t launch_long_mma_bwd(const LongAttn& a,
                                       cudaStream_t stream) {
  const bool vec = lm_rows_aligned(a, true);
  cudaError_t err = launch_long_mma<DROP>(a, vec, stream);
  if (err != cudaSuccess) return err;
  if (a.hd > LA_RES_HD) {
    err = lm_launch_dkdv<DROP, true>(a, vec, stream);
    if (err != cudaSuccess) return err;
    return lm_launch_dq<1, DROP, true>(a, vec, stream);
  }
  err = lm_launch_dkdv<DROP, false>(a, vec, stream);
  if (err != cudaSuccess) return err;
  return a.Nq <= 16 || lm_hdp(a.hd) > 256
             ? lm_launch_dq<1, DROP, false>(a, vec, stream)
             : lm_launch_dq<2, DROP, false>(a, vec, stream);
}

// ---------------------------------------------------------------------------
// the entries' launches: the route by dtype and cast chain
// ---------------------------------------------------------------------------

template <typename T, bool ROUND, bool DROP>
cudaError_t launch_long_attention(const LongAttn& a, cudaStream_t stream) {
  if (a.Nq < 1 || a.Nk < 1 || a.hd < 1 ||
      (a.Nq + LA_TILE - 1) / LA_TILE > 65535)
    return cudaErrorInvalidValue;
  if (a.n_seq * a.H == 0) return cudaSuccess;
  if constexpr (std::is_same<T, bf16>::value && ROUND)
    return launch_long_mma<DROP>(a, lm_rows_aligned(a, false), stream);
  else
    return launch_long_f32rows<T, ROUND, DROP>(a, stream);
}

// The backward of launch_long_attention<T, ROUND, DROP> on the same fields:
// a.out receives O again (bit for bit), a.stats and a.dsum are scratch (the
// caller's, n_seq * H * Nq x 2 and x 1 fp32), a.dao the fp32 gradient of
// O, a.dq / a.dk / a.dv the gradients (in T, their strides).
template <typename T, bool ROUND, bool DROP>
cudaError_t launch_long_attention_bwd(const LongAttn& a,
                                      cudaStream_t stream) {
  if (a.stats == nullptr || a.dao == nullptr || a.dsum == nullptr ||
      a.Nq < 1 || a.Nk < 1 || a.hd < 1 ||
      (a.Nq + LA_TILE - 1) / LA_TILE > 65535 ||
      (a.Nk + LA_TILE - 1) / LA_TILE > 65535)
    return cudaErrorInvalidValue;
  if (a.n_seq * a.H == 0) return cudaSuccess;
  if constexpr (std::is_same<T, bf16>::value && ROUND)
    return launch_long_mma_bwd<DROP>(a, stream);
  else
    return launch_long_f32rows_bwd<T, ROUND, DROP>(a, stream);
}

// Every form the entries launch: the sequence attention (ROUND, rows 4-6)
// and the GPT-2 serving half (ROUND, row 2), the fuser serving block (row
// 1), the training layers' forward (DROP, rows 7 and 11) and backward.
#define AFFT_LONG_FWD(T, ROUND, DROP)                                   \
  template cudaError_t launch_long_attention<T, ROUND, DROP>(          \
      const LongAttn&, cudaStream_t);
#define AFFT_LONG_BWD(T, ROUND, DROP)                                   \
  template cudaError_t launch_long_attention_bwd<T, ROUND, DROP>(      \
      const LongAttn&, cudaStream_t);
#define AFFT_LONG_FORMS(T)   \
  AFFT_LONG_FWD(T, true, false) \
  AFFT_LONG_FWD(T, false, false) \
  AFFT_LONG_FWD(T, true, true)  \
  AFFT_LONG_FWD(T, false, true) \
  AFFT_LONG_BWD(T, true, true)  \
  AFFT_LONG_BWD(T, false, true)
AFFT_LONG_FORMS(float)
AFFT_LONG_FORMS(bf16)

}  // namespace afft
