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
// Forward (long_attention), one block a (sequence, head, tile of 16
// queries), 256 threads, thread (r, c) = (tid / 16, tid % 16):
//   1. the tile's q rows are staged once (fp32, all head columns); the key
//      tiles of 16 stream through shared memory and each thread takes the
//      score of query r and key c; each query keeps a running max and sum
//      of its exponentials (the online softmax), its 16 lanes reducing a
//      tile by a butterfly;
//   2. a second sweep over the key tiles forms each probability exactly as
//      the plain version does, p = exp(s - max) / sum (times the dropout
//      multiplier, rounded to T under ROUND), so p enters P . V as the
//      plain version forms it and needs no rescaling of O; thread (r, c)
//      keeps O's columns c, c + 16, ... (up to 512 columns a sweep; wider
//      heads take more sweeps) in registers, a sequential fp32 sum over the
//      keys in order.
// Shared memory is 3 x 16 rows of the head width (fp32) and a 16 x 16
// probability tile, whatever the length. Every score is a sequential fp32
// FMA chain over the head columns in order, and every other step is
// written with explicit rounding (fmaf, __fmul_rn, __fadd_rn, __fdiv_rn),
// so any kernel here that recomputes a score or a probability gets the
// same bits.
//
// Training mode (DROP): the dropout multiplier of (query tq, key tk) is
// drop_scale(drop, ((seq * H + h) * Nq + tq) * Nk + tk), a 64-bit logical
// index, so a tensor-parallel shard's span / gap remap (common.cuh) holds.
// ROUND selects the cast chain: the probabilities (times their multipliers)
// rounded to T before P . V (the GPT-2 layer, and the sequence attention of
// rows 4-6), or kept fp32 (the fuser).
//
// Backward (launch_long_attention_bwd), three launches on the stream:
//   1. the forward kernel again on the same operands and masks: O bit for
//      bit the forward's (the same instance recomputes it in the forward's
//      order; O is dWproj's operand), the stash of each query's row max and
//      sum (fp32, per (sequence, head)) and D = rowsum(dao . O) over O's
//      fp32 sums (dao rounded to T under ROUND);
//   2. long_attention_dkdv: a block a tile of 16 keys, looping over every
//      query tile: P rebuilt from the stash, dp = (dao . v) * keep, ds =
//      p (dp - D) (rounded under ROUND), dK = scale ds^T . q and dV = (p *
//      keep)^T . dao summed in registers over the queries in order;
//   3. long_attention_dq: a block a tile of 16 queries, looping over every
//      key tile: dQ = scale ds . k.
// No atomics: every gradient is the same bit for bit from run to run.
// With ROUND, D sums (p * keep) rounded (the O of P . V) where the plain
// version sums p * keep unrounded: a difference of bf16 rounding in ds.
//
// A key whose mask entry is -inf scores -inf (its dot is not computed) and
// contributes nothing: a zero coefficient is skipped in every product, so
// what lies in a masked row (NaN in an unwritten cache slot) never reaches
// a result; a query whose keys are all masked gives zeros.
//
// Bound on an H100: at long lengths by operations (4 . B . H . Nq . Nk . hd
// FLOPs forward; at T 1,024, C 2,048, 4 heads, B 4: 34 GFLOP, 0.035 ms at
// 989 TFLOP/s). This first version runs its products on the CUDA cores in
// fp32, from shared memory, and computes the scores twice in the forward
// (and five times in the backward); the tensor cores (mma.sync / wgmma) are
// later work (ROADMAP §B.2). PERF.md has its times.
//
// Limits: any lengths (Nq, Nk >= 1; the grid's y takes cdiv(Nq, 16) <=
// 65,535), 1 <= hd <= LA_MAX_HD (the backward's shared memory), fp32 or
// bf16, any strides with unit stride along hd.

#include "long_attention.cuh"

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

// The score of query row qr (of qsm) and key row kr (of ksm), mask entry mk
__device__ __forceinline__ float la_score(const float* qrow,
                                          const float* krow, int hd,
                                          float mk, float scale) {
  if (mk == -INFINITY) return -INFINITY;
  return __fadd_rn(__fmul_rn(la_dot(qrow, krow, hd), scale), mk);
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

static size_t la_lds(int hd) { return (size_t)hd + 1; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, bool ROUND, bool DROP>
__global__ void __launch_bounds__(LA_THREADS)
long_attention(LongAttn a) {
  extern __shared__ __align__(16) float la_smem[];
  const int hd = a.hd, lds = hd + 1;
  float* qsm = la_smem;             // [16][lds] the tile's queries
  float* ksm = qsm + LA_TILE * lds;  // [16][lds] a key tile
  float* vsm = ksm + LA_TILE * lds;  // [16][lds] its values
  float* psm = vsm + LA_TILE * lds;  // [16][LA_PLD] coefficients
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = blockIdx.y * LA_TILE;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15, qi = q0 + r;
  const T* qb = static_cast<const T*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + seq * a.vs.b + h * a.vs.h;
  la_stage<T, false>(qsm, lds, qb, a.qs.t, q0, a.Nq, hd);

  // 1. each query's running max m and sum l over the key tiles
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < a.Nk; k0 += LA_TILE) {
    __syncthreads();  // q is staged; the previous tile is read
    la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
    __syncthreads();
    const float s = la_score(qsm + r * lds, ksm + c * lds, hd,
                             la_mask(a, qi, k0 + c), a.scale);
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
      __syncthreads();  // the previous tile is read
      la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
      la_stage<T, false>(vsm, lds, vb, a.vs.t, k0, a.Nk, hd);
      __syncthreads();
      const int ki = k0 + c;
      const float s = la_score(qsm + r * lds, ksm + c * lds, hd,
                               la_mask(a, qi, ki), a.scale);
      psm[r * LA_PLD + c] = la_coef<T, ROUND, DROP>(
          la_prob(s, m, l), la_keep<DROP>(a, seq, h, qi, ki));
      __syncthreads();
      for (int kk = 0; kk < LA_TILE; ++kk) {
        const float w = psm[r * LA_PLD + kk];
        if (w == 0.f) continue;  // a masked key, or one past Nk
        const float* vr = vsm + kk * lds + cb + c;
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

template <typename T, bool ROUND, bool DROP>
cudaError_t launch_long_attention(const LongAttn& a, cudaStream_t stream) {
  if (a.Nq < 1 || a.Nk < 1 || a.hd < 1 || a.hd > LA_MAX_HD ||
      (a.Nq + LA_TILE - 1) / LA_TILE > 65535)
    return cudaErrorInvalidValue;
  if (a.n_seq * a.H == 0) return cudaSuccess;
  const size_t smem =
      (3 * LA_TILE * la_lds(a.hd) + LA_TILE * LA_PLD) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      long_attention<T, ROUND, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_seq * a.H, (a.Nq + LA_TILE - 1) / LA_TILE);
  long_attention<T, ROUND, DROP><<<grid, LA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The pair (query qi = row r of qsm / gsm, key ki = row c of ksm / vsm):
// its coefficient of P . V (pk) and ds, from the stash (m, l) and D of the
// query. Zeros for a masked pair or one past the extent.
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
  const size_t row = ((size_t)seq * a.H + h) * a.Nq + qi;
  const float m = a.stats[2 * row], l = a.stats[2 * row + 1];
  const float s = la_score(qrow, krow, a.hd, mk, a.scale);
  const float p = la_prob(s, m, l);
  const float keep = la_keep<DROP>(a, seq, h, qi, ki);
  pk = la_coef<T, ROUND, DROP>(p, keep);
  const float dpr = la_dot(grow, vrow, a.hd);
  const float dp = DROP ? __fmul_rn(dpr, keep) : dpr;
  ds = __fmul_rn(p, __fsub_rn(dp, a.dsum[row]));
  if (ROUND) ds = to_f32(from_f32<T>(ds));
}

// One block a tile of 16 keys: dK and dV over every query tile.
template <typename T, bool ROUND, bool DROP>
__global__ void __launch_bounds__(LA_THREADS)
long_attention_dkdv(LongAttn a) {
  extern __shared__ __align__(16) float la_smem[];
  const int hd = a.hd, lds = hd + 1;
  float* ksm = la_smem;              // [16][lds] this block's keys
  float* vsm = ksm + LA_TILE * lds;  // [16][lds] their values
  float* qsm = vsm + LA_TILE * lds;  // [16][lds] a query tile
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
  la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
  la_stage<T, false>(vsm, lds, vb, a.vs.t, k0, a.Nk, hd);
  const int kr = k0 + r;  // the key whose gradients this thread sums
  for (int cb = 0; cb < hd; cb += LA_COLS) {
    float dk[LA_PER], dv[LA_PER];
#pragma unroll
    for (int i = 0; i < LA_PER; ++i) dk[i] = 0.f, dv[i] = 0.f;
    for (int q0 = 0; q0 < a.Nq; q0 += LA_TILE) {
      __syncthreads();  // k, v are staged; the previous tile is read
      la_stage<T, false>(qsm, lds, qb, a.qs.t, q0, a.Nq, hd);
      la_stage<T, ROUND>(gsm, lds, gb, gld, q0, a.Nq, hd);
      __syncthreads();
      float pk, ds;
      la_pair_grad<T, ROUND, DROP>(a, seq, h, q0 + r, k0 + c, qsm + r * lds,
                                   gsm + r * lds, ksm + c * lds,
                                   vsm + c * lds, pk, ds);
      psm[r * LA_PLD + c] = pk;
      dsm[r * LA_PLD + c] = ds;
      __syncthreads();
      // thread (key r, columns c + 16 i): sums over the tile's queries
      for (int qq = 0; qq < LA_TILE; ++qq) {
        const float wd = dsm[qq * LA_PLD + r], wp = psm[qq * LA_PLD + r];
        const float* qr = qsm + qq * lds + cb + c;
        const float* gr = gsm + qq * lds + cb + c;
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

// One block a tile of 16 queries: dQ over every key tile.
template <typename T, bool ROUND, bool DROP>
__global__ void __launch_bounds__(LA_THREADS)
long_attention_dq(LongAttn a) {
  extern __shared__ __align__(16) float la_smem[];
  const int hd = a.hd, lds = hd + 1;
  float* qsm = la_smem;              // [16][lds] this block's queries
  float* gsm = qsm + LA_TILE * lds;  // [16][lds] their dao rows
  float* ksm = gsm + LA_TILE * lds;  // [16][lds] a key tile
  float* vsm = ksm + LA_TILE * lds;  // [16][lds] its values
  float* dsm = vsm + LA_TILE * lds;  // [16][LA_PLD] ds
  const int seq = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = blockIdx.y * LA_TILE;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15, qi = q0 + r;
  const T* qb = static_cast<const T*>(a.q) + seq * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + seq * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + seq * a.vs.b + h * a.vs.h;
  const long long gld = (long long)a.H * hd;
  const float* gb = a.dao + (size_t)seq * a.Nq * gld + (size_t)h * hd;
  la_stage<T, false>(qsm, lds, qb, a.qs.t, q0, a.Nq, hd);
  la_stage<T, ROUND>(gsm, lds, gb, gld, q0, a.Nq, hd);
  for (int cb = 0; cb < hd; cb += LA_COLS) {
    float dq[LA_PER];
#pragma unroll
    for (int i = 0; i < LA_PER; ++i) dq[i] = 0.f;
    for (int k0 = 0; k0 < a.Nk; k0 += LA_TILE) {
      __syncthreads();  // q, dao are staged; the previous tile is read
      la_stage<T, false>(ksm, lds, kb, a.ks.t, k0, a.Nk, hd);
      la_stage<T, false>(vsm, lds, vb, a.vs.t, k0, a.Nk, hd);
      __syncthreads();
      float pk, ds;
      la_pair_grad<T, ROUND, DROP>(a, seq, h, qi, k0 + c, qsm + r * lds,
                                   gsm + r * lds, ksm + c * lds,
                                   vsm + c * lds, pk, ds);
      dsm[r * LA_PLD + c] = ds;
      __syncthreads();
      // thread (query r, columns c + 16 i): sums over the tile's keys
      for (int kk = 0; kk < LA_TILE; ++kk) {
        const float w = dsm[r * LA_PLD + kk];
        if (w == 0.f) continue;
        const float* kr = ksm + kk * lds + cb + c;
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

// The backward of launch_long_attention<T, ROUND, DROP> on the same fields:
// a.out receives O again (bit for bit), a.stats and a.dsum are scratch (the
// caller's, n_seq * H * Nq x 2 and x 1 fp32), a.dao the fp32 gradient of
// O, a.dq / a.dk / a.dv the gradients (in T, their strides).
template <typename T, bool ROUND, bool DROP>
cudaError_t launch_long_attention_bwd(const LongAttn& a,
                                      cudaStream_t stream) {
  if (a.stats == nullptr || a.dao == nullptr || a.dsum == nullptr ||
      (a.Nk + LA_TILE - 1) / LA_TILE > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_long_attention<T, ROUND, DROP>(a, stream);
  if (err != cudaSuccess || a.n_seq * a.H == 0) return err;
  const size_t rows = 4 * LA_TILE * la_lds(a.hd) * sizeof(float);
  const size_t smem_kv = rows + 2 * LA_TILE * LA_PLD * sizeof(float);
  const size_t smem_q = rows + LA_TILE * LA_PLD * sizeof(float);
  err = cudaFuncSetAttribute(long_attention_dkdv<T, ROUND, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(long_attention_dq<T, ROUND, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  const dim3 gk(a.n_seq * a.H, (a.Nk + LA_TILE - 1) / LA_TILE);
  long_attention_dkdv<T, ROUND, DROP><<<gk, LA_THREADS, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq(a.n_seq * a.H, (a.Nq + LA_TILE - 1) / LA_TILE);
  long_attention_dq<T, ROUND, DROP><<<gq, LA_THREADS, smem_q, stream>>>(a);
  return cudaGetLastError();
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
