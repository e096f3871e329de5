// The pre-LN transformer block in training mode, shared by two entry files:
// fused_block_train.cu (the fuser block) and fused_gpt2_train.cu (the GPT-2
// layer of the future predictor). Each entry is a sequence of launches on
// one stream with the intermediates in HBM / L2:
//   forward       LN1 -> qkv GEMM (stashed) -> attention over N tokens
//                 with dropout on the probabilities -> proj GEMM (dropout,
//                 drop-path, + x: the residual stream y and its stash) -> LN2
//                 -> fc1 GEMM (stashes pre1, GELU) -> fc2 GEMM (dropout,
//                 drop-path, + y);
//   backward, MLP dh2 = dout * masks -> LN2 and GELU recomputed from the
//                 stashes -> dW2, db2 -> dpre1 = (dh2 . W2^T) * gelu'(pre1) ->
//                 dW1, db1 -> dg = dpre1 . W1^T -> LayerNorm backward (dy)
//                 and its affine gradients;
//   backward, attention  dproj = dy * masks -> dattn = dproj . Wproj^T ->
//                 attention backward from the stashed qkv (dqkv, and the
//                 forward's attention output O recomputed on the way) ->
//                 dWproj from O, dbproj -> LN1 recomputed -> dWqkv, dbqkv ->
//                 dxn = dqkv . Wqkv^T -> LayerNorm backward (dx) and its
//                 affine gradients.
// qkv, y and pre1 are stashed in the working dtype; the backward takes its
// LayerNorm statistics from the stashed x / y; dh2, dpre1, dproj and dqkv are
// rounded to the working dtype before their GEMMs; every product inside the
// block is the port's GEMM; every parameter gradient is fp32. In bf16 every
// product runs on the wgmma / TMA GEMM (gemm_sm90.cuh): a weight read as
// (K, N) (the GPT-2 layer's forward, the fuser's backward dX), as (N, K) on
// its K-major B route gemm_nk (the fuser's forward, the GPT-2 layer's
// backward dX), and every weight gradient on its TN route (split over M,
// into the wrapper's scratch, where its output tiles leave most SMs idle:
// the attention backward's). The forward attention is staged through shared
// memory: staged_attention.cuh for the GPT-2 layer, fuser_attention.cuh's
// rows kernel with dropout for the fuser; the attention backward of both is
// attention_bwd.cuh, which recomputes the forward's output O bit for bit
// for dWproj. Past 8 tokens (the fuser) or 32 (GPT-2) the attention and its
// backward take the long route (long_attention.cuh), whose backward
// recomputes its own forward's O bit for bit. In fp32 every product is
// gemm_f32 / gemm_tn_f32.
//
// The two layers (template flag GPT2) differ in four places:
//   weights     fuser: nn.Linear (out, in), read as the (N, K) operand
//               forward and (K, N) backward; GPT-2: HF Conv1D (in, out), the
//               other way round. The weight gradients come out in each
//               weight's own layout (dY^T . X, or X^T . dY);
//   GELU        fuser: exact (erf); GPT-2: gelu_new (tanh);
//   y           fuser: fp32 between the halves (pallas_block_train.py:
//               200-239); GPT-2: rounded to the working dtype, and the MLP
//               half adds its branch to the rounded y (pallas_gpt2_train.py:
//               127, :141);
//   attention   fuser: p * keep in fp32 before P . V, and the backward in
//               fp32; GPT-2: p * keep rounded before P . V, the backward's
//               d(attention output), p * keep and ds rounded
//               (pallas_gpt2_train.py:118, :283, :284, :288); each layer's
//               forward softmax (attention_bwd.cuh ROUND).
//
// Masks: each is a pure function of (two seed words, block index, site,
// logical element index), drawn in registers where it is used (common.cuh
// drop_scale), so the forward and both backward halves see the same mask and
// none is ever stored. Element indices: attention ((r * H + h) * N + tq) * N
// + tk; proj and MLP (r * N + t) * C + c; drop-path r. The GPT-2 layer draws
// at the sites 0, 1 and 3 of the fuser's five (pallas_gpt2_train.py:45) and
// has no drop-path (its rate is 0: nothing drawn).
//
// Weight gradients reduce over all rows inside one block per output tile, in
// a fixed order (or over fixed slices of the rows, whose partial tiles are
// then summed in slice order), and the bias and LayerNorm-affine gradients
// are two-stage column sums: no atomics, so every gradient is the same from
// run to run.
//
// Tensor-parallel shard mode (Shard, count > 1; Megatron's column- and
// row-parallel products): this call holds rank ``rank``'s shard of a layer
// split over ``count`` model ranks: hidden / count MLP columns (fc1's
// outputs, fc2's inputs) and, with ``heads``, H of the layer's count * H
// heads (qkv's columns [q | k | v] of those heads, proj's input rows), the
// attention width A = C / count. LayerNorms, biases of the row-parallel
// products and the residual stream stay whole (C). It relies on linearity
// and so never splits an entry at a LayerNorm: the row-parallel product's
// output goes through its dropout masks as a partial sum, and the LayerNorm
// backward turns a partial dx-hat into a partial dx (and partial affine
// gradients). So each entry runs whole on its shard and writes an fp32
// partial sum where it would write its last output (the forward's out, or
// the GPT-2 attention half's y; the backward's dy, and the GPT-2 attention
// backward's dx); only rank 0 adds the row-parallel bias and the residual
// (or the pass-through gradient). The caller sums the partials over the
// model ranks (one all-reduce an entry) and rounds once, which gives the
// one-rank result up to the order of the sum. The GPT-2 forward then runs
// its two halves as two calls (``part``), the sum of y in between; the
// fuser's attention stays whole (no ``heads``): its forward sums once at the
// end, its attention backward runs unsharded on the summed dy. Masks are the
// whole layer's: the proj and MLP sites index the whole C, and the attention
// site maps a local head to the global one (DropSite span / gap).
//
// Limits: any R, N >= 1 (past short_tokens the long route, any hd, whose
// attention backward needs its stats / dsum scratch), H * hd = C (any hd),
// any hidden and any local width of a shard, fp32 or bf16; in bf16, where a
// product's operand rows are off TMA's 16-byte grid (C, A or hidden not a
// multiple of 8), the pack arena the wrapper sets (gemm_sm90.cuh
// PackArena; the GEMM returns cudaErrorInvalidValue where it is short);
// norm affines and the qkv bias optional (null pointers, and then no
// gradient is written for them).

#pragma once

#include "attention_bwd.cuh"
#include "common.cuh"
#include "fuser_attention.cuh"
#include "gemm_sm90.cuh"
#include "long_attention.cuh"
#include "staged_attention.cuh"

namespace afft {

enum Site { SITE_ATTN = 0, SITE_PROJ, SITE_DP1, SITE_MLP, SITE_DP2 };

// Parameter slots and their gradients, in one order for both layers.
enum TrainParam {
  TP_LN1G, TP_LN1B, TP_WQKV, TP_BQKV, TP_WPROJ, TP_BPROJ, TP_LN2G, TP_LN2B,
  TP_WFC1, TP_BFC1, TP_WFC2, TP_BFC2
};

// seeds[0..1] the step's seed words, seeds[2] the block index, seeds[3] the
// first row (r0) of the global batch that this call holds; thr / inv: 0
// attention probabilities, 1 proj and MLP dropout, 2 drop-path. ``per_row``:
// each site's elements in one row (N tokens of C channels, H heads).
struct Rates {
  unsigned seed0, seed1, block;
  unsigned long long row0;
  unsigned long long per_row[5];
  // the attention site's head remap of a shard (DropSite span / gap) and
  // its first head's offset
  unsigned long long head_span, head_gap, head_shift;
  unsigned thr[3];
  float inv[3];
};

// A call's tensor-parallel shard (see above): rank ``rank`` of ``count``
// (1: the whole layer); ``part`` of the forward: PART_BOTH, or the GPT-2
// layer's PART_ATTN / PART_MLP alone; ``heads``: the attention's heads are
// split too (the GPT-2 layer's).
enum Part { PART_BOTH = 0, PART_ATTN = 1, PART_MLP = 2 };

struct Shard {
  int rank, count, part, heads;
  bool on() const { return count > 1; }
  bool lead() const { return rank == 0; }
  // the attention width of this shard, of the layer's C
  int width(int C) const { return on() && heads ? C / count : C; }
};

// ``s``: {rank, count, part, heads} (a host array), or null: the whole layer.
static Shard shard_of(const int* s) {
  return s != nullptr ? Shard{s[0], s[1], s[2], s[3]} : Shard{0, 1, 0, 0};
}

// Whether a shard of a layer of width C with H local heads and ``hidden``
// MLP columns is one the entries take.
static bool shard_ok(const Shard& sh, bool gpt2, int C, int H) {
  if (!sh.on()) return sh.part == PART_BOTH;
  if (sh.rank < 0 || sh.rank >= sh.count) return false;
  if (gpt2) return sh.heads && sh.part != PART_BOTH && C % sh.count == 0 &&
                   (C / sh.count) % H == 0;
  return !sh.heads && sh.part == PART_BOTH;
}

static DropSite site_of(const Rates& r, int site) {
  const int kind = site == SITE_ATTN ? 0
                   : (site == SITE_PROJ || site == SITE_MLP) ? 1 : 2;
  DropSite d{r.seed0, r.seed1, r.block, (unsigned)site, r.thr[kind],
             r.inv[kind], r.row0 * r.per_row[site], 0, 0};
  if (site == SITE_ATTN) {
    d.base += r.head_shift;
    d.span = r.head_span;
    d.gap = r.head_gap;
  }
  return d;
}

// H may be 0 where the attention site is not drawn (its offset is then 0);
// under a shard with ``heads`` H is the local heads, count * H the layer's.
static Rates rates_of(const int* seeds, const int* thr, const float* inv,
                      int N, int C, int H, Shard sh = Shard{0, 1, 0, 0}) {
  Rates r;
  r.seed0 = (unsigned)seeds[0];
  r.seed1 = (unsigned)seeds[1];
  r.block = (unsigned)seeds[2];
  r.row0 = (unsigned long long)(unsigned)seeds[3];
  const unsigned long long tokens = (unsigned long long)N * C;
  const unsigned long long nn = (unsigned long long)N * N;
  const bool split = sh.on() && sh.heads;
  const unsigned long long hg = (unsigned long long)H * (split ? sh.count : 1);
  r.per_row[SITE_ATTN] = hg * nn;
  r.head_span = split ? (unsigned long long)H * nn : 0;
  r.head_gap = split ? (hg - H) * nn : 0;
  r.head_shift = split ? (unsigned long long)sh.rank * H * nn : 0;
  r.per_row[SITE_PROJ] = tokens;
  r.per_row[SITE_DP1] = 1;
  r.per_row[SITE_MLP] = tokens;
  r.per_row[SITE_DP2] = 1;
  for (int i = 0; i < 3; ++i) {
    r.thr[i] = (unsigned)thr[i];
    r.inv[i] = inv[i];
  }
  return r;
}

// ---------------------------------------------------------------------------
// Elementwise passes
// ---------------------------------------------------------------------------

// The drop passes below (drop_grad, and the mask kernel of rows 10 and 16)
// are bound by the draw's integer work, not by their bytes: one Philox4x32-10
// draw an element (common.cuh philox_word0, ~40 SASS instructions on the
// FMA-heavy pipe and the ALU; tools/philox_bound.py counts them) against
// 4 to 8 bytes moved. So each thread takes several consecutive elements a
// turn (independent chains that interleave and share their first two
// rounds' element-free products), moves them with 16-byte accesses, and
// indexes them with 32-bit offsets from a 64-bit tile start (a tile whose
// logical indices cross a 2^32 boundary, a ragged tail or an unaligned
// buffer takes drop_scale's 64-bit route element by element). Both loop over
// their tiles with a resident grid, so a thread's round keys and the
// block word's product are computed once.

constexpr int DG_THREADS = 128;
constexpr unsigned DG_TILE = 1024;  // elements a block's turn

// VEC elements of T as one 16-byte (or narrower) access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// store a Pack as one access (the compiler splits a 16-byte struct of bf16
// into 2-byte stores otherwise)
template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& x) {
  if constexpr (sizeof(T) * VEC == 16) {
    const unsigned* w = reinterpret_cast<const unsigned*>(x.v);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<Pack<T, VEC>*>(p) = x;
  }
}

// out = (d * row_drop[row]) * drop[e], rounded to T: the gradient entering a
// branch's last GEMM, over ``rows`` drop-path rows of ``rowlen`` (tokens * C)
// elements. The drop-path multiplier is drawn once a row by each block
// that walks it (one where the rows fill the grid), the
// element's mask in VEC-element vectors (VEC = 16 / sizeof(T) where C and
// both buffers allow it, else 1): DG_TILE / (DG_THREADS * VEC) vectors a
// thread a turn.
template <typename T, int VEC>
__global__ void __launch_bounds__(DG_THREADS)
    drop_grad(const T* __restrict__ d, T* __restrict__ out,
              unsigned long long rows, unsigned rowlen, DropSite drop,
              DropSite row_drop) {
  constexpr int U = DG_TILE / (DG_THREADS * VEC);
  static_assert(U * DG_THREADS * VEC == (int)DG_TILE, "tile");
  const unsigned chunks = (rowlen + DG_TILE - 1) / DG_TILE;
  for (unsigned long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float rm = drop_scale(row_drop, row);
    const unsigned long long r0 = row * rowlen;
    for (unsigned c = blockIdx.y; c < chunks; c += gridDim.y) {
      const unsigned c0 = c * DG_TILE;
      if (c0 + DG_TILE <= rowlen && drop.span == 0 &&
          drop_one_word(drop, r0 + c0, DG_TILE)) {
        const unsigned long long first = drop.base + r0 + c0;
        const unsigned lo = (unsigned)first, hi = (unsigned)(first >> 32);
        const T* src = d + r0 + c0;
        T* dst = out + r0 + c0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned off = (u * DG_THREADS + threadIdx.x) * VEC;
          const Pack<T, VEC> x =
              *reinterpret_cast<const Pack<T, VEC>*>(src + off);
          float m[VEC];
          drop_scales<VEC>(drop, lo + off, hi, m);
          Pack<T, VEC> y;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            y.v[j] = from_f32<T>((to_f32(x.v[j]) * rm) * m[j]);
          store_pack<T, VEC>(dst + off, y);
        }
      } else {
        for (unsigned j = threadIdx.x; j < DG_TILE; j += DG_THREADS) {
          if (c0 + j >= rowlen) break;
          const unsigned long long e = r0 + c0 + j;
          out[e] = from_f32<T>((to_f32(d[e]) * rm) * drop_scale(drop, e));
        }
      }
    }
  }
}

// blocks of ``threads`` threads of ``kernel`` resident on the device at once
template <typename K>
static int resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int VEC>
static cudaError_t launch_drop_grad_as(const T* d, T* out, size_t n, int C,
                                       int tokens, const DropSite& drop,
                                       const DropSite& row_drop,
                                       cudaStream_t s) {
  static const int resident = resident_blocks(drop_grad<T, VEC>, DG_THREADS);
  const unsigned long long rowlen = (unsigned long long)tokens * C;
  const unsigned long long rows = n / rowlen;
  const unsigned long long chunks = (rowlen + DG_TILE - 1) / DG_TILE;
  // a block walks whole rows (one row draw for all its chunks) where the
  // rows fill the resident grid; otherwise a row's chunks are split over
  // several blocks
  const unsigned long long cap = resident > 0 ? resident : 1056;
  const unsigned gx = (unsigned)(rows < cap ? rows : cap);
  const unsigned long long want = (cap + gx - 1) / gx;
  const unsigned gy = (unsigned)(chunks < want ? chunks : want);
  drop_grad<T, VEC><<<dim3(gx, gy), DG_THREADS, 0, s>>>(
      d, out, rows, (unsigned)rowlen, drop, row_drop);
  return cudaGetLastError();
}

// drop_grad over n = M * C elements (rows of C, drop-path rows of ``tokens``
// of them); the vector route where C and both buffers allow it.
template <typename T>
static cudaError_t launch_drop_grad(const T* d, T* out, size_t n, int C,
                                    int tokens, const DropSite& drop,
                                    const DropSite& row_drop,
                                    cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (n == 0) return cudaSuccess;
  if (C < 1 || tokens < 1 || n % ((size_t)tokens * C) != 0 ||
      (unsigned long long)tokens * C > 0x7FFFFFFFull)
    return cudaErrorInvalidValue;
  if (C % VEC == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch_drop_grad_as<T, VEC>(d, out, n, C, tokens, drop, row_drop,
                                       s);
  return launch_drop_grad_as<T, 1>(d, out, n, C, tokens, drop, row_drop, s);
}

// h1 = gelu(pre1) (gelu_new with TANH, else exact), rounded to T, from the
// stashed pre-activation.
template <typename T, bool TANH>
__global__ void gelu_rows(const T* __restrict__ pre, T* __restrict__ out,
                          size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float v = to_f32(pre[i]);
    out[i] = from_f32<T>(TANH ? gelu_tanh(v) : gelu_erf(v));
  }
}

static int ew_blocks(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 65535 * 4 ? (b > 0 ? b : 1) : 65535 * 4);
}

// The mask kernel of rows 10 and 16 (draw_masks, draw_masks_gpt2): every
// site of a block or layer in one launch, from a table of sites in the
// kernel's parameters; out[s][e] = site s's multiplier of its logical
// element e (0 or 1 / keep), MASK_VEC consecutive elements a vector,
// MASK_UNROLL vectors a thread a tile (16-byte stores). Sizes of 0 are left
// out of the table.
constexpr int MASK_SITES = 5, MASK_THREADS = 256, MASK_VEC = 4,
              MASK_UNROLL = 2;
constexpr unsigned MASK_TILE = MASK_THREADS * MASK_VEC * MASK_UNROLL;

struct MaskTable {
  float* out[MASK_SITES];
  unsigned long long n[MASK_SITES];
  DropSite site[MASK_SITES];
  int count;
  unsigned aligned;  // bit s: out[s] lies on the 16-byte grid
};

static __global__ void __launch_bounds__(MASK_THREADS)
    fill_masks_kernel(const __grid_constant__ MaskTable t) {
  for (int s = 0; s < t.count; ++s) {
    const DropSite d = t.site[s];
    float* __restrict__ out = t.out[s];
    const unsigned long long n = t.n[s];
    const unsigned tiles = (unsigned)((n + MASK_TILE - 1) / MASK_TILE);
    if (d.thr >= DROP_KEEP_ALL) {  // rate 0: 1 / keep everywhere, no draw
      for (unsigned long long e = (unsigned long long)blockIdx.x *
                                      MASK_THREADS + threadIdx.x;
           e < n; e += (unsigned long long)gridDim.x * MASK_THREADS)
        out[e] = d.inv;
      continue;
    }
    const bool vec = ((t.aligned >> s) & 1u) != 0 && d.span == 0;
    for (unsigned tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const unsigned long long e0 = (unsigned long long)tile * MASK_TILE;
      if (vec && e0 + MASK_TILE <= n && drop_one_word(d, e0, MASK_TILE)) {
        const unsigned long long first = d.base + e0;
        const unsigned lo = (unsigned)first, hi = (unsigned)(first >> 32);
        float* dst = out + e0;
#pragma unroll
        for (int u = 0; u < MASK_UNROLL; ++u) {
          const unsigned off = (u * MASK_THREADS + threadIdx.x) * MASK_VEC;
          float m[MASK_VEC];
          drop_scales<MASK_VEC>(d, lo + off, hi, m);
          *reinterpret_cast<float4*>(dst + off) =
              make_float4(m[0], m[1], m[2], m[3]);
        }
      } else {
        for (unsigned j = threadIdx.x; j < MASK_TILE; j += MASK_THREADS) {
          const unsigned long long e = e0 + j;
          if (e >= n) break;
          out[e] = drop_scale(d, e);
        }
      }
    }
  }
}

// count <= MASK_SITES masks into bufs[i] (n[i] elements of site site_of(rt,
// sites[i]) each, or ``drops`` where given), in one launch.
static int fill_masks(const Rates& rt, void* const* bufs, const size_t* n,
                      const int* sites, int count, cudaStream_t s,
                      const DropSite* drops = nullptr) {
  static const int resident = resident_blocks(fill_masks_kernel,
                                              MASK_THREADS);
  if (count < 0 || count > MASK_SITES) return (int)cudaErrorInvalidValue;
  MaskTable t{};
  unsigned long long most = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] == 0) continue;
    const int k = t.count++;
    t.out[k] = static_cast<float*>(bufs[i]);
    t.n[k] = n[i];
    t.site[k] = drops != nullptr ? drops[i] : site_of(rt, sites[i]);
    if (reinterpret_cast<uintptr_t>(bufs[i]) % 16 == 0) t.aligned |= 1u << k;
    const unsigned long long tiles = (n[i] + MASK_TILE - 1) / MASK_TILE;
    if (tiles > most) most = tiles;
  }
  if (t.count == 0) return 0;
  const unsigned long long cap = resident > 0 ? resident : 1056;
  fill_masks_kernel<<<(unsigned)(most < cap ? most : cap), MASK_THREADS, 0,
                      s>>>(t);
  AFFT_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// The three entries
// ---------------------------------------------------------------------------

// A forward product on the wgmma / TMA GEMM in bf16: the GPT-2 layer's
// Conv1D (in, out) weights as its (K, N) operand (gemm_kn), the fuser's
// nn.Linear (out, in) weights as its (N, K) one (gemm_nk).
template <int EPI, bool GPT2, typename TRes, typename TOut, typename T>
static cudaError_t fwd_gemm(const T* a, const T* w, int M, int N, int K,
                            EpiArgs ea, cudaStream_t s) {
  if constexpr (GPT2) {
    // a shard's fp32 partial sum over a working-dtype residual
    if constexpr (!std::is_same<TOut, T>::value)
      return gemm_kn<EPI, T, TOut>(a, w, M, N, K, ea, s);
    return gemm_kn<EPI, T>(a, w, M, N, K, ea, s);
  } else {
    return gemm_nk<EPI, T, TRes, TOut>(a, w, M, N, K, ea, s);
  }
}

// The product that ends a half (proj, fc2: dropout, drop-path and the
// residual in its epilogue) into TOut, or with ``partial`` (a shard's
// row-parallel product) the fp32 partial sum of this rank's rows of the
// weight into ``part``, the bias and the residual added on rank 0 only.
template <bool GPT2, typename TRes, typename TOut, typename T>
static cudaError_t row_fwd_gemm(const Shard& sh, bool partial, const T* a,
                                const T* w, int M, int N, int K, EpiArgs ea,
                                float* part, cudaStream_t s) {
  if (!partial)
    return fwd_gemm<EPI_RES_DROP, GPT2, TRes, TOut>(a, w, M, N, K, ea, s);
  if (!sh.lead()) ea.bias = ea.res = nullptr;
  ea.out = part;
  ea.out2 = nullptr;
  return fwd_gemm<EPI_RES_DROP, GPT2, TRes, float>(a, w, M, N, K, ea, s);
}

// The longest N each layer's short attention kernels take: past it the
// forward and the backward both take the long route (long_attention.cuh),
// whose backward recomputes the long forward's output.
template <bool GPT2>
constexpr int short_tokens() {
  return GPT2 ? AS_MAX_N : FR_MAX_N;
}

// The forward attention with dropout on the probabilities: staged for the
// GPT-2 layer (p * keep rounded), the fuser attention's rows kernel with its
// dropout for the fuser (fp32 probabilities), up to short_tokens; past it
// the long route with the same cast chain. attention_bwd and the long
// backward recompute its output with the same arithmetic.
template <typename T, bool GPT2>
static cudaError_t attention_drop(const T* qkv, const float* mask, T* out,
                                  int R, int N, int H, int hd, DropSite drop,
                                  cudaStream_t s) {
  if (N > short_tokens<GPT2>())
    return launch_long_attention<T, GPT2, true>(
        packed_long_attn<T>(qkv, mask, out, R, N, H, hd, drop), s);
  if constexpr (GPT2) {
    launch_staged_attention<T, true>(qkv, mask, out, R, N, H, hd, drop, s);
    return cudaGetLastError();
  } else {
    return launch_fuser_attention_rows<T, true>(qkv, mask, out, R, N, H, hd,
                                                s, drop);
  }
}

// Its backward: dqkv, and the forward's output O into out (bit for bit).
// Past short_tokens the long backward, with stats (R * H * N, 2) and dsum
// (R * H * N) fp32 scratch (cudaErrorInvalidValue without them).
template <typename T, bool GPT2>
static cudaError_t attention_drop_bwd(const T* qkv, const float* mask,
                                      const float* dao, T* dqkv, T* out,
                                      float* stats, float* dsum, int R, int N,
                                      int H, int hd, DropSite drop,
                                      cudaStream_t s) {
  if (N <= short_tokens<GPT2>())
    return launch_attention_bwd<T, GPT2>(qkv, mask, dao, dqkv, out, R, N, H,
                                         hd, drop, s);
  LongAttn a = packed_long_attn<T>(qkv, mask, out, R, N, H, hd, drop);
  const long long A = (long long)H * hd;
  a.stats = stats;
  a.dao = dao;
  a.dsum = dsum;
  a.dq = dqkv;
  a.dk = dqkv + A;
  a.dv = dqkv + 2 * A;
  a.dqs = a.dks = a.dvs = a.qs;
  return launch_long_attention_bwd<T, GPT2, true>(a, s);
}

// dX = dY . W^T through a weight read where it lies, on the wgmma / TMA
// GEMM in bf16: the fuser's (out, in) weight is the (K, N) operand of the
// backward product (gemm_kn), the GPT-2 layer's (in, out) weight the (N, K)
// one (gemm_nk). The residual of the epilogue is in T.
template <int EPI, bool GPT2, typename TOut, typename T>
static cudaError_t launch_dx(const T* dy, const T* w, int M, int N, int K,
                             EpiArgs ea, cudaStream_t s) {
  if constexpr (GPT2) {
    return gemm_nk<EPI, T, T, TOut>(dy, w, M, N, K, ea, s);
  } else {
    return gemm_kn<EPI, T, TOut>(dy, w, M, N, K, ea, s);
  }
}

// The weight gradient in the weight's own layout, from the layer input x
// (M, in) and the output gradient dy (M, out): (out, in) = dy^T . x for the
// fuser, (in, out) = x^T . dy for the GPT-2 layer (gemm_tn: the TN route of
// the wgmma / TMA GEMM in bf16, split over M into ``scratch`` where
// tn_slices says so; one slice without scratch).
template <bool GPT2, typename T>
static cudaError_t launch_dw(const T* x, const T* dy, float* out, int in,
                             int out_n, int M, cudaStream_t s,
                             float* scratch = nullptr) {
  return GPT2 ? gemm_tn(x, dy, out, in, out_n, M, s, scratch)
              : gemm_tn(dy, x, out, out_n, in, M, s, scratch);
}

// Scratch: tmp (M, C), y32 (M, C) fp32 (the fuser's residual stream in bf16;
// unused otherwise), h1 (M, hidden); outputs out (R, N, C), y (M, C), qkv
// (M, 3A), pre1 (M, hidden). Under a shard ``out`` is the fp32 partial sum
// (M, C) of the call's last product: the GPT-2 attention half's y (PART_ATTN:
// y and pre1 unused) or the block's output; the GPT-2 MLP half (PART_MLP)
// reads the summed, rounded y from ``y`` (qkv unused).
template <typename T, bool GPT2>
static int run_fwd(const T* x, const void* const* pv, const float* mask,
                   const Rates& rt, const Shard& sh, T* tmp, float* y32,
                   T* h1, T* out, T* y, T* qkv, T* pre1, int R, int N, int C,
                   int H, int hidden, float eps, cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  const int M = R * N, A = sh.width(C);
  float* part = reinterpret_cast<float*>(out);
  // the residual stream between the halves: rounded for GPT-2, fp32 for the
  // fuser (in fp32 the stashed y is that stream)
  typedef typename std::conditional<GPT2, T, float>::type TY;
  const bool in_y = GPT2 || std::is_same<T, float>::value;
  TY* yres = in_y ? reinterpret_cast<TY*>(y) : reinterpret_cast<TY*>(y32);
  if (sh.part != PART_MLP) {
    launch_layernorm<T, T>(x, p[TP_LN1G], p[TP_LN1B], tmp, M, C, eps, s);
    AFFT_CHECK_LAUNCH();
    AFFT_CHECK((fwd_gemm<EPI_BIAS, GPT2, T, T>(
        tmp, p[TP_WQKV], M, 3 * A, C, EpiArgs{p[TP_BQKV], nullptr, qkv}, s)));
    AFFT_CHECK((attention_drop<T, GPT2>(qkv, mask, tmp, R, N, H, A / H,
                                        site_of(rt, SITE_ATTN), s)));
    // the proj over this shard's heads: a partial sum in the GPT-2 layer's
    // attention half alone
    AFFT_CHECK((row_fwd_gemm<GPT2, T, TY>(
        sh, sh.part == PART_ATTN, tmp, p[TP_WPROJ], M, C, A,
        EpiArgs{p[TP_BPROJ], x, yres, in_y ? nullptr : y,
                site_of(rt, SITE_PROJ), site_of(rt, SITE_DP1), N},
        part, s)));
    if (sh.part == PART_ATTN) return 0;
  }
  launch_layernorm<TY, T>(yres, p[TP_LN2G], p[TP_LN2B], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK((fwd_gemm<GPT2 ? EPI_PRE_GELU_TANH : EPI_PRE_GELU, GPT2, T, T>(
      tmp, p[TP_WFC1], M, hidden, C, EpiArgs{p[TP_BFC1], nullptr, h1, pre1},
      s)));
  // fc2 over this shard's MLP columns: a partial sum under any shard
  AFFT_CHECK((row_fwd_gemm<GPT2, TY, T>(
      sh, sh.on(), h1, p[TP_WFC2], M, C, hidden,
      EpiArgs{p[TP_BFC2], yres, out, nullptr, site_of(rt, SITE_MLP),
              site_of(rt, SITE_DP2), N},
      part, s)));
  return 0;
}

// Scratch of the MLP backward: tmp, dh2 (M, C) T; h1, dpre1 (M, hidden) T;
// dg (M, C) fp32; mu, rstd (M) fp32; partial (2 * CS_SLICES * max(3C, hidden))
// fp32. Gradients gv (TrainParam order, fp32, null where the parameter is
// absent): this entry writes TP_LN2G .. TP_BFC2. Under a shard dy is the
// fp32 partial sum (M, C) and the LN2 affine gradients are partial sums.
template <typename T, bool GPT2>
static int run_bwd_mlp(const T* y, const T* dout, const T* pre1,
                       const void* const* pv, float* const* gv,
                       const Rates& rt, const Shard& sh, T* tmp, T* dh2,
                       T* h1, T* dpre1,
                       float* dg, float* mu, float* rstd, float* partial,
                       T* dy, int R, int N, int C, int hidden, float eps,
                       cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  const int M = R * N;
  const size_t n = (size_t)M * C, nh = (size_t)M * hidden;
  AFFT_CHECK((launch_drop_grad<T>(dout, dh2, n, C, N, site_of(rt, SITE_MLP),
                                  site_of(rt, SITE_DP2), s)));
  launch_layernorm<T, T>(y, p[TP_LN2G], p[TP_LN2B], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  gelu_rows<T, GPT2><<<ew_blocks(nh), 256, 0, s>>>(pre1, h1, nh);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK((launch_dw<GPT2>(h1, dh2, gv[TP_WFC2], hidden, C, M, s)));
  if (gv[TP_BFC2] != nullptr) {
    launch_colsum<T>(dh2, partial, gv[TP_BFC2], M, C, s);
    AFFT_CHECK_LAUNCH();
  }
  // dpre1 = (dh2 . W2^T) * gelu'(pre1)
  AFFT_CHECK((launch_dx<GPT2 ? EPI_GELU_TANH_BWD : EPI_GELU_BWD, GPT2, T>(
      dh2, p[TP_WFC2], M, hidden, C, EpiArgs{nullptr, pre1, dpre1}, s)));
  AFFT_CHECK((launch_dw<GPT2>(tmp, dpre1, gv[TP_WFC1], C, hidden, M, s)));
  if (gv[TP_BFC1] != nullptr) {
    launch_colsum<T>(dpre1, partial, gv[TP_BFC1], M, hidden, s);
    AFFT_CHECK_LAUNCH();
  }
  // dg = dpre1 . W1^T, fp32
  AFFT_CHECK((launch_dx<EPI_BIAS, GPT2, float>(
      dpre1, p[TP_WFC1], M, C, hidden, EpiArgs{nullptr, nullptr, dg}, s)));
  if (sh.on()) {
    // this shard's partial dy (fp32); rank 0 adds the pass-through dout
    layernorm_bwd_rows<T, float><<<cdiv(M, LN_ROWS), LN_ROWS * 32, 0, s>>>(
        y, dg, p[TP_LN2G], sh.lead() ? dout : nullptr,
        reinterpret_cast<float*>(dy), mu, rstd, M, C, eps);
  } else {
    layernorm_bwd_rows<T><<<cdiv(M, LN_ROWS), LN_ROWS * 32, 0, s>>>(
        y, dg, p[TP_LN2G], dout, dy, mu, rstd, M, C, eps);
  }
  AFFT_CHECK_LAUNCH();
  if (gv[TP_LN2G] != nullptr) {
    launch_ln_colsum<T>(dg, y, mu, rstd, partial, gv[TP_LN2G], gv[TP_LN2B], M,
                        C, s);
    AFFT_CHECK_LAUNCH();
  }
  return 0;
}

// Scratch of the attention backward: tmp, dproj (M, C) T; dqkv (M, 3C) T;
// dattn (M, C) fp32 (reused for dxn); mu, rstd, partial as above; tn the TN
// route's partial tiles (tn_slices(I, J, M) * I * J fp32 for each weight
// gradient's (I, J), or null: one slice); stats (R * H * N, 2) and dsum (R *
// H * N) fp32 past short_tokens (the long backward's), else null. Writes the
// gradients TP_LN1G ..
// TP_BPROJ. Under a shard (the GPT-2 layer's heads) dx is the fp32 partial
// sum (R, N, C), the LN1 affine gradients partial sums; qkv and dqkv are (M,
// 3A), dattn holds (M, A) and then dxn (M, C).
template <typename T, bool GPT2>
static int run_bwd_attn(const T* x, const T* dy, const T* qkv,
                        const void* const* pv, float* const* gv,
                        const float* mask, const Rates& rt, const Shard& sh,
                        T* tmp, T* dproj, T* dqkv, float* dattn, float* mu,
                        float* rstd, float* partial, float* tn, float* stats,
                        float* dsum, T* dx, int R, int N, int C, int H,
                        float eps, cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  const int M = R * N, A = sh.width(C);
  const size_t n = (size_t)M * C;
  AFFT_CHECK((launch_drop_grad<T>(dy, dproj, n, C, N, site_of(rt, SITE_PROJ),
                                  site_of(rt, SITE_DP1), s)));
  // dattn = dproj . Wproj^T, fp32
  AFFT_CHECK((launch_dx<EPI_BIAS, GPT2, float>(
      dproj, p[TP_WPROJ], M, A, C, EpiArgs{nullptr, nullptr, dattn}, s)));
  // dqkv, and the forward's attention output O into tmp
  AFFT_CHECK((attention_drop_bwd<T, GPT2>(qkv, mask, dattn, dqkv, tmp, stats,
                                          dsum, R, N, H, A / H,
                                          site_of(rt, SITE_ATTN), s)));
  AFFT_CHECK((launch_dw<GPT2>(tmp, dproj, gv[TP_WPROJ], A, C, M, s, tn)));
  if (gv[TP_BPROJ] != nullptr) {
    launch_colsum<T>(dproj, partial, gv[TP_BPROJ], M, C, s);
    AFFT_CHECK_LAUNCH();
  }
  launch_layernorm<T, T>(x, p[TP_LN1G], p[TP_LN1B], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK((launch_dw<GPT2>(tmp, dqkv, gv[TP_WQKV], C, 3 * A, M, s, tn)));
  if (gv[TP_BQKV] != nullptr) {
    launch_colsum<T>(dqkv, partial, gv[TP_BQKV], M, 3 * A, s);
    AFFT_CHECK_LAUNCH();
  }
  // dxn = dqkv . Wqkv^T, fp32, over dattn's buffer
  AFFT_CHECK((launch_dx<EPI_BIAS, GPT2, float>(
      dqkv, p[TP_WQKV], M, C, 3 * A, EpiArgs{nullptr, nullptr, dattn}, s)));
  if (sh.on()) {
    // this shard's partial dx (fp32); rank 0 adds the pass-through dy
    layernorm_bwd_rows<T, float><<<cdiv(M, LN_ROWS), LN_ROWS * 32, 0, s>>>(
        x, dattn, p[TP_LN1G], sh.lead() ? dy : nullptr,
        reinterpret_cast<float*>(dx), mu, rstd, M, C, eps);
  } else {
    layernorm_bwd_rows<T><<<cdiv(M, LN_ROWS), LN_ROWS * 32, 0, s>>>(
        x, dattn, p[TP_LN1G], dy, dx, mu, rstd, M, C, eps);
  }
  AFFT_CHECK_LAUNCH();
  if (gv[TP_LN1G] != nullptr) {
    launch_ln_colsum<T>(dattn, x, mu, rstd, partial, gv[TP_LN1G],
                        gv[TP_LN1B], M, C, s);
    AFFT_CHECK_LAUNCH();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The C entries' bodies: dtype 0 = float32, 1 = bfloat16; params the twelve
// tensors in TrainParam order (host array of device pointers, null for an
// absent one) in that dtype; mask fp32 (N, N) or null; seeds = {seed word 0,
// seed word 1, block index, first global row}, thr / inv the three 24-bit
// keep thresholds and 1 / keep scales (host arrays); shard = {rank, count,
// part, heads} (shard_of; null: the whole layer; H is then the local
// heads); bufs a host array of device pointers. Each returns the first
// launch error (cudaError_t), 0 on success; cudaErrorInvalidValue for a
// shard the entry does not take.
// ---------------------------------------------------------------------------

// f((T*)nullptr) for the working dtype T of ``dtype``.
template <typename F>
static int by_dtype(int dtype, F&& f) {
  if (dtype == 0) return f((float*)nullptr);
  if (dtype == 1) return f((bf16*)nullptr);
  return (int)cudaErrorInvalidValue;
}

// bufs: tmp (M, C), y32 (M, C) fp32 (the fuser in bf16 only), h1 (M, hidden)
// scratch; out (R, N, C) (fp32 (M, C) under a shard), y (M, C), qkv (M, 3A),
// pre1 (M, hidden) outputs (run_fwd).
template <bool GPT2>
static int train_fwd(int dtype, const void* x, const void* const* params,
                     const void* mask, const int* seeds, const int* thr,
                     const float* inv, const int* shard, void* const* bufs,
                     int R, int N, int C, int H, int hidden, float eps,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shard sh = shard_of(shard);
  if (!shard_ok(sh, GPT2, C, H)) return (int)cudaErrorInvalidValue;
  const Rates rt = rates_of(seeds, thr, inv, N, C, H, sh);
  return by_dtype(dtype, [&](auto tag) {
    typedef typename std::remove_pointer<decltype(tag)>::type T;
    return run_fwd<T, GPT2>((const T*)x, params, (const float*)mask, rt, sh,
                            (T*)bufs[0], (float*)bufs[1], (T*)bufs[2],
                            (T*)bufs[3], (T*)bufs[4], (T*)bufs[5],
                            (T*)bufs[6], R, N, C, H, hidden, eps, s);
  });
}

// bufs: tmp, dh2, h1, dpre1, dg, mu, rstd, partial scratch (run_bwd_mlp);
// dy (M, C) output (fp32 under a shard). grads: fp32 outputs in TrainParam
// order.
template <bool GPT2>
static int train_bwd_mlp(int dtype, const void* y, const void* dout,
                         const void* pre1, const void* const* params,
                         void* const* grads, const int* seeds, const int* thr,
                         const float* inv, const int* shard,
                         void* const* bufs, int R, int N, int C, int hidden,
                         float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shard sh = shard_of(shard);
  // the MLP half draws no attention mask: H is not needed
  if (!shard_ok({sh.rank, sh.count, PART_BOTH, 0}, false, C, 1))
    return (int)cudaErrorInvalidValue;
  const Rates rt = rates_of(seeds, thr, inv, N, C, 0);
  float* const* gv = reinterpret_cast<float* const*>(grads);
  return by_dtype(dtype, [&](auto tag) {
    typedef typename std::remove_pointer<decltype(tag)>::type T;
    return run_bwd_mlp<T, GPT2>(
        (const T*)y, (const T*)dout, (const T*)pre1, params, gv, rt, sh,
        (T*)bufs[0], (T*)bufs[1], (T*)bufs[2], (T*)bufs[3], (float*)bufs[4],
        (float*)bufs[5], (float*)bufs[6], (float*)bufs[7], (T*)bufs[8], R, N,
        C, hidden, eps, s);
  });
}

// bufs: tmp, dproj, dqkv, dattn, mu, rstd, partial scratch (run_bwd_attn);
// dx (R, N, C) output (fp32 under a shard); tn, stats, dsum scratch
// (run_bwd_attn; may be null). A shard here splits the heads (the GPT-2
// layer's).
template <bool GPT2>
static int train_bwd_attn(int dtype, const void* x, const void* dy,
                          const void* qkv, const void* const* params,
                          void* const* grads, const void* mask,
                          const int* seeds, const int* thr, const float* inv,
                          const int* shard, void* const* bufs, int R, int N,
                          int C, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shard sh = shard_of(shard);
  if (sh.on() && !(GPT2 && sh.heads && sh.rank >= 0 && sh.rank < sh.count &&
                   C % sh.count == 0 && (C / sh.count) % H == 0))
    return (int)cudaErrorInvalidValue;
  const Rates rt = rates_of(seeds, thr, inv, N, C, H, sh);
  float* const* gv = reinterpret_cast<float* const*>(grads);
  return by_dtype(dtype, [&](auto tag) {
    typedef typename std::remove_pointer<decltype(tag)>::type T;
    return run_bwd_attn<T, GPT2>(
        (const T*)x, (const T*)dy, (const T*)qkv, params, gv,
        (const float*)mask, rt, sh, (T*)bufs[0], (T*)bufs[1], (T*)bufs[2],
        (float*)bufs[3], (float*)bufs[4], (float*)bufs[5], (float*)bufs[6],
        (float*)bufs[8], (float*)bufs[9], (float*)bufs[10], (T*)bufs[7], R, N,
        C, H, eps, s);
  });
}

}  // namespace afft
