// fused_block_train: one pre-LN fuser block in training mode on (R, N, C)
// tokens, with dropout on the attention probabilities, on the proj and MLP
// outputs and per-row drop-path, its two backward halves, and draw_masks.
//
// Replaces the TPU kernels of afft_tpu/ops/pallas_block_train.py:
// fused_block_train (_fwd_kernel, _bwd_mlp_kernel, _bwd_attn_kernel) and
// draw_masks (_masks_kernel). The TPU kernels keep the block's 25 MB of
// weights and, in the backward, up to 32 MB of fp32 weight-gradient
// accumulators in VMEM and walk the rows in a sequential grid. Here each
// entry is a sequence of launches on one stream with the intermediates in
// HBM / L2:
//   forward       LN1 -> qkv GEMM (stashed) -> N-token attention with dropout
//                 -> proj GEMM (dropout, drop-path, + x: fp32 y and its stash)
//                 -> LN2 -> fc1 GEMM (stashes pre1, GELU) -> fc2 GEMM
//                 (dropout, drop-path, + y);
//   backward, MLP dh2 = dout * masks -> LN2 and GELU recomputed from the
//                 stash -> dW2, db2 -> dpre1 = (dh2 . W2) * gelu'(pre1) ->
//                 dW1, db1 -> dg = dpre1 . W1 -> LayerNorm backward (dy) and
//                 its affine gradients;
//   backward, attention  dproj = dy * masks -> attention recomputed from the
//                 stashed qkv -> dWproj, dbproj -> dattn = dproj . Wproj ->
//                 attention backward (dqkv) -> dWqkv, dbqkv -> dxn = dqkv .
//                 Wqkv -> LayerNorm backward (dx) and its affine gradients.
// The cast chain is the TPU kernel's (pallas_block_train.py:200-239,
// :263-300, :325-447): qkv, y and pre1 are stashed in the working dtype, the
// backward takes its LayerNorm statistics from the stashed x / y, dh2, dpre1,
// dproj and dqkv are rounded to the working dtype before their GEMMs, and
// every parameter gradient is fp32.
//
// Masks: each is a pure function of (two seed words, block index, site,
// logical element index), drawn in registers where it is used (common.cuh
// drop_scale), so the forward and both backward halves see the same mask and
// none is ever stored. Element indices: attention ((r * H + h) * N + tq) * N
// + tk; proj and MLP (r * N + t) * C + c; drop-path r.
//
// Bound on an H100 at the flagship shape (R = 4096, N = 5, C = 1024, hidden
// 4096, bf16): the forward does 516 GFLOP, the MLP backward 687 GFLOP and the
// attention backward 344 GFLOP of GEMMs, each against a few hundred MB of
// compulsory traffic, so all three are bound by the tensor cores (0.52, 0.69
// and 0.35 ms at 989 TFLOP/s). The design keeps every product on the tensor
// cores (wmma, fp32 accumulation) with its elementwise work in the epilogue;
// the weight gradients reduce over all 20,480 rows inside one block per
// output tile, in a fixed order, and the bias and LayerNorm-affine gradients
// are two-stage column sums, so every gradient is the same from run to run.
//
// Limits: any R, 1 <= N <= 8, H * hd = C with hd % 8 == 0, hidden % 8 == 0,
// fp32 or bf16; norm affines and the qkv bias optional (null pointers, and
// then no gradient is written for them).

#include "common.cuh"

using namespace afft;

namespace afft {

enum Site { SITE_ATTN = 0, SITE_PROJ, SITE_DP1, SITE_MLP, SITE_DP2 };

// Parameter slots (nn.Linear weights, (out, in)) and their gradients.
enum TrainParam {
  TP_LN1G, TP_LN1B, TP_WQKV, TP_BQKV, TP_WPROJ, TP_BPROJ, TP_LN2G, TP_LN2B,
  TP_WFC1, TP_BFC1, TP_WFC2, TP_BFC2
};

// seeds[0..1] the step's seed words, seeds[2] the block index; thr / inv:
// 0 attention probabilities, 1 proj and MLP dropout, 2 drop-path.
struct Rates {
  unsigned seed0, seed1, block;
  unsigned thr[3];
  float inv[3];
};

static DropSite site_of(const Rates& r, int site) {
  const int kind = site == SITE_ATTN ? 0
                   : (site == SITE_PROJ || site == SITE_MLP) ? 1 : 2;
  return DropSite{r.seed0, r.seed1, r.block, (unsigned)site, r.thr[kind],
                  r.inv[kind]};
}

// ---------------------------------------------------------------------------
// Attention over S <= 32 tokens with dropout on the probabilities: one block
// per (row, head), one warp per query, as small_attention. The probability
// is scaled by its keep multiplier before P . V; everything is fp32.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(1024)
small_attention_drop(const T* __restrict__ qkv, const float* __restrict__ mask,
                     T* __restrict__ out, int S, int H, int hd, float scale,
                     DropSite drop) {
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
  const float m = warp_max(mine);
  const float e = lane < S ? expf(mine - m) : 0.f;
  float p = e / warp_sum(e);
  if (lane < S)
    p *= drop_scale(drop,
                    (((unsigned long long)seq * H + h) * S + tq) * S + lane);
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

// ---------------------------------------------------------------------------
// Its backward: from the stashed qkv and dao = d(attention output) (fp32),
// recompute p and the keep multipliers, then
//   dv[tk] = sum_tq (p * keep)[tq, tk] * dao[tq]
//   dp[tq, tk] = (dao[tq] . v[tk]) * keep[tq, tk]
//   ds = p * (dp - sum_tk dp * p)
//   dq[tq] = scale * sum_tk ds[tq, tk] * k[tk]
//   dk[tk] = scale * sum_tq ds[tq, tk] * q[tq]
// into the packed dqkv (rows, 3C) in the working dtype. Warp t first holds
// query t, then writes token t's dq, dk and dv.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(1024)
small_attention_drop_bwd(const T* __restrict__ qkv,
                         const float* __restrict__ mask,
                         const float* __restrict__ dao, T* __restrict__ dqkv,
                         int S, int H, int hd, float scale, DropSite drop) {
  __shared__ float pd[32][33];  // p * keep
  __shared__ float ds[32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * hd;
  const size_t ld = 3 * (size_t)C;
  const T* base = qkv + (size_t)seq * S * ld + (size_t)h * hd;
  const float* gbase = dao + (size_t)seq * S * C + (size_t)h * hd;
  const int tq = warp;
  const T* q = base + tq * ld;
  const float* g = gbase + (size_t)tq * C;

  float mine = -INFINITY, dpd = 0.f;
  for (int tk = 0; tk < S; ++tk) {
    const T* k = base + tk * ld + C;
    const T* v = base + tk * ld + 2 * (size_t)C;
    float sc = 0.f, dv = 0.f;
    for (int j = lane; j < hd; j += 32) {
      sc = fmaf(to_f32(q[j]), to_f32(k[j]), sc);
      dv = fmaf(g[j], to_f32(v[j]), dv);
    }
    sc = warp_sum(sc);
    dv = warp_sum(dv);
    if (lane == tk) {
      mine = sc * scale + (mask != nullptr ? mask[tq * S + tk] : 0.f);
      dpd = dv;
    }
  }
  const float m = warp_max(mine);
  const float e = lane < S ? expf(mine - m) : 0.f;
  const float p = e / warp_sum(e);
  const float keep =
      lane < S ? drop_scale(drop, (((unsigned long long)seq * H + h) * S + tq) *
                                          S + lane)
               : 0.f;
  const float dp = dpd * keep;
  const float sdot = warp_sum(lane < S ? dp * p : 0.f);
  pd[tq][lane] = p * keep;
  ds[tq][lane] = lane < S ? p * (dp - sdot) : 0.f;
  __syncthreads();

  const int t = warp;
  T* dq = dqkv + ((size_t)seq * S + t) * ld + (size_t)h * hd;
  for (int j = lane; j < hd; j += 32) {
    float aq = 0.f, ak = 0.f, av = 0.f;
    for (int u = 0; u < S; ++u) {
      aq += ds[t][u] * to_f32(base[u * ld + C + j]) * scale;
      ak += ds[u][t] * to_f32(base[u * ld + j]) * scale;
      av += pd[u][t] * gbase[(size_t)u * C + j];
    }
    dq[j] = from_f32<T>(aq);
    dq[C + j] = from_f32<T>(ak);
    dq[2 * (size_t)C + j] = from_f32<T>(av);
  }
}

// ---------------------------------------------------------------------------
// Elementwise passes
// ---------------------------------------------------------------------------

// out = (d * row_drop[row / tokens]) * drop[row, col], rounded to T: the
// gradient entering a branch's last GEMM.
template <typename T>
__global__ void drop_grad(const T* __restrict__ d, T* __restrict__ out,
                          size_t n, int C, int tokens, DropSite drop,
                          DropSite row_drop) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / C;
    const float v = (to_f32(d[i]) * drop_scale(row_drop, row / tokens)) *
                    drop_scale(drop, i);
    out[i] = from_f32<T>(v);
  }
}

// h1 = gelu_exact(pre1), rounded to T, from the stashed pre-activation.
template <typename T>
__global__ void gelu_rows(const T* __restrict__ pre, T* __restrict__ out,
                          size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = from_f32<T>(gelu_erf(to_f32(pre[i])));
}

// out[i] = the site's multiplier of logical element i (0 or 1 / keep).
__global__ void fill_mask(float* __restrict__ out, size_t n, DropSite site) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = drop_scale(site, i);
}

static int ew_blocks(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 65535 * 4 ? (b > 0 ? b : 1) : 65535 * 4);
}

// ---------------------------------------------------------------------------
// The three entries
// ---------------------------------------------------------------------------

template <typename T>
static int run_fwd(const T* x, const void* const* pv, const float* mask,
                   const Rates& rt, T* tmp, float* y32, T* h1, T* out, T* y,
                   T* qkv, T* pre1, int R, int N, int C, int H, int hidden,
                   float eps, cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  const int M = R * N;
  // in fp32 the stashed y is the residual stream itself
  const bool same = std::is_same<T, float>::value;
  float* yres = same ? reinterpret_cast<float*>(y) : y32;
  launch_layernorm<T, T>(x, p[TP_LN1G], p[TP_LN1B], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_BIAS, false, T, T>(tmp, p[TP_WQKV], M, 3 * C, C,
                                     EpiArgs{p[TP_BQKV], nullptr, qkv}, s);
  AFFT_CHECK_LAUNCH();
  const float scale = (float)(1.0 / sqrt((double)(C / H)));
  small_attention_drop<T><<<R * H, N * 32, 0, s>>>(
      qkv, mask, tmp, N, H, C / H, scale, site_of(rt, SITE_ATTN));
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_RES_DROP, false, T, float>(
      tmp, p[TP_WPROJ], M, C, C,
      EpiArgs{p[TP_BPROJ], x, yres, same ? nullptr : y,
              site_of(rt, SITE_PROJ), site_of(rt, SITE_DP1), N},
      s);
  AFFT_CHECK_LAUNCH();
  launch_layernorm<float, T>(yres, p[TP_LN2G], p[TP_LN2B], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_PRE_GELU, false, T, T>(
      tmp, p[TP_WFC1], M, hidden, C, EpiArgs{p[TP_BFC1], nullptr, h1, pre1},
      s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_RES_DROP, false, float, T>(
      h1, p[TP_WFC2], M, C, hidden,
      EpiArgs{p[TP_BFC2], yres, out, nullptr, site_of(rt, SITE_MLP),
              site_of(rt, SITE_DP2), N},
      s);
  AFFT_CHECK_LAUNCH();
  return 0;
}

// Scratch of the MLP backward: tmp, dh2 (M, C) T; h1, dpre1 (M, hidden) T;
// dg (M, C) fp32; mu, rstd (M) fp32; partial (2 * CS_SLICES * max(3C, hidden))
// fp32. Gradients gv (TrainParam order, fp32, null where the parameter is
// absent): this entry writes TP_LN2G .. TP_BFC2.
template <typename T>
static int run_bwd_mlp(const T* y, const T* dout, const T* pre1,
                       const void* const* pv, float* const* gv,
                       const Rates& rt, T* tmp, T* dh2, T* h1, T* dpre1,
                       float* dg, float* mu, float* rstd, float* partial,
                       T* dy, int R, int N, int C, int hidden, float eps,
                       cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  const int M = R * N;
  const size_t n = (size_t)M * C, nh = (size_t)M * hidden;
  drop_grad<T><<<ew_blocks(n), 256, 0, s>>>(dout, dh2, n, C, N,
                                            site_of(rt, SITE_MLP),
                                            site_of(rt, SITE_DP2));
  AFFT_CHECK_LAUNCH();
  launch_layernorm<T, T>(y, p[TP_LN2G], p[TP_LN2B], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  gelu_rows<T><<<ew_blocks(nh), 256, 0, s>>>(pre1, h1, nh);
  AFFT_CHECK_LAUNCH();
  // dW2 (C, hidden) = dh2^T . h1
  launch_gemm_tn(dh2, h1, gv[TP_WFC2], C, hidden, M, s);
  AFFT_CHECK_LAUNCH();
  if (gv[TP_BFC2] != nullptr) {
    launch_colsum<T>(dh2, partial, gv[TP_BFC2], M, C, s);
    AFFT_CHECK_LAUNCH();
  }
  // dpre1 = (dh2 . W2) * gelu'(pre1); W2 (C, hidden) is the (K, N) operand
  launch_gemm<EPI_GELU_BWD, true, T, T>(dh2, p[TP_WFC2], M, hidden, C,
                                        EpiArgs{nullptr, pre1, dpre1}, s);
  AFFT_CHECK_LAUNCH();
  // dW1 (hidden, C) = dpre1^T . LN2(y)
  launch_gemm_tn(dpre1, tmp, gv[TP_WFC1], hidden, C, M, s);
  AFFT_CHECK_LAUNCH();
  if (gv[TP_BFC1] != nullptr) {
    launch_colsum<T>(dpre1, partial, gv[TP_BFC1], M, hidden, s);
    AFFT_CHECK_LAUNCH();
  }
  // dg = dpre1 . W1, fp32
  launch_gemm<EPI_BIAS, true, T, float>(dpre1, p[TP_WFC1], M, C, hidden,
                                        EpiArgs{nullptr, nullptr, dg}, s);
  AFFT_CHECK_LAUNCH();
  layernorm_bwd_rows<T><<<cdiv(M, LN_ROWS), LN_ROWS * 32, 0, s>>>(
      y, dg, p[TP_LN2G], dout, dy, mu, rstd, M, C, eps);
  AFFT_CHECK_LAUNCH();
  if (gv[TP_LN2G] != nullptr) {
    launch_ln_colsum<T>(dg, y, mu, rstd, partial, gv[TP_LN2G], gv[TP_LN2B], M,
                        C, s);
    AFFT_CHECK_LAUNCH();
  }
  return 0;
}

// Scratch of the attention backward: tmp, dproj (M, C) T; dqkv (M, 3C) T;
// dattn (M, C) fp32 (reused for dxn); mu, rstd, partial as above. Writes the
// gradients TP_LN1G .. TP_BPROJ.
template <typename T>
static int run_bwd_attn(const T* x, const T* dy, const T* qkv,
                        const void* const* pv, float* const* gv,
                        const float* mask, const Rates& rt, T* tmp, T* dproj,
                        T* dqkv, float* dattn, float* mu, float* rstd,
                        float* partial, T* dx, int R, int N, int C, int H,
                        float eps, cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  const int M = R * N;
  const size_t n = (size_t)M * C;
  const float scale = (float)(1.0 / sqrt((double)(C / H)));
  drop_grad<T><<<ew_blocks(n), 256, 0, s>>>(dy, dproj, n, C, N,
                                            site_of(rt, SITE_PROJ),
                                            site_of(rt, SITE_DP1));
  AFFT_CHECK_LAUNCH();
  small_attention_drop<T><<<R * H, N * 32, 0, s>>>(
      qkv, mask, tmp, N, H, C / H, scale, site_of(rt, SITE_ATTN));
  AFFT_CHECK_LAUNCH();
  // dWproj (C, C) = dproj^T . attention output
  launch_gemm_tn(dproj, tmp, gv[TP_WPROJ], C, C, M, s);
  AFFT_CHECK_LAUNCH();
  if (gv[TP_BPROJ] != nullptr) {
    launch_colsum<T>(dproj, partial, gv[TP_BPROJ], M, C, s);
    AFFT_CHECK_LAUNCH();
  }
  // dattn = dproj . Wproj, fp32
  launch_gemm<EPI_BIAS, true, T, float>(dproj, p[TP_WPROJ], M, C, C,
                                        EpiArgs{nullptr, nullptr, dattn}, s);
  AFFT_CHECK_LAUNCH();
  small_attention_drop_bwd<T><<<R * H, N * 32, 0, s>>>(
      qkv, mask, dattn, dqkv, N, H, C / H, scale, site_of(rt, SITE_ATTN));
  AFFT_CHECK_LAUNCH();
  launch_layernorm<T, T>(x, p[TP_LN1G], p[TP_LN1B], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  // dWqkv (3C, C) = dqkv^T . LN1(x)
  launch_gemm_tn(dqkv, tmp, gv[TP_WQKV], 3 * C, C, M, s);
  AFFT_CHECK_LAUNCH();
  if (gv[TP_BQKV] != nullptr) {
    launch_colsum<T>(dqkv, partial, gv[TP_BQKV], M, 3 * C, s);
    AFFT_CHECK_LAUNCH();
  }
  // dxn = dqkv . Wqkv, fp32, over dattn's buffer
  launch_gemm<EPI_BIAS, true, T, float>(dqkv, p[TP_WQKV], M, C, 3 * C,
                                        EpiArgs{nullptr, nullptr, dattn}, s);
  AFFT_CHECK_LAUNCH();
  layernorm_bwd_rows<T><<<cdiv(M, LN_ROWS), LN_ROWS * 32, 0, s>>>(
      x, dattn, p[TP_LN1G], dy, dx, mu, rstd, M, C, eps);
  AFFT_CHECK_LAUNCH();
  if (gv[TP_LN1G] != nullptr) {
    launch_ln_colsum<T>(dattn, x, mu, rstd, partial, gv[TP_LN1G],
                        gv[TP_LN1B], M, C, s);
    AFFT_CHECK_LAUNCH();
  }
  return 0;
}

static Rates rates_of(const int* seeds, const int* thr, const float* inv) {
  Rates r;
  r.seed0 = (unsigned)seeds[0];
  r.seed1 = (unsigned)seeds[1];
  r.block = (unsigned)seeds[2];
  for (int i = 0; i < 3; ++i) {
    r.thr[i] = (unsigned)thr[i];
    r.inv[i] = inv[i];
  }
  return r;
}

}  // namespace afft

// Common arguments: dtype 0 = float32, 1 = bfloat16; params the twelve
// tensors in TrainParam order (host array of device pointers, null for an
// absent one) in that dtype; mask fp32 (N, N) or null; seeds = {seed word 0,
// seed word 1, block index}, thr / inv the three 24-bit keep thresholds and
// 1 / keep scales (host arrays); bufs a host array of device pointers, listed
// at each entry. Each returns the first launch error (cudaError_t), 0 on
// success.

// bufs: tmp (M, C), y32 (M, C) fp32 (unused in fp32), h1 (M, hidden) scratch;
// out (R, N, C), y (M, C), qkv (M, 3C), pre1 (M, hidden) outputs.
extern "C" int afft_block_train_fwd(int dtype, const void* x,
                                    const void* const* params,
                                    const void* mask, const int* seeds,
                                    const int* thr, const float* inv,
                                    void* const* bufs, int R, int N, int C,
                                    int H, int hidden, float eps,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const Rates rt = rates_of(seeds, thr, inv);
  if (dtype == 0) {
    typedef float T;
    return run_fwd<T>((const T*)x, params, m, rt, (T*)bufs[0],
                      (float*)bufs[1], (T*)bufs[2], (T*)bufs[3], (T*)bufs[4],
                      (T*)bufs[5], (T*)bufs[6], R, N, C, H, hidden, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_fwd<T>((const T*)x, params, m, rt, (T*)bufs[0],
                      (float*)bufs[1], (T*)bufs[2], (T*)bufs[3], (T*)bufs[4],
                      (T*)bufs[5], (T*)bufs[6], R, N, C, H, hidden, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bufs: tmp, dh2, h1, dpre1, dg, mu, rstd, partial scratch (run_bwd_mlp);
// dy (M, C) output. grads: fp32 outputs in TrainParam order.
extern "C" int afft_block_train_bwd_mlp(int dtype, const void* y,
                                        const void* dout, const void* pre1,
                                        const void* const* params,
                                        void* const* grads, const int* seeds,
                                        const int* thr, const float* inv,
                                        void* const* bufs, int R, int N,
                                        int C, int hidden, float eps,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rates rt = rates_of(seeds, thr, inv);
  float* const* gv = reinterpret_cast<float* const*>(grads);
  if (dtype == 0) {
    typedef float T;
    return run_bwd_mlp<T>((const T*)y, (const T*)dout, (const T*)pre1, params,
                          gv, rt, (T*)bufs[0], (T*)bufs[1], (T*)bufs[2],
                          (T*)bufs[3], (float*)bufs[4], (float*)bufs[5],
                          (float*)bufs[6], (float*)bufs[7], (T*)bufs[8], R, N,
                          C, hidden, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_bwd_mlp<T>((const T*)y, (const T*)dout, (const T*)pre1, params,
                          gv, rt, (T*)bufs[0], (T*)bufs[1], (T*)bufs[2],
                          (T*)bufs[3], (float*)bufs[4], (float*)bufs[5],
                          (float*)bufs[6], (float*)bufs[7], (T*)bufs[8], R, N,
                          C, hidden, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bufs: tmp, dproj, dqkv, dattn, mu, rstd, partial scratch (run_bwd_attn);
// dx (R, N, C) output.
extern "C" int afft_block_train_bwd_attn(int dtype, const void* x,
                                         const void* dy, const void* qkv,
                                         const void* const* params,
                                         void* const* grads, const void* mask,
                                         const int* seeds, const int* thr,
                                         const float* inv, void* const* bufs,
                                         int R, int N, int C, int H,
                                         float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const Rates rt = rates_of(seeds, thr, inv);
  float* const* gv = reinterpret_cast<float* const*>(grads);
  if (dtype == 0) {
    typedef float T;
    return run_bwd_attn<T>((const T*)x, (const T*)dy, (const T*)qkv, params,
                           gv, m, rt, (T*)bufs[0], (T*)bufs[1], (T*)bufs[2],
                           (float*)bufs[3], (float*)bufs[4], (float*)bufs[5],
                           (float*)bufs[6], (T*)bufs[7], R, N, C, H, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_bwd_attn<T>((const T*)x, (const T*)dy, (const T*)qkv, params,
                           gv, m, rt, (T*)bufs[0], (T*)bufs[1], (T*)bufs[2],
                           (float*)bufs[3], (float*)bufs[4], (float*)bufs[5],
                           (float*)bufs[6], (T*)bufs[7], R, N, C, H, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The five masks of one block, each already scaled by 1 / keep, fp32:
// bufs = attention (R, H, N, N), proj (R * N, C), drop-path 1 (R), MLP
// (R * N, C), drop-path 2 (R).
extern "C" int afft_draw_masks(const int* seeds, const int* thr,
                               const float* inv, void* const* bufs, int R,
                               int N, int C, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rates rt = rates_of(seeds, thr, inv);
  const size_t sizes[5] = {(size_t)R * H * N * N, (size_t)R * N * C,
                           (size_t)R, (size_t)R * N * C, (size_t)R};
  for (int site = 0; site < 5; ++site) {
    if (sizes[site] == 0) continue;
    fill_mask<<<ew_blocks(sizes[site]), 256, 0, s>>>(
        static_cast<float*>(bufs[site]), sizes[site], site_of(rt, site));
    AFFT_CHECK_LAUNCH();
  }
  return 0;
}
