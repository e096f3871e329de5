// fused_seq_block and fused_decoder_block: the blocks of the temporal fusers
// on (B, S, C) sequences.
//
// Replace the TPU kernels afft_tpu/ops/pallas_seq_block.py:fused_seq_block
// (_seq_block_kernel, the T-SA-Fuser's pre-LN Block over S = modalities *
// frames tokens) and :fused_decoder_block (_decoder_block_kernel, the
// CA-Fuser's DecoderBlock: causal self-attention, cross-attention into an
// equal-length memory stream, MLP). On the TPU each is one pallas_call with
// the block's 25-32 MB of bf16 weights resident in VMEM; an SM has 227 KB of
// shared memory, so here each is a sequence of launches on one stream, built
// from common.cuh:
//   seq block (7 launches): LN1 -> qkv GEMM (+bias, rounded) -> attention over
//     S tokens with the (S, S) mask -> proj GEMM (+bias, + x, into fp32 y) ->
//     LN2 on fp32 y -> fc1 GEMM (+bias, exact-erf GELU, rounded) -> fc2 GEMM
//     (+bias, + y, cast);
//   decoder block (14 launches): LN_self -> qkv GEMM -> attention -> proj GEMM
//     (+ x, into fp32 y) -> LN_q on y, LN_kv on the memory stream -> w_q, w_k,
//     w_v GEMMs (+bias, rounded) -> attention with the same mask -> cross proj
//     GEMM (+ y, in place, fp32) -> LN_mlp -> fc1 GEMM (GELU) -> fc2 GEMM
//     (+ y, cast).
// The cast chain is the TPU kernels' (pallas_seq_block.py:75-101, :135-190):
// LN statistics, softmax and the residual stream (x32, y, x1, x2) are fp32
// from the block's input to its last add; LN outputs, q / k / v, the softmax
// probabilities (before P . V), the attention outputs and the GELU output are
// rounded to the input dtype; matmuls accumulate in fp32.
//
// Bound on an H100 in bf16 at B = 256, C = 1024, 4 heads, hidden 4096: the seq
// block at S = 40 does 2 * 10240 * 1024 * 12288 + 4 * 256 * 40 * 40 * 1024 =
// ~259 GFLOP against ~67 MB, the decoder block at S = 10 ~86 GFLOP against
// ~49 MB: both bound by the tensor cores (~0.26 and ~0.09 ms at 989 TFLOP/s).
// The GEMMs run on the tensor cores with bias, activation, residual and cast
// fused into their epilogues; the attention stages are a small share of the
// work and run on the CUDA cores (strided_attention, one warp per query). The
// decoder block at S = 10 is 14 short launches over 2,560 rows, so launch
// latency and partly filled GEMM tiles weigh on it.
//
// Limits: any B, 1 <= S <= 1024, H * hd = C with hd % 8 == 0, hidden % 8 == 0,
// fp32 or bf16; every LayerNorm affine and the qkv / w_q / w_k / w_v biases are
// optional (null pointers); the decoder's memory stream has x's shape.

#include "common.cuh"

using namespace afft;

// Parameter slots of afft_fused_seq_block (nn.Linear weights, (out, in)).
enum SeqParam {
  SP_LN1G, SP_LN1B, SP_WQKV, SP_BQKV, SP_WPROJ, SP_BPROJ, SP_LN2G, SP_LN2B,
  SP_WFC1, SP_BFC1, SP_WFC2, SP_BFC2
};

// Parameter slots of afft_fused_decoder_block.
enum DecParam {
  DP_LNSG, DP_LNSB, DP_WQKV, DP_BQKV, DP_WSPROJ, DP_BSPROJ, DP_LNQG, DP_LNQB,
  DP_LNKG, DP_LNKB, DP_WQ, DP_BQ, DP_WK, DP_BK, DP_WV, DP_BV, DP_WCPROJ,
  DP_BCPROJ, DP_LNMG, DP_LNMB, DP_WFC1, DP_BFC1, DP_WFC2, DP_BFC2
};

// LN -> fc1 (GELU) -> fc2 (+ fp32 residual y, cast): the MLP stage of both.
template <typename T>
static int run_mlp_stage(const float* y, const T* lng, const T* lnb,
                         const T* wfc1, const T* bfc1, const T* wfc2,
                         const T* bfc2, T* tmp, T* h1, T* out, int M, int C,
                         int hidden, float eps, cudaStream_t s) {
  launch_layernorm<float, T>(y, lng, lnb, tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_GELU_ERF, false, T, T>(tmp, wfc1, M, hidden, C,
                                         EpiArgs{bfc1, nullptr, h1}, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_BIAS_RES, false, float, T>(h1, wfc2, M, C, hidden,
                                             EpiArgs{bfc2, y, out}, s);
  AFFT_CHECK_LAUNCH();
  return 0;
}

// LN -> qkv -> attention -> proj (+ x, into fp32 y): the self-attention stage.
template <typename T>
static int run_self_attn_stage(const T* x, const T* lng, const T* lnb,
                               const T* wqkv, const T* bqkv, const T* wproj,
                               const T* bproj, const float* mask, T* tmp,
                               T* qkv, float* y, int B, int S, int C, int H,
                               float eps, cudaStream_t s) {
  const int M = B * S;
  launch_layernorm<T, T>(x, lng, lnb, tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_BIAS, false, T, T>(tmp, wqkv, M, 3 * C, C,
                                     EpiArgs{bqkv, nullptr, qkv}, s);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK(launch_packed_attention<T>(qkv, mask, tmp, B, S, H, C / H, s));
  launch_gemm<EPI_BIAS_RES, false, T, float>(tmp, wproj, M, C, C,
                                             EpiArgs{bproj, x, y}, s);
  AFFT_CHECK_LAUNCH();
  return 0;
}

template <typename T>
static int run_seq_block(const T* x, const void* const* pv, const float* mask,
                         T* tmp, T* qkv, float* y, T* h1, T* out, int B,
                         int S, int C, int H, int hidden, float eps,
                         cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  int err = run_self_attn_stage<T>(x, p[SP_LN1G], p[SP_LN1B], p[SP_WQKV],
                                   p[SP_BQKV], p[SP_WPROJ], p[SP_BPROJ], mask,
                                   tmp, qkv, y, B, S, C, H, eps, s);
  if (err != 0) return err;
  return run_mlp_stage<T>(y, p[SP_LN2G], p[SP_LN2B], p[SP_WFC1], p[SP_BFC1],
                          p[SP_WFC2], p[SP_BFC2], tmp, h1, out, B * S, C,
                          hidden, eps, s);
}

template <typename T>
static int run_decoder_block(const T* x, const T* mem, const void* const* pv,
                             const float* mask, T* tmp, T* tmp2, T* qkv,
                             float* y, T* h1, T* out, int B, int S, int C,
                             int H, int hidden, float eps, cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  const int M = B * S;
  int err = run_self_attn_stage<T>(x, p[DP_LNSG], p[DP_LNSB], p[DP_WQKV],
                                   p[DP_BQKV], p[DP_WSPROJ], p[DP_BSPROJ],
                                   mask, tmp, qkv, y, B, S, C, H, eps, s);
  if (err != 0) return err;
  // cross-attention: q from the residual stream, k and v from the memory
  // stream (normalised from its fp32 upcast); q, k, v are three (M, C)
  // buffers inside the qkv scratch
  T* qb = qkv;
  T* kb = qkv + (size_t)M * C;
  T* vb = qkv + 2 * (size_t)M * C;
  launch_layernorm<float, T>(y, p[DP_LNQG], p[DP_LNQB], tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  launch_layernorm<T, T>(mem, p[DP_LNKG], p[DP_LNKB], tmp2, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_BIAS, false, T, T>(tmp, p[DP_WQ], M, C, C,
                                     EpiArgs{p[DP_BQ], nullptr, qb}, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_BIAS, false, T, T>(tmp2, p[DP_WK], M, C, C,
                                     EpiArgs{p[DP_BK], nullptr, kb}, s);
  AFFT_CHECK_LAUNCH();
  launch_gemm<EPI_BIAS, false, T, T>(tmp2, p[DP_WV], M, C, C,
                                     EpiArgs{p[DP_BV], nullptr, vb}, s);
  AFFT_CHECK_LAUNCH();
  const int hd = C / H;
  const AttnStrides st{(long long)S * C, C, hd};
  AFFT_CHECK(launch_strided_attention<T>(qb, kb, vb, mask, tmp, B, S, S, H,
                                         hd, st, st, st, s));
  // x2 = x1 + proj(cross), in place: each element of y is read and then
  // written by the same thread of the epilogue
  launch_gemm<EPI_BIAS_RES, false, float, float>(
      tmp, p[DP_WCPROJ], M, C, C, EpiArgs{p[DP_BCPROJ], y, y}, s);
  AFFT_CHECK_LAUNCH();
  return run_mlp_stage<T>(y, p[DP_LNMG], p[DP_LNMB], p[DP_WFC1], p[DP_BFC1],
                          p[DP_WFC2], p[DP_BFC2], tmp, h1, out, M, C, hidden,
                          eps, s);
}

// dtype: 0 = float32, 1 = bfloat16. x, out (B, S, C), the scratch tmp (B*S, C),
// qkv (B*S, 3C), h1 (B*S, hidden) and every entry of params (SeqParam order,
// host array of device pointers, null for an absent tensor) are in that
// dtype; mask is fp32 (S, S) or null; y is fp32 (B*S, C) scratch.
// Returns the first launch error (cudaError_t), 0 on success.
extern "C" int afft_fused_seq_block(int dtype, const void* x,
                                    const void* const* params,
                                    const void* mask, void* tmp, void* qkv,
                                    void* y, void* h1, void* out, int B,
                                    int S, int C, int H, int hidden,
                                    float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* yf = static_cast<float*>(y);
  if (dtype == 0) {
    typedef float T;
    return run_seq_block<T>((const T*)x, params, m, (T*)tmp, (T*)qkv, yf,
                            (T*)h1, (T*)out, B, S, C, H, hidden, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_seq_block<T>((const T*)x, params, m, (T*)tmp, (T*)qkv, yf,
                            (T*)h1, (T*)out, B, S, C, H, hidden, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// As above, with the memory stream mem (B, S, C), params in DecParam order and
// a second (B*S, C) scratch tmp2.
extern "C" int afft_fused_decoder_block(int dtype, const void* x,
                                        const void* mem,
                                        const void* const* params,
                                        const void* mask, void* tmp,
                                        void* tmp2, void* qkv, void* y,
                                        void* h1, void* out, int B, int S,
                                        int C, int H, int hidden, float eps,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* yf = static_cast<float*>(y);
  if (dtype == 0) {
    typedef float T;
    return run_decoder_block<T>((const T*)x, (const T*)mem, params, m,
                                (T*)tmp, (T*)tmp2, (T*)qkv, yf, (T*)h1,
                                (T*)out, B, S, C, H, hidden, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_decoder_block<T>((const T*)x, (const T*)mem, params, m,
                                (T*)tmp, (T*)tmp2, (T*)qkv, yf, (T*)h1,
                                (T*)out, B, S, C, H, hidden, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
