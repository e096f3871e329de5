// fused_block: one pre-LN fuser block (SA-Fuser) on (R, N, C) tokens.
//
// Replaces the TPU kernel afft_tpu/ops/pallas_block.py:fused_block
// (_block_kernel), which runs the whole block in one pallas_call with the
// block's 25 MB of bf16 weights resident in VMEM. An SM has 227 KB of shared
// memory, so here the block is a sequence of seven launches on one stream:
//   LN1 -> qkv GEMM (+bias, rounded to the input dtype) -> N-token attention
//   (fp32 scores, softmax and probability . v) -> proj GEMM (+bias, + x, into
//   fp32 y) -> LN2 on fp32 y -> fc1 GEMM (+bias, exact-erf GELU in fp32,
//   rounded) -> fc2 GEMM (+bias, + y, cast to the output dtype).
// The cast chain is the TPU kernel's (pallas_block.py:141-188).
//
// Bound on an H100 at the flagship shape (R = 4096, N = 5, C = 1024, hidden
// 4096, bf16): 2 * 20480 * 1024 * 12288 = 516 GFLOP of GEMMs against ~109 MB
// of compulsory traffic, so it is bound by the tensor cores (~0.52 ms at 989
// TFLOP/s). The design keeps every GEMM on the tensor cores with its
// bias/activation/residual/cast fused into the epilogue, so the elementwise
// work costs no extra pass over memory: in bf16 the wgmma / TMA GEMM of
// gemm_sm90.cuh reading the nn.Linear (out, in) weights where they lie, as
// its K-major B operand (gemm_nk); in fp32 gemm_f32. The attention
// (fuser_attention.cuh fuser_attention_rows) reads each element of qkv once,
// 16 bytes at a time, into shared memory; past 8 tokens it runs on the long
// route (long_attention.cuh, fp32 probabilities). The intermediates (qkv, the MLP
// hidden) do round-trip through HBM/L2, which adds ~0.5 GB of traffic
// (~0.15 ms at 3.35 TB/s) the TPU kernel avoided.
//
// Limits: any R and N (past 8 tokens the long route), H * hd = C (any hd),
// any hidden, fp32 or bf16; in bf16, where C or hidden is not a multiple of
// 8, the pack arena the wrapper sets (gemm_sm90.cuh PackArena); norm affine
// and qkv bias optional (null pointers).

#include "fuser_attention.cuh"
#include "gemm_sm90.cuh"

using namespace afft;

template <typename T>
static int run_fused_block(const T* x, const T* ln1g, const T* ln1b,
                           const T* wqkv, const T* bqkv, const T* wproj,
                           const T* bproj, const T* ln2g, const T* ln2b,
                           const T* wfc1, const T* bfc1, const T* wfc2,
                           const T* bfc2, const float* mask, T* tmp, T* qkv,
                           float* y, T* h1, T* out, int R, int N, int C,
                           int H, int hidden, float eps, cudaStream_t s) {
  const int M = R * N;
  // nn.Linear weights are (out, in): the (N, K) operand of gemm_nk
  launch_layernorm<T, T>(x, ln1g, ln1b, tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK((gemm_nk<EPI_BIAS, T, T, T>(tmp, wqkv, M, 3 * C, C,
                                         EpiArgs{bqkv, nullptr, qkv}, s)));
  if (N <= FR_MAX_N) {
    AFFT_CHECK(launch_fuser_attention_rows<T>(qkv, mask, tmp, R, N, H, C / H,
                                              s));
  } else {  // the long route: fp32 probabilities, as the rows kernel's
    AFFT_CHECK((launch_long_attention<T, false, false>(
        packed_long_attn<T>(qkv, mask, tmp, R, N, H, C / H, DropSite{}), s)));
  }
  AFFT_CHECK((gemm_nk<EPI_BIAS_RES, T, T, float>(tmp, wproj, M, C, C,
                                                 EpiArgs{bproj, x, y}, s)));
  launch_layernorm<float, T>(y, ln2g, ln2b, tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK((gemm_nk<EPI_GELU_ERF, T, T, T>(tmp, wfc1, M, hidden, C,
                                             EpiArgs{bfc1, nullptr, h1}, s)));
  AFFT_CHECK((gemm_nk<EPI_BIAS_RES, T, float, T>(h1, wfc2, M, C, hidden,
                                                 EpiArgs{bfc2, y, out}, s)));
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Every tensor pointer is device memory in
// that dtype except mask (fp32 (N, N), or null) and y (fp32 (R*N, C)
// scratch). tmp is (R*N, C), qkv (R*N, 3C), h1 (R*N, hidden) scratch.
// Returns the first launch error (cudaError_t), 0 on success.
extern "C" int afft_fused_block(int dtype, const void* x, const void* ln1g,
                                const void* ln1b, const void* wqkv,
                                const void* bqkv, const void* wproj,
                                const void* bproj, const void* ln2g,
                                const void* ln2b, const void* wfc1,
                                const void* bfc1, const void* wfc2,
                                const void* bfc2, const void* mask, void* tmp,
                                void* qkv, void* y, void* h1, void* out,
                                int R, int N, int C, int H, int hidden,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* yf = static_cast<float*>(y);
  if (dtype == 0) {
    typedef float T;
    return run_fused_block<T>(
        (const T*)x, (const T*)ln1g, (const T*)ln1b, (const T*)wqkv,
        (const T*)bqkv, (const T*)wproj, (const T*)bproj, (const T*)ln2g,
        (const T*)ln2b, (const T*)wfc1, (const T*)bfc1, (const T*)wfc2,
        (const T*)bfc2, m, (T*)tmp, (T*)qkv, yf, (T*)h1, (T*)out, R, N, C, H,
        hidden, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_fused_block<T>(
        (const T*)x, (const T*)ln1g, (const T*)ln1b, (const T*)wqkv,
        (const T*)bqkv, (const T*)wproj, (const T*)bproj, (const T*)ln2g,
        (const T*)ln2b, (const T*)wfc1, (const T*)bfc1, (const T*)wfc2,
        (const T*)bfc2, m, (T*)tmp, (T*)qkv, yf, (T*)h1, (T*)out, R, N, C, H,
        hidden, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
