// afft_gemm: one bf16 GEMM C = A . W (+ epilogue) with W the (K, N) Conv1D
// operand, on the wgmma / TMA GEMM of gemm_sm90.cuh, for the GEMM's own
// checks and timings (ops/gemm.py). No model path calls it: the entries
// reach the GEMM from inside their own launch sequences.
//
// The epilogues are those of the GPT-2 entries: EPI_BIAS, EPI_BIAS_RES,
// EPI_RES_DROP (dropout at the proj site and drop-path, the training
// forward's, drawn from the same seeds / thresholds as the training
// entries; out2 optional) and EPI_PRE_GELU_TANH (out2 the stash).

#include "gemm_sm90.cuh"
#include "train_block.cuh"

using namespace afft;

// seeds = {seed word 0, seed word 1, block index}; thr / inv as the training
// entries' (index 1: the element dropout, 2: drop-path over rows / tokens).
extern "C" int afft_gemm(int epi, const void* a, const void* w,
                         const void* bias, const void* res, void* out,
                         void* out2, const int* seeds, const int* thr,
                         const float* inv, int M, int N, int K, int tokens,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rates rt = rates_of(seeds, thr, inv);
  const EpiArgs ea{bias, res, out, out2, site_of(rt, SITE_PROJ),
                   site_of(rt, SITE_DP1), tokens};
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* W = static_cast<const bf16*>(w);
  switch (epi) {
    case EPI_BIAS:
      return (int)launch_gemm_sm90<EPI_BIAS>(A, W, M, N, K, ea, s);
    case EPI_BIAS_RES:
      return (int)launch_gemm_sm90<EPI_BIAS_RES>(A, W, M, N, K, ea, s);
    case EPI_RES_DROP:
      return (int)launch_gemm_sm90<EPI_RES_DROP>(A, W, M, N, K, ea, s);
    case EPI_PRE_GELU_TANH:
      return (int)launch_gemm_sm90<EPI_PRE_GELU_TANH>(A, W, M, N, K, ea, s);
  }
  return (int)cudaErrorInvalidValue;
}
