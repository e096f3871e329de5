// afft_gemm / afft_gemm_tn: one bf16 GEMM on the wgmma / TMA GEMM of
// gemm_sm90.cuh, for the GEMM's own checks and timings (ops/gemm.py). No
// model path calls them: the entries reach the GEMM from inside their own
// launch sequences.
//
// afft_gemm: C = A . W (+ epilogue) under the epilogues the entries use.
// With W the (K, N) operand: EPI_BIAS (bf16 out, or fp32 with out_f32: the
// fuser's backward dX), EPI_BIAS_RES, EPI_GELU_TANH (the serving MLP half's
// c_fc), EPI_RES_DROP (dropout at the proj site and drop-path, the training
// forward's, drawn from the same seeds / thresholds as the training
// entries; out2 optional), EPI_PRE_GELU_TANH (out2 the stash) and
// EPI_GELU_BWD (res the stashed pre-activation: the fuser's dpre1). With
// w_nk, W the (N, K) operand (the K-major B route): the fuser blocks'
// serving forward, EPI_BIAS (qkv), EPI_GELU_ERF (fc1) and EPI_BIAS_RES;
// the fuser's training forward, EPI_PRE_GELU (fc1, out2 the stash) and
// EPI_RES_DROP (out2 optional); the GPT-2 layer's backward dX,
// EPI_GELU_TANH_BWD (dpre1)
// and EPI_BIAS with an fp32 out (dg, dattn, dxn). EPI_BIAS_RES takes a
// bf16 residual and out, and both take a bf16 residual and an fp32 out
// (proj into the residual stream y) or an fp32 residual (res_f32) and a
// bf16 out (fc2 adding y); EPI_BIAS_RES also an fp32 residual and an fp32
// out, which may be the residual itself (the decoder block's cross proj,
// y += cross . Wcproj^T + b).
// afft_gemm_tn: the weight gradient out (I, J) fp32 = A^T . B over M rows,
// over ``slices`` slices of M (0: as many as tn_slices gives; scratch holds
// slices * I * J fp32 when there are more than one); afft_gemm_tn_slices:
// that count.
// afft_set_pack: the pack arena of the calling thread (gemm_sm90.cuh
// PackArena), which every entry's bf16 products take their operands' packs
// from; the wrappers set it around an entry's launch and clear it after.
// afft_pack_rows: the pack kernel alone, dst (rows, pad8(cols)) <- src
// (rows, cols) for a 16-byte aligned dst.

#include "gemm_sm90.cuh"
#include "train_block.cuh"

using namespace afft;

// seeds = {seed word 0, seed word 1, block index, first global row}; thr /
// inv as the training entries' (index 1: the element dropout, 2: drop-path
// over rows / tokens; a drop-path row is ``tokens`` rows of N elements).
extern "C" int afft_gemm(int epi, int out_f32, int w_nk, int res_f32,
                         const void* a, const void* w,
                         const void* bias, const void* res, void* out,
                         void* out2, const int* seeds, const int* thr,
                         const float* inv, int M, int N, int K, int tokens,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rates rt = rates_of(seeds, thr, inv, tokens, N, 0);
  const EpiArgs ea{bias, res, out, out2, site_of(rt, SITE_PROJ),
                   site_of(rt, SITE_DP1), tokens};
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* W = static_cast<const bf16*>(w);
  if (w_nk) {
    if (epi == EPI_BIAS_RES) {
      if (res_f32)
        return out_f32
                   ? (int)launch_gemm_sm90<EPI_BIAS_RES, float, true, float>(
                         A, W, M, N, K, ea, s)
                   : (int)launch_gemm_sm90<EPI_BIAS_RES, bf16, true, float>(
                         A, W, M, N, K, ea, s);
      return out_f32 ? (int)launch_gemm_sm90<EPI_BIAS_RES, float, true>(
                           A, W, M, N, K, ea, s)
                     : (int)launch_gemm_sm90<EPI_BIAS_RES, bf16, true>(
                           A, W, M, N, K, ea, s);
    }
    if (res_f32 && out_f32) return (int)cudaErrorInvalidValue;
    if (epi == EPI_RES_DROP) {
      if (res_f32)
        return (int)launch_gemm_sm90<EPI_RES_DROP, bf16, true, float>(
            A, W, M, N, K, ea, s);
      return out_f32 ? (int)launch_gemm_sm90<EPI_RES_DROP, float, true>(
                           A, W, M, N, K, ea, s)
                     : (int)cudaErrorInvalidValue;
    }
    if (res_f32) return (int)cudaErrorInvalidValue;
    if (epi == EPI_BIAS)
      return out_f32 ? (int)launch_gemm_sm90<EPI_BIAS, float, true>(
                           A, W, M, N, K, ea, s)
                     : (int)launch_gemm_sm90<EPI_BIAS, bf16, true>(
                           A, W, M, N, K, ea, s);
    if (out_f32) return (int)cudaErrorInvalidValue;
    switch (epi) {
      case EPI_GELU_ERF:
        return (int)launch_gemm_sm90<EPI_GELU_ERF, bf16, true>(A, W, M, N, K,
                                                              ea, s);
      case EPI_PRE_GELU:
        return (int)launch_gemm_sm90<EPI_PRE_GELU, bf16, true>(A, W, M, N, K,
                                                              ea, s);
      case EPI_GELU_TANH_BWD:
        return (int)launch_gemm_sm90<EPI_GELU_TANH_BWD, bf16, true>(
            A, W, M, N, K, ea, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (res_f32) return (int)cudaErrorInvalidValue;
  if (out_f32)
    return epi == EPI_BIAS
               ? (int)launch_gemm_sm90<EPI_BIAS, float>(A, W, M, N, K, ea, s)
               : (int)cudaErrorInvalidValue;
  switch (epi) {
    case EPI_BIAS:
      return (int)launch_gemm_sm90<EPI_BIAS>(A, W, M, N, K, ea, s);
    case EPI_BIAS_RES:
      return (int)launch_gemm_sm90<EPI_BIAS_RES>(A, W, M, N, K, ea, s);
    case EPI_GELU_TANH:
      return (int)launch_gemm_sm90<EPI_GELU_TANH>(A, W, M, N, K, ea, s);
    case EPI_RES_DROP:
      return (int)launch_gemm_sm90<EPI_RES_DROP>(A, W, M, N, K, ea, s);
    case EPI_PRE_GELU_TANH:
      return (int)launch_gemm_sm90<EPI_PRE_GELU_TANH>(A, W, M, N, K, ea, s);
    case EPI_GELU_BWD:
      return (int)launch_gemm_sm90<EPI_GELU_BWD>(A, W, M, N, K, ea, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int afft_gemm_tn(const void* a, const void* b, void* out,
                            void* scratch, int I, int J, int M, int slices,
                            void* stream) {
  return (int)launch_gemm_tn_sm90(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(out), I, J, M, static_cast<cudaStream_t>(stream),
      slices > 0 ? slices : tn_slices(I, J, M), static_cast<float*>(scratch));
}

extern "C" int afft_gemm_tn_slices(int I, int J, int M) {
  return tn_slices(I, J, M);
}

extern "C" int afft_pack_rows(const void* src, void* dst, int rows, int cols,
                              void* stream) {
  if (rows < 1 || cols < 1 || (uintptr_t)dst % 16)
    return (int)cudaErrorInvalidValue;
  launch_pack_rows(static_cast<const bf16*>(src), static_cast<bf16*>(dst),
                   rows, cols, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Sets the calling thread's pack arena to buf (cap bf16 elements; null:
// none) and returns the pack_rows launches made under the one it replaces.
extern "C" long long afft_set_pack(void* buf, long long cap) {
  const long long n = pack_arena.launches;
  pack_arena = PackArena{static_cast<bf16*>(buf), (size_t)cap, 0};
  return n;
}
