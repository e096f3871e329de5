// fused_gpt2: one GPT-2 pre-LN layer of the future predictor on (B, T, C),
// as two entry points (the attention half and the MLP half).
//
// Replaces the TPU kernels afft_tpu/ops/pallas_gpt2.py:fused_gpt2_block
// (_attn_half_kernel and _mlp_half_kernel), which keep 34 MB / 67 MB of bf16
// weights per half resident in VMEM. Here each half is a short sequence of
// launches on one stream:
//   attention half: LN1 -> c_attn GEMM (+bias, rounded to the input dtype)
//     -> causal attention per (sample, head) (fp32 scores and softmax, the
//     probabilities rounded to the input dtype before P . V, as
//     pallas_gpt2.py:129-131) -> c_proj GEMM (+bias, + x, written in the
//     input dtype);
//   MLP half: LN2 -> c_fc GEMM (+bias, gelu_new in fp32, rounded) ->
//     c_proj GEMM (+bias, + y in fp32, cast).
// The weights are read in the HF Conv1D layout, (in, out) row-major with
// c_attn packed [q | k | v] (heads minor): the "KN" GEMM operand, so no
// repack happens, at load time or per call.
//
// Bound on an H100 at the flagship shape (B = 256, T = 16, C = 2048, 4 heads
// of 512, hidden 8192, bf16): the attention half does ~138 GFLOP against
// ~67 MB, the MLP half ~275 GFLOP against ~100 MB, both bound by the tensor
// cores (~0.14 ms and ~0.28 ms at 989 TFLOP/s). In bf16 every GEMM of both
// halves runs on the wgmma / TMA GEMM (gemm_sm90.cuh: c_fc with the gelu_new
// epilogue, the c_projs with the residual), and the causal attention is
// staged through shared memory (staged_attention.cuh) up to 32 tokens, past
// that on the long route (long_attention.cuh). In fp32 every product is
// gemm_f32 (true fp32, for the parity checks).
//
// Limits: any B and T (past 32 tokens the long route), H * hd = C (any
// hd), any hidden, fp32 or bf16; in bf16, where C or hidden is not a
// multiple of 8, the pack arena the wrapper sets (gemm_sm90.cuh
// PackArena).

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "long_attention.cuh"
#include "staged_attention.cuh"

using namespace afft;

template <typename T>
static int run_attn_half(const T* x, const T* ln1g, const T* ln1b,
                         const T* wqkv, const T* bqkv, const T* wproj,
                         const T* bproj, const float* mask, T* tmp, T* qkv,
                         T* out, int B, int Tn, int C, int H, float eps,
                         cudaStream_t s) {
  const int M = B * Tn;
  launch_layernorm<T, T>(x, ln1g, ln1b, tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK((gemm_kn<EPI_BIAS, T>(tmp, wqkv, M, 3 * C, C,
                                    EpiArgs{bqkv, nullptr, qkv}, s)));
  if (Tn <= AS_MAX_N) {
    launch_staged_attention<T, false>(qkv, mask, tmp, B, Tn, H, C / H,
                                      DropSite{}, s);
    AFFT_CHECK_LAUNCH();
  } else {  // the long route: the probabilities rounded, as staged's
    AFFT_CHECK((launch_long_attention<T, true, false>(
        packed_long_attn<T>(qkv, mask, tmp, B, Tn, H, C / H, DropSite{}),
        s)));
  }
  AFFT_CHECK((gemm_kn<EPI_BIAS_RES, T>(tmp, wproj, M, C, C,
                                        EpiArgs{bproj, x, out}, s)));
  return 0;
}

template <typename T>
static int run_mlp_half(const T* y, const T* ln2g, const T* ln2b,
                        const T* wfc, const T* bfc, const T* wproj,
                        const T* bproj, T* tmp, T* h, T* out, int M, int C,
                        int hidden, float eps, cudaStream_t s) {
  launch_layernorm<T, T>(y, ln2g, ln2b, tmp, M, C, eps, s);
  AFFT_CHECK_LAUNCH();
  AFFT_CHECK((gemm_kn<EPI_GELU_TANH, T>(tmp, wfc, M, hidden, C,
                                         EpiArgs{bfc, nullptr, h}, s)));
  AFFT_CHECK((gemm_kn<EPI_BIAS_RES, T>(h, wproj, M, C, hidden,
                                        EpiArgs{bproj, y, out}, s)));
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. mask is the fp32 (T, T) additive mask.
// tmp is (B*T, C) and qkv (B*T, 3C) scratch in the working dtype.
extern "C" int afft_gpt2_attn_half(int dtype, const void* x, const void* ln1g,
                                   const void* ln1b, const void* wqkv,
                                   const void* bqkv, const void* wproj,
                                   const void* bproj, const void* mask,
                                   void* tmp, void* qkv, void* out, int B,
                                   int Tn, int C, int H, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0) {
    typedef float T;
    return run_attn_half<T>((const T*)x, (const T*)ln1g, (const T*)ln1b,
                            (const T*)wqkv, (const T*)bqkv, (const T*)wproj,
                            (const T*)bproj, m, (T*)tmp, (T*)qkv, (T*)out, B,
                            Tn, C, H, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_attn_half<T>((const T*)x, (const T*)ln1g, (const T*)ln1b,
                            (const T*)wqkv, (const T*)bqkv, (const T*)wproj,
                            (const T*)bproj, m, (T*)tmp, (T*)qkv, (T*)out, B,
                            Tn, C, H, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// tmp is (M, C) and h (M, hidden) scratch in the working dtype.
extern "C" int afft_gpt2_mlp_half(int dtype, const void* y, const void* ln2g,
                                  const void* ln2b, const void* wfc,
                                  const void* bfc, const void* wproj,
                                  const void* bproj, void* tmp, void* h,
                                  void* out, int M, int C, int hidden,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    typedef float T;
    return run_mlp_half<T>((const T*)y, (const T*)ln2g, (const T*)ln2b,
                           (const T*)wfc, (const T*)bfc, (const T*)wproj,
                           (const T*)bproj, (T*)tmp, (T*)h, (T*)out, M, C,
                           hidden, eps, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return run_mlp_half<T>((const T*)y, (const T*)ln2g, (const T*)ln2b,
                           (const T*)wfc, (const T*)bfc, (const T*)wproj,
                           (const T*)bproj, (T*)tmp, (T*)h, (T*)out, M, C,
                           hidden, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
