// fused_gpt2_train: one GPT-2 pre-LN layer of the future predictor in
// training mode on (B, T, C), with dropout on the attention probabilities
// (attn_pdrop) and on both residual branches (resid_pdrop), its two backward
// halves, and draw_masks_gpt2.
//
// Replaces the TPU kernels of afft_tpu/ops/pallas_gpt2_train.py:
// fused_gpt2_block_train (_attn_half_train_kernel and _mlp_half_train_kernel
// -> afft_gpt2_train_fwd; _mlp_bwd1_kernel and _mlp_bwd2_kernel ->
// afft_gpt2_train_bwd_mlp; _attn_bwd_kernel -> afft_gpt2_train_bwd_attn) and
// draw_masks_gpt2 (_masks_gpt2_kernel -> afft_draw_masks_gpt2). The TPU
// splits the MLP backward in two only to keep one C x 8192 weight resident
// in VMEM, and leaves the eight weight and bias gradients to XLA outside its
// kernels; here each entry is one sequence of launches on one stream
// (train_block.cuh, the GPT-2 instance: HF Conv1D (in, out) weights read as
// they are stored, gelu_new, y rounded to the working dtype between the
// halves, the attention's dropped probabilities and its backward's
// cotangents rounded), and the weight and bias gradients are computed inside
// the entries by the port's TN GEMM and column sums. The cast chain
// is the TPU kernels' (pallas_gpt2_train.py:84-150, :167-308, :505-528).
//
// Masks: Philox4x32-10 of (seed words, layer index, site, element index) at
// the TPU kernel's sites (0 attention, 1 proj, 3 MLP), drawn in registers;
// attention element ((b * H + h) * T + tq) * T + tk, proj and MLP
// (b * T + t) * C + c. Unlike the TPU kernel's (M, 128) lane packing of
// (head, key), nothing limits H * T.
//
// Bound on an H100 at the flagship shape (B = 256, T = 16, C = 2048, 4 heads
// of 512, hidden 8192, bf16): the forward does 413 GFLOP, the MLP backward 550
// GFLOP and the attention backward 275 GFLOP of GEMMs against a few hundred MB
// of compulsory traffic, so all three are bound by the tensor cores (0.42,
// 0.56 and 0.28 ms at 989 TFLOP/s). In bf16 every product runs on the wgmma
// / TMA GEMM (gemm_sm90.cuh): the forward's four reading the Conv1D weight
// as (K, N), the backward's dX (dpre1 with the gelu_new derivative of the
// stashed pre1 in its epilogue, dg, dattn, dxn with fp32 outs) reading it as
// (N, K) on the K-major B route gemm_nk, the weight gradients on its TN
// route (one slice over M at these shapes). The forward attention is staged
// through shared memory (staged_attention.cuh); the attention backward
// (attention_bwd.cuh, ROUND) recomputes its output for dWproj and takes dqkv
// in the same pass.
//
// Limits: any B and T (past 32 tokens the attention's long route,
// long_attention.cuh), H * hd = C (any hd), any hidden, fp32 or bf16; in
// bf16 contiguous, 16-byte aligned operands (the wrapper checks them) and,
// where C or hidden is not a multiple of 8, the pack arena the wrapper sets
// (gemm_sm90.cuh PackArena).

#include "train_block.cuh"

using namespace afft;

// Arguments: train_block.cuh (train_fwd, train_bwd_mlp, train_bwd_attn;
// shard: its shard mode, the layer's heads and MLP columns), with R = B
// samples of N = T tokens.
extern "C" int afft_gpt2_train_fwd(int dtype, const void* x,
                                   const void* const* params,
                                   const void* mask, const int* seeds,
                                   const int* thr, const float* inv,
                                   const int* shard, void* const* bufs,
                                   int B, int T, int C, int H, int hidden,
                                   float eps, void* stream) {
  return train_fwd<true>(dtype, x, params, mask, seeds, thr, inv, shard,
                         bufs, B, T, C, H, hidden, eps, stream);
}

extern "C" int afft_gpt2_train_bwd_mlp(int dtype, const void* y,
                                       const void* dout, const void* pre1,
                                       const void* const* params,
                                       void* const* grads, const int* seeds,
                                       const int* thr, const float* inv,
                                       const int* shard, void* const* bufs,
                                       int B, int T, int C, int hidden,
                                       float eps, void* stream) {
  return train_bwd_mlp<true>(dtype, y, dout, pre1, params, grads, seeds, thr,
                             inv, shard, bufs, B, T, C, hidden, eps, stream);
}

extern "C" int afft_gpt2_train_bwd_attn(int dtype, const void* x,
                                        const void* dy, const void* qkv,
                                        const void* const* params,
                                        void* const* grads, const void* mask,
                                        const int* seeds, const int* thr,
                                        const float* inv, const int* shard,
                                        void* const* bufs, int B, int T,
                                        int C, int H, float eps,
                                        void* stream) {
  return train_bwd_attn<true>(dtype, x, dy, qkv, params, grads, mask, seeds,
                              thr, inv, shard, bufs, B, T, C, H, eps, stream);
}

// The three masks of one layer, each already scaled by 1 / keep, fp32:
// bufs = attention (B, H, T, T), proj (B * T, C), MLP (B * T, C); one
// launch of train_block.cuh's mask kernel.
extern "C" int afft_draw_masks_gpt2(const int* seeds, const int* thr,
                                    const float* inv, void* const* bufs,
                                    int B, int T, int C, int H,
                                    void* stream) {
  const size_t n[3] = {(size_t)B * H * T * T, (size_t)B * T * C,
                       (size_t)B * T * C};
  const int sites[3] = {SITE_ATTN, SITE_PROJ, SITE_MLP};
  return fill_masks(rates_of(seeds, thr, inv, T, C, H), bufs, n, sites, 3,
                    static_cast<cudaStream_t>(stream));
}
