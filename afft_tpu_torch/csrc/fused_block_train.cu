// fused_block_train: one pre-LN fuser block in training mode on (R, N, C)
// tokens, with dropout on the attention probabilities, on the proj and MLP
// outputs and per-row drop-path, its two backward halves, and draw_masks.
//
// Replaces the TPU kernels of afft_tpu/ops/pallas_block_train.py:
// fused_block_train (_fwd_kernel, _bwd_mlp_kernel, _bwd_attn_kernel) and
// draw_masks (_masks_kernel). The TPU kernels keep the block's 25 MB of
// weights and, in the backward, up to 32 MB of fp32 weight-gradient
// accumulators in VMEM and walk the rows in a sequential grid. Here each
// entry is a sequence of launches on one stream (train_block.cuh, the fuser
// instance: nn.Linear weights, exact GELU, an fp32 residual stream between
// the halves, fp32 attention probabilities). The cast chain is the TPU
// kernel's (pallas_block_train.py:200-239, :263-300, :325-447).
//
// Bound on an H100 at the flagship shape (R = 4096, N = 5, C = 1024, hidden
// 4096, bf16): the forward does 516 GFLOP, the MLP backward 687 GFLOP and the
// attention backward 344 GFLOP of GEMMs, each against a few hundred MB of
// compulsory traffic, so all three are bound by the tensor cores (0.52, 0.69
// and 0.35 ms at 989 TFLOP/s). The design keeps every product on the tensor
// cores (fp32 accumulation) with its elementwise work in the epilogue, and in
// bf16 every product on the wgmma / TMA GEMM (gemm_sm90.cuh): the forward's
// four reading the (out, in) weight where it lies, as the K-major (N, K)
// operand of gemm_nk (dropout, drop-path, the fp32 residual stream y and
// the stashes of y and pre1 in the epilogues), the backward's dX reading it
// as (K, N), the weight gradients on its TN route (the attention branch's
// dWproj split over four slices of M: its 32 output tiles alone would leave
// most of the 132 SMs idle). The forward attention is
// fuser_attention.cuh's rows kernel with dropout: every element of qkv read
// once, 16 bytes at a time, into shared memory; its bound is bytes (126 MB
// in, 42 MB out at the flagship shape, ~0.05 ms). The attention backward
// (attention_bwd.cuh) recomputes its output bit for bit for dWproj and
// takes dqkv in the same pass (bound by 377 MB, ~0.11 ms).
//
// Limits: any R and N (past 8 tokens the attention's long route,
// long_attention.cuh), H * hd = C (any hd), any hidden, fp32 or bf16; in
// bf16 contiguous, 16-byte aligned operands (the wrapper checks them) and,
// where C or hidden is not a multiple of 8, the pack arena the wrapper sets
// (gemm_sm90.cuh PackArena); norm affines and the qkv bias optional.

#include "train_block.cuh"

using namespace afft;

// Arguments: train_block.cuh (train_fwd, train_bwd_mlp, train_bwd_attn;
// shard: its shard mode, the fuser's MLP columns).
extern "C" int afft_block_train_fwd(int dtype, const void* x,
                                    const void* const* params,
                                    const void* mask, const int* seeds,
                                    const int* thr, const float* inv,
                                    const int* shard, void* const* bufs,
                                    int R, int N, int C, int H, int hidden,
                                    float eps, void* stream) {
  return train_fwd<false>(dtype, x, params, mask, seeds, thr, inv, shard,
                          bufs, R, N, C, H, hidden, eps, stream);
}

extern "C" int afft_block_train_bwd_mlp(int dtype, const void* y,
                                        const void* dout, const void* pre1,
                                        const void* const* params,
                                        void* const* grads, const int* seeds,
                                        const int* thr, const float* inv,
                                        const int* shard, void* const* bufs,
                                        int R, int N, int C, int hidden,
                                        float eps, void* stream) {
  return train_bwd_mlp<false>(dtype, y, dout, pre1, params, grads, seeds, thr,
                              inv, shard, bufs, R, N, C, hidden, eps, stream);
}

extern "C" int afft_block_train_bwd_attn(int dtype, const void* x,
                                         const void* dy, const void* qkv,
                                         const void* const* params,
                                         void* const* grads, const void* mask,
                                         const int* seeds, const int* thr,
                                         const float* inv, const int* shard,
                                         void* const* bufs, int R, int N,
                                         int C, int H, float eps,
                                         void* stream) {
  return train_bwd_attn<false>(dtype, x, dy, qkv, params, grads, mask, seeds,
                               thr, inv, shard, bufs, R, N, C, H, eps,
                               stream);
}

// The five masks of one block, each already scaled by 1 / keep, fp32:
// bufs = attention (R, H, N, N), proj (R * N, C), drop-path 1 (R), MLP
// (R * N, C), drop-path 2 (R); one launch of train_block.cuh's mask kernel.
extern "C" int afft_draw_masks(const int* seeds, const int* thr,
                               const float* inv, void* const* bufs, int R,
                               int N, int C, int H, void* stream) {
  const size_t n[5] = {(size_t)R * H * N * N, (size_t)R * N * C, (size_t)R,
                       (size_t)R * N * C, (size_t)R};
  const int sites[5] = {SITE_ATTN, SITE_PROJ, SITE_DP1, SITE_MLP, SITE_DP2};
  return fill_masks(rates_of(seeds, thr, inv, N, C, H), bufs, n, sites, 5,
                    static_cast<cudaStream_t>(stream));
}

// One site's mask through the same kernel, from every field of its DropSite
// (the checks' entry: the tensor-parallel span / gap remap and any base):
// seeds = {seed0, seed1, block, site}; out (n,) fp32.
extern "C" int afft_draw_mask_site(const int* seeds, int thr, float inv,
                                   long long base, long long span,
                                   long long gap, void* out, long long n,
                                   void* stream) {
  if (n < 0 || base < 0 || span < 0 || gap < 0)
    return (int)cudaErrorInvalidValue;
  const DropSite d{(unsigned)seeds[0], (unsigned)seeds[1],
                   (unsigned)seeds[2], (unsigned)seeds[3], (unsigned)thr,
                   inv, (unsigned long long)base, (unsigned long long)span,
                   (unsigned long long)gap};
  void* bufs[1] = {out};
  const size_t sizes[1] = {(size_t)n};
  return fill_masks(Rates{}, bufs, sizes, nullptr, 1,
                    static_cast<cudaStream_t>(stream), &d);
}

// The backward entries' drop pass alone (train_block.cuh drop_grad): out =
// (d * drop-path multiplier of its row) * dropout multiplier, rounded to
// the dtype, over (R * N, C) elements; ``branch`` 0 the attention branch
// (the proj and drop-path 1 sites), 1 the MLP branch (MLP, drop-path 2);
// seeds, thr, inv as the training entries'.
extern "C" int afft_drop_grad(int dtype, const void* d, void* out,
                              const int* seeds, const int* thr,
                              const float* inv, int R, int N, int C,
                              int branch, void* stream) {
  if (R < 0 || N < 1 || C < 1 || (branch != 0 && branch != 1))
    return (int)cudaErrorInvalidValue;
  const Rates rt = rates_of(seeds, thr, inv, N, C, 0);
  const DropSite drop = site_of(rt, branch ? SITE_MLP : SITE_PROJ);
  const DropSite row = site_of(rt, branch ? SITE_DP2 : SITE_DP1);
  const size_t n = (size_t)R * N * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_drop_grad<float>(static_cast<const float*>(d),
                                        static_cast<float*>(out), n, C, N,
                                        drop, row, s);
  if (dtype == 1)
    return (int)launch_drop_grad<bf16>(static_cast<const bf16*>(d),
                                       static_cast<bf16*>(out), n, C, N, drop,
                                       row, s);
  return (int)cudaErrorInvalidValue;
}
