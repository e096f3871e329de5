// fused_attention: softmax(q . k^T * hd^-0.5 + mask) . v for q (B, Nq, H, hd)
// and k, v (B, Nk, H, hd); the (B, H, Nq, Nk) weights are never written.
//
// Replaces the TPU kernel afft_tpu/ops/pallas_attn.py:fused_attention
// (_attn_kernel), which tiles the batch and keeps q . k^T, the softmax and the
// value contraction of one tile in VMEM. Here it is one launch of
// strided_attention (common.cuh): one block per (sequence, head, group of 8
// queries), one warp per query, the query's Nk scores in shared memory.
// The cast chain is the TPU kernel's (pallas_attn.py:54-70): fp32 scores and
// softmax, the scale applied after the dot, the probabilities divided in fp32
// and rounded to the input dtype before the probability . v product, fp32
// accumulation, output in q's dtype.
//
// Bound on an H100: the sequences are short, so the function is bound by
// bytes, not operations. The KV-cache rollout of the flagship (B = 256, H = 4,
// hd = 512, bf16) reads q, k, v once and writes out once: 2 * B * Nq * C +
// 2 * B * Nk * C elements, ~73 MB at prefill (Nq 16, Nk 19) and ~42 MB for a
// decode step (Nq 1), ~0.022 and ~0.013 ms at 3.35 TB/s. The design reads
// q, k and v where they lie (token, sequence and head strides), so the column
// slices of a packed c_attn output and the (B, Tmax, H, hd) caches are not
// copied first, and skips masked keys, so a causal prefill does half the
// products and unwritten cache slots are never read. K and V rows are re-read
// by every query of a sequence through L1/L2 rather than staged in shared
// memory; that and the 2-byte loads are what a faster version would change.
//
// Limits: any B, Nq >= 1, 1 <= Nk <= 1024, any H and hd with unit stride along
// hd, fp32 or bf16, optional fp32 (Nq, Nk) additive mask.

#include "common.cuh"

using namespace afft;

// dtype: 0 = float32, 1 = bfloat16. q, k, v are device pointers in that dtype
// with the element strides (sequence, token, head) given; out is contiguous
// (B, Nq, H, hd); mask is fp32 (Nq, Nk) or null.
// Returns the launch error (cudaError_t), 0 on success.
extern "C" int afft_fused_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int B, int Nq, int Nk, int H,
                                    int hd, long long q_b, long long q_t,
                                    long long q_h, long long k_b,
                                    long long k_t, long long k_h,
                                    long long v_b, long long v_t,
                                    long long v_h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const AttnStrides qs{q_b, q_t, q_h}, ks{k_b, k_t, k_h}, vs{v_b, v_t, v_h};
  if (dtype == 0) {
    typedef float T;
    return (int)launch_strided_attention<T>((const T*)q, (const T*)k,
                                            (const T*)v, m, (T*)out, B, Nq,
                                            Nk, H, hd, qs, ks, vs, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return (int)launch_strided_attention<T>((const T*)q, (const T*)k,
                                            (const T*)v, m, (T*)out, B, Nq,
                                            Nk, H, hd, qs, ks, vs, s);
  }
  return (int)cudaErrorInvalidValue;
}
