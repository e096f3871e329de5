// fused_attention: softmax(q . k^T * hd^-0.5 + mask) . v for q (B, Nq, H, hd)
// and k, v (B, Nk, H, hd); the (B, H, Nq, Nk) weights are never written.
//
// Replaces the TPU kernel afft_tpu/ops/pallas_attn.py:fused_attention
// (_attn_kernel), which tiles the batch and keeps q . k^T, the softmax and the
// value contraction of one tile in VMEM. Here it is one launch of the
// sequence attention of fuser_attention.cuh (fuser_attention_seq), which the
// fuser blocks' self-attention and the decoder block's cross-attention run
// too. The cast chain is the TPU kernel's (pallas_attn.py:54-70): fp32
// scores and softmax, the scale applied after the dot, the probabilities
// divided in fp32 and rounded to the input dtype before the probability . v
// product, fp32 accumulation, output in q's dtype.
//
// Bound on an H100: the sequences are short, so the function is bound by
// bytes, not operations. The KV-cache rollout of the flagship (B = 256, H = 4,
// hd = 512, bf16) reads q once and the k, v rows some query sees once, and
// writes out once: 67 MB at prefill (Nq 16, Nk 19, the last 3 cache slots
// unwritten) and 38 MB for a decode step (Nq 1), 0.020 and 0.011 ms at 3.35
// TB/s. The design reads q, k and v where they lie (sequence, token and head
// strides), so the column slices of a packed c_attn output and the (B, Tmax,
// H, hd) caches are not copied first. In bf16 a block takes one (sequence,
// head) and up to 16 queries (every query of the rollout): it reads the
// tile's mask once, then streams q and k, and then v, through a ring of
// cp.async 16-byte copies in chunks of 64 keys x 128 head columns, one chunk
// in flight while one is multiplied on the tensor cores (mma.sync), every
// score held in shared memory for an exact softmax. A key no query of the
// tile sees (an unwritten cache slot) is neither read nor multiplied: its k
// and v rows are staged as zeros, so what lies there never reaches the
// result. At the rollout's shapes a (sequence, head) is 4 chunks for the
// scores and 4 for P . V, and the block's work per chunk (barriers, index
// arithmetic), not the bytes, is what bounds it. fp32 runs the same
// operands on the CUDA cores.
//
// Limits: any B, Nq >= 1, Nk >= 1 (past 1,024 keys the long route of
// long_attention.cuh), any H and hd with unit stride along
// hd (16-byte copies where hd and the strides are multiples of 16 bytes and
// the operands 16-byte aligned, else element by element), fp32 or bf16,
// optional fp32 (Nq, Nk) additive mask.

#include "fuser_attention.cuh"

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
    return (int)launch_fuser_attention_seq<T>((const T*)q, (const T*)k,
                                              (const T*)v, qs, ks, vs, m,
                                              (T*)out, B, Nq, Nk, H, hd, s);
  }
  if (dtype == 1) {
    typedef bf16 T;
    return (int)launch_fuser_attention_seq<T>((const T*)q, (const T*)k,
                                              (const T*)v, qs, ks, vs, m,
                                              (T*)out, B, Nq, Nk, H, hd, s);
  }
  return (int)cudaErrorInvalidValue;
}
