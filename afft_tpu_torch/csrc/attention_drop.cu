// attention_drop: the training layers' attention alone, forward and
// backward, for its checks and timings. No model path calls these entries:
// the training entries (fused_block_train.cu, fused_gpt2_train.cu) launch
// the same kernels inside their own sequences (train_block.cuh
// attention_drop / attention_drop_bwd: the short kernels, or past 8 tokens
// (the fuser) and 32 (GPT-2) the long route of long_attention.cuh). Its own
// file so that nvcc builds its instances of both layers beside the entries'
// files, not inside one of them.
//
// Replaces no TPU kernel of its own: the attention stages of rows 7 / 9
// (pallas_block_train.py) and 11 / 15 (pallas_gpt2_train.py), reached
// alone; bound as those (attention_bwd.cuh, long_attention.cuh).

#include "train_block.cuh"

using namespace afft;

// The training attention alone, for its checks and timings (no model path
// calls these: the entries launch it inside their own sequences). gpt2
// selects the layer's arithmetic: 1 the GPT-2 layer's (staged_attention,
// attention_bwd ROUND), 0 the fuser's. qkv (R * N, 3 * H * hd), mask fp32
// (N, N) or null, dao fp32 (R * N, H * hd); seeds / thr / inv as the
// entries' (the attention site, rate 0). afft_attention_drop: the forward,
// out (R * N, H * hd); afft_attention_drop_bwd: dqkv (R * N, 3 * H * hd)
// and the recomputed forward output out; stats (R * H * N, 2) and dsum (R *
// H * N) fp32 scratch of the long route (past 8 tokens for the fuser, 32
// for GPT-2; else null).
extern "C" int afft_attention_drop(int dtype, int gpt2, const void* qkv,
                                   const void* mask, void* out,
                                   const int* seeds, const int* thr,
                                   const float* inv, int R, int N, int H,
                                   int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSite d = site_of(rates_of(seeds, thr, inv, N, H * hd, H),
                             SITE_ATTN);
  const float* m = static_cast<const float*>(mask);
  return by_dtype(dtype, [&](auto tag) {
    typedef typename std::remove_pointer<decltype(tag)>::type T;
    const T* q = static_cast<const T*>(qkv);
    T* o = static_cast<T*>(out);
    return (int)(gpt2 ? attention_drop<T, true>(q, m, o, R, N, H, hd, d, s)
                      : attention_drop<T, false>(q, m, o, R, N, H, hd, d, s));
  });
}

extern "C" int afft_attention_drop_bwd(int dtype, int gpt2, const void* qkv,
                                       const void* mask, const void* dao,
                                       void* dqkv, void* out, void* stats,
                                       void* dsum, const int* seeds,
                                       const int* thr,
                                       const float* inv, int R, int N, int H,
                                       int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSite d = site_of(rates_of(seeds, thr, inv, N, H * hd, H),
                             SITE_ATTN);
  const float* m = static_cast<const float*>(mask);
  const float* g = static_cast<const float*>(dao);
  return by_dtype(dtype, [&](auto tag) {
    typedef typename std::remove_pointer<decltype(tag)>::type T;
    const T* q = static_cast<const T*>(qkv);
    T* dq = static_cast<T*>(dqkv);
    T* o = static_cast<T*>(out);
    float* st = static_cast<float*>(stats);
    float* ds = static_cast<float*>(dsum);
    return (int)(gpt2 ? attention_drop_bwd<T, true>(q, m, g, dq, o, st, ds,
                                                    R, N, H, hd, d, s)
                      : attention_drop_bwd<T, false>(q, m, g, dq, o, st, ds,
                                                     R, N, H, hd, d, s));
  });
}
