// mma_tiles: the cp.async copies, the staging of operand rows, the ring of
// stages and the mma.sync fragments that the tensor-core attentions share
// (fuser_attention.cuh fuser_attention_seq_mma, long_attention.cu
// long_attention_mma and its backward): bf16 operands, fp32 accumulators,
// m16n8k16 tiles.

#pragma once

#include "common.cuh"

namespace afft {

// 16 bytes from device memory into shared memory without passing through
// registers; with pred false nothing is read and the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0 + n of one bf16 operand (row t at src + t * ld, the column
// offset folded into src), columns 0 .. width (a multiple of 8), into dst
// (row stride ldd), by the block's NTHR threads: cp.async 16-byte copies
// where vec (every row and 16-byte column group 16-byte aligned, w % 8 ==
// 0), else element by element. A row outside [lo, hi], or whose key is not
// live (live[t] == 0, where live is given), and the columns at or past w
// are zeros and are not read, so every 16-column step of a product reads
// zeros there and NaN in an unwritten cache slot never enters one.
template <int NTHR>
__device__ __forceinline__ void stage_rows(bf16* dst, int ldd,
                                           const bf16* src, long long ld,
                                           int r0, int n, int lo, int hi,
                                           const unsigned char* live,
                                           int width, int w, bool vec) {
  const int per = width / 8;  // 16-byte groups a row
  if (vec && (per & (per - 1)) == 0 && per <= NTHR) {
    // a thread keeps one column group and walks the rows: no division
    const int c = (threadIdx.x & (per - 1)) * 8, step = NTHR / per;
    const bool cin = c < w;
    int r = threadIdx.x / per;
    const bf16* s = src + (long long)(r0 + r) * ld + c;
    bf16* d = dst + r * ldd + c;
    for (; r < n; r += step, s += step * ld, d += step * ldd) {
      const int t = r0 + r;
      const bool ok = cin && t >= lo && t <= hi && (live == nullptr || live[t]);
      cp_async16(d, ok ? s : src, ok);
    }
  } else if (vec) {
    for (int i = threadIdx.x; i < n * per; i += NTHR) {
      const int r = i / per, c = (i - r * per) * 8, t = r0 + r;
      const bool ok =
          t >= lo && t <= hi && c < w && (live == nullptr || live[t]);
      cp_async16(dst + r * ldd + c, ok ? src + t * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * width; i += NTHR) {
      const int r = i / width, c = i - r * width, t = r0 + r;
      const bool ok =
          t >= lo && t <= hi && c < w && (live == nullptr || live[t]);
      dst[r * ldd + c] = ok ? src[t * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// Items 0 .. n of a block stream through NST stages of cp.async copies,
// NST - 1 in flight while one is used: issue(i, stage) stages item i,
// use(i, stage) consumes it. ring_fill issues the first NST - 1 items
// (work that needs none of them may follow, their copies in flight);
// ring_drain then uses the items in order, one barrier an item: item i is
// used once every thread's copies of it have landed (and after whatever the
// block did before the barrier), and a stage is staged again only after
// every thread has used it. Ends with every copy landed and a barrier.
template <int NST, typename Issue>
__device__ __forceinline__ void ring_fill(int n, Issue& issue) {
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n) issue(i, i);
    cp_async_commit();
  }
}
template <int NST, typename Issue, typename Use>
__device__ __forceinline__ void ring_drain(int n, Issue& issue, Use& use) {
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (i + NST - 1 < n) issue(i + NST - 1, (i + NST - 1) % NST);
    cp_async_commit();
    use(i, i % NST);
  }
  cp_async_wait<0>();
  __syncthreads();
}
template <int NST, typename Issue, typename Use>
__device__ __forceinline__ void ring_run(int n, Issue& issue, Use& use) {
  ring_fill<NST>(n, issue);
  ring_drain<NST>(n, issue, use);
}

// D(16x8, fp32) += A(16x16, row) . B(16x8, col), bf16 operands
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment of a 16 x 8 tile of a row-major (keys x columns) operand
// in shared memory: lane l gives row l % 16's 8 columns; the transposing
// load hands each lane keys 2t, 2t + 1 (b[0]) and 2t + 8, 2t + 9 (b[1]) of
// column g, as mma_16816 takes them.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2],
                                                  const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(s));
}

// The A fragment of a 16 x 16 tile of a row-major operand in shared memory
// (row r at p + r * ld): lane l gives row l % 16, columns 8 (l / 16) ..;
// a[0..3] as mma_16816 takes them (rows g / g + 8, columns 2t / 2t + 8).
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const bf16* p,
                                           int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned s = (unsigned)__cvta_generic_to_shared(
      p + (lane & 15) * ld + (lane >> 4) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// The B fragments of two 16 x 8 tiles of an operand stored as rows along k
// (row n at p + n * ld, 16 rows, 16 columns of k): b0 for rows 0 .. 7, b1
// for rows 8 .. 15, as mma_16816 takes them (keys 2t, 2t + 1 and 2t + 8,
// 2t + 9 of row g).
__device__ __forceinline__ void ldmatrix_b2(uint32_t (&b0)[2],
                                            uint32_t (&b1)[2], const bf16* p,
                                            int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned s = (unsigned)__cvta_generic_to_shared(
      p + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(s));
}

// The B fragment of one 16 x 8 tile stored as rows along k (row n at p + n
// * ld, 8 rows, 16 columns of k)
__device__ __forceinline__ void ldmatrix_b1(uint32_t (&b)[2], const bf16* p,
                                            int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned s = (unsigned)__cvta_generic_to_shared(
      p + (lane & 7) * ld + ((lane >> 3) & 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(s));
}

// two consecutive bf16 as one register (the lower column in the low half)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair_of(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

}  // namespace afft
