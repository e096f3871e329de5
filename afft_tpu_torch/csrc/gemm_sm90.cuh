// gemm_sm90: the bf16 GEMMs on Hopper's own path, three routes on one tile
// loop:
//   * C[M,N] = A[M,K] . W[K,N] with a fused epilogue, for A row-major
//     (K-major) and W row-major (N contiguous: the MN-major "transposed"
//     wgmma B operand): the HF Conv1D (in, out) weight forward, and the
//     fuser's nn.Linear (out, in) weight in its backward dX = dY . W;
//   * C[M,N] = A[M,K] . W[N,K]^T with a fused epilogue, W read where it
//     lies with K contiguous (the K-major wgmma B operand, no transpose
//     bit): the nn.Linear (out, in) weight in the fuser blocks' serving and
//     training forward (fused_block.cu, seq_block.cu, train_block.cuh, all
//     through gemm_nk), and the HF Conv1D (in, out) weight in the GPT-2
//     layer's backward dX = dY . W^T;
//   * the weight gradient out[I,J] = sum_m A[m,I] B[m,J] (gemm_tn_sm90), for
//     A (M, I) and B (M, J) row-major, both MN-major, fp32 out written whole.
//
// Runs every bf16 product of the port's entries: the GPT-2 serving halves
// (fused_gpt2.cu), the fuser's serving forward (rows 1, 5 and every stage of
// 6: seq_block.cu) and every product of both training layers: forward
// (train_block.cuh fwd_gemm), backward dX (launch_dx) and weight gradients
// (launch_dw). At their shapes (M = 2560 to 20480 rows, K 1024..20480, N
// 1024..8192) a product does 5-172 GFLOP against 8-130 MB: it is bound by
// the tensor cores (989 TFLOP/s bf16). What the design does about it:
//   * wgmma.mma_async m64n256k16, bf16 in, fp32 accumulators in registers
//     (128 a thread): the only route to the full tensor-core rate;
//   * TMA tile loads with 128-byte swizzle into a ring of four 48 KB stages
//     of dynamic shared memory, one full / empty mbarrier pair a stage.
//     A K-major A tile is one 128x64 box, a K-major W (N, K) tile one
//     256x64 box (256 rows: TMA's largest box); an MN-major tile (W (K, N),
//     B, and the weight gradient's A) is 64-column boxes, 64 columns being
//     the widest MN-major box a 128-byte swizzle takes, read by wgmma with
//     its transpose bit (A's is allowed for bf16 operands in shared memory);
//   * warp specialisation: one producer warp issues the loads (its
//     warpgroup gives registers away with setmaxnreg), two consumer
//     warpgroups each multiply 64 rows of the 128x256 tile, one wgmma group
//     in flight while the previous stage is released;
//   * the epilogue stages the fp32 tile through shared memory (over the
//     drained ring), then each lane takes 8 consecutive columns of a row:
//     the bias is read once per column, residuals, stashes and outputs move
//     as 16-byte vectors where N % 8 == 0 and their bases are on the 16-byte
//     grid (else element by element, a lane taking every 32nd column so that
//     a warp's accesses to a row are consecutive, the columns past N
//     masked: with N % 8 != 0 most rows start off that grid), and the
//     element arithmetic is
//     common.cuh epilogue()'s, in the same order with the same rounding
//     points on either route (acc + bias, then the exact or tanh GELU,
//     dropout / drop-path / residual, the stashed pre-activation, or the
//     exact or tanh GELU derivative of the stashed pre-activation; the
//     residual bf16 or fp32).
//     The dropout multiplier of an element is drop_scale() of its (row, col)
//     index, so the masks do not change.
// TMA zero-fills out of bounds, so M, N and K need not be multiples of the
// tile (the zero rows of a ragged reduction add nothing); the epilogue masks
// rows and columns. TMA also needs an operand's base and row stride on the
// 16-byte grid: an operand whose row (K, or a (K, N) weight's N; I and J for
// the weight gradient) is not a multiple of 8 columns, or whose base is off
// that grid, is first copied by pack_rows into the calling thread's
// PackArena at a row stride of the next multiple of 8, the tensor map
// keeping its own column count (so TMA reads the padding as zeros). So any
// M, N, K >= 1 is taken; the launchers return cudaErrorInvalidValue where
// an operand needs a pack and the arena has no room. At N, K (I, J) that are
// multiples of 8, with aligned operands, nothing is packed and the vector
// epilogue runs: the tiles, the reduction order and the roundings are those
// of every width. One block per output tile walks all of K in a fixed
// order, no atomics: the result is the same from run to run. The TN route
// alone may
// split its reduction over M (tn_slices) where its output tiles would leave
// most SMs idle (the fuser's dWproj: 32 tiles on 132 SMs): a grid over
// (tile, slice of M), each slice writing its fp32 partial tile into the
// caller's scratch, then a fixed-order sum of the slices into out; still the
// same from run to run, and one slice is the unsplit route, bit for bit.
//
// The tensor maps are encoded on the host per call; cuTensorMapEncodeTiled
// is a driver function, fetched once through cudaGetDriverEntryPoint so the
// library needs no -lcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)

#include "common.cuh"

namespace afft {

constexpr int GS_M = 128, GS_N = 256, GS_K = 64, GS_STAGES = 4;
constexpr int GS_THREADS = 384;  // producer warpgroup + two consumers
constexpr int GS_BOX_N = 64;     // W box width: 128 bytes, the swizzle span
constexpr int GS_A_BYTES = GS_M * GS_K * 2;                  // 16 KB
constexpr int GS_B_BOX_BYTES = GS_K * GS_BOX_N * 2;          // 8 KB
constexpr int GS_STAGE_BYTES = GS_A_BYTES + 4 * GS_B_BOX_BYTES;  // 48 KB
constexpr int GS_RING_BYTES = GS_STAGES * GS_STAGE_BYTES;
constexpr int GS_LD = GS_N + 8;  // fp32 staging row: float2 stores of a
                                 // half-warp (4 rows) hit 32 distinct banks
constexpr int GS_SMEM = GS_RING_BYTES + 2 * GS_STAGES * 8 + 1024;  // + align
static_assert(GS_M * GS_LD * 4 <= GS_RING_BYTES, "staging fits the ring");
static_assert(GS_SMEM <= 227 * 1024, "dynamic shared memory limit");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase differs from ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map (c0 the contiguous coordinate) into shared
// memory, completing ``bar``'s transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (bytes; stored in 16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D(64x256, fp32) += A(64x16) . B(16x256), bf16 operands; A is K-major, or
// MN-major with TNSP_A (wgmma's transpose bit on A); B is MN-major with
// TNSP_B, else K-major.
template <int TNSP_A, int TNSP_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "
      "%94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TNSP_A), "n"(TNSP_B));
}

// 8 consecutive bf16 <-> fp32, as one 16-byte access; 8 fp32 as two
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16(v[2 * i]),
                              __float2bfloat16(v[2 * i + 1]));
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The element route's column step: a lane's 8 columns are GS_SPREAD apart.
constexpr int GS_SPREAD = 32;

// The 8 columns of a lane from p, or into p: with VEC 8 consecutive ones
// as 16-byte vectors, else every GS_SPREAD-th element by element, the first
// n alone (the others read as 0 and are not written).
template <bool VEC, typename T>
__device__ __forceinline__ void load_cols(const T* p, float* v, int n) {
  if constexpr (VEC) {
    load8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < n ? to_f32(p[i * GS_SPREAD]) : 0.f;
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_cols(T* p, const float* v, int n) {
  if constexpr (VEC) {
    store8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i * GS_SPREAD] = from_f32<T>(v[i]);
  }
}

// The epilogues of the entries on this GEMM (common.cuh epilogue(), element
// for element) on 8 columns of one row from col on, consecutive with VEC
// (the 16-byte route), else GS_SPREAD apart, of which the first n are
// inside it (8 with VEC); b the bias values. The
// output is bf16, or fp32 with EPI_BIAS (the fp32 dX products and the
// weight gradients), EPI_BIAS_RES (the fuser's serving proj into the fp32
// residual stream y) or EPI_RES_DROP (its training proj into y, y stashed in
// bf16; a tensor-parallel shard's partial sum of a row-parallel product);
// the residual is bf16, or fp32 with EPI_BIAS_RES or EPI_RES_DROP (the
// fuser's fc2 adding y, the decoder block's cross proj adding into y), and
// EPI_RES_DROP's may be null (a partial sum of a rank other than 0);
// stashes are bf16. res may be out (y += ...): the thread that
// loads res + at stores out + at in the same call, and output tiles are
// disjoint, so no element is read after it is written.
template <int EPI, bool VEC, typename TRes, typename TOut>
__device__ __forceinline__ void epilogue8(const EpiArgs& ea, int row, int col,
                                          int N, const float* acc,
                                          const float* b, int n) {
  constexpr bool out_bf16 = std::is_same<TOut, bf16>::value;
  constexpr bool res_bf16 = std::is_same<TRes, bf16>::value;
  static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_RES ||
                    EPI == EPI_GELU_ERF || EPI == EPI_GELU_TANH ||
                    EPI == EPI_RES_DROP || EPI == EPI_PRE_GELU ||
                    EPI == EPI_PRE_GELU_TANH || EPI == EPI_GELU_BWD ||
                    EPI == EPI_GELU_TANH_BWD,
                "gemm_sm90 epilogue");
  static_assert(out_bf16 || EPI == EPI_BIAS || EPI == EPI_BIAS_RES ||
                    EPI == EPI_RES_DROP,
                "an fp32 output takes EPI_BIAS, EPI_BIAS_RES or "
                "EPI_RES_DROP");
  static_assert(res_bf16 || EPI == EPI_BIAS_RES || EPI == EPI_RES_DROP,
                "an fp32 residual takes EPI_BIAS_RES or EPI_RES_DROP");
  constexpr int S = VEC ? 1 : GS_SPREAD;
  const size_t at = (size_t)row * N + col;
  float v[8], r[8], o2[8];
  if (EPI == EPI_BIAS_RES || EPI == EPI_GELU_BWD || EPI == EPI_GELU_TANH_BWD)
    load_cols<VEC>(static_cast<const TRes*>(ea.res) + at, r, n);
  if (EPI == EPI_RES_DROP) {
    // a tensor-parallel partial sum of a rank other than 0 has no residual
    if (ea.res != nullptr) {
      load_cols<VEC>(static_cast<const TRes*>(ea.res) + at, r, n);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = 0.f;
    }
  }
  float keep_row = 1.f;
  if (EPI == EPI_RES_DROP)
    keep_row = drop_scale(ea.row_drop, (unsigned long long)(row / ea.tokens));
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float x = acc[e];
    if (ea.bias != nullptr) x += b[e];
    if (EPI == EPI_GELU_ERF) {
      x = gelu_erf(x);
    } else if (EPI == EPI_GELU_TANH) {
      x = gelu_tanh(x);
    } else if (EPI == EPI_PRE_GELU) {
      o2[e] = x;
      x = gelu_erf(x);
    } else if (EPI == EPI_PRE_GELU_TANH) {
      o2[e] = x;
      x = gelu_tanh(x);
    } else if (EPI == EPI_GELU_BWD) {
      x *= gelu_erf_grad(r[e]);
    } else if (EPI == EPI_GELU_TANH_BWD) {
      x *= gelu_tanh_grad(r[e]);
    } else if (EPI == EPI_RES_DROP) {
      x *= drop_scale(ea.drop, at + e * S);
      x *= keep_row;
      x = r[e] + x;
      o2[e] = x;
    } else if (EPI == EPI_BIAS_RES) {
      x = r[e] + x;
    }
    v[e] = x;
  }
  store_cols<VEC>(static_cast<TOut*>(ea.out) + at, v, n);
  if ((EPI == EPI_PRE_GELU || EPI == EPI_PRE_GELU_TANH ||
       EPI == EPI_RES_DROP) &&
      ea.out2 != nullptr)
    store_cols<VEC>(static_cast<bf16*>(ea.out2) + at, o2, n);
}

// One 128x256 output tile, C[m0.., n0..] = A . B over the k-tiles kt0 ..
// kt1 - 1 of K (all of them but in a TN slice), then the epilogue. A is
// K-major (M, K) in one 128x64 box a stage, or with A_MN MN-major (K, M) in
// two 64x64 boxes; B is MN-major (K, N) in four 64x64 boxes, or with B_NK
// K-major (N, K) in one 256x64 box (the same 32 KB). Either way consumer
// cw's 64 rows start 8 KB into the stage. tmA / tmB point at the kernel's
// __grid_constant__ tensor maps; vec: the epilogue's 16-byte route
// (epi_vec).
template <int EPI, bool A_MN, bool B_NK, typename TRes, typename TOut>
__device__ __forceinline__ void gemm_sm90_tile(const CUtensorMap* tmA,
                                               const CUtensorMap* tmB, int M,
                                               int N, int kt0, int kt1,
                                               const EpiArgs& ea, int vec) {
  static_assert(GS_A_BYTES == 2 * GS_B_BOX_BYTES, "A: two 64-column boxes");
  static_assert(GS_N * GS_K * 2 == 4 * GS_B_BOX_BYTES, "B: one K-major box");
  extern __shared__ __align__(1024) unsigned char gs_smem[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  const uint32_t raw = smem_u32(gs_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* stage_f32 = reinterpret_cast<float*>(gs_smem + (base - raw));
  const uint32_t full = base + GS_RING_BYTES;   // GS_STAGES barriers
  const uint32_t empty = full + 8 * GS_STAGES;  // GS_STAGES barriers
  const int m0 = blockIdx.y * GS_M, n0 = blockIdx.x * GS_N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GS_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(empty + 8 * s, ph ^ 1u);  // the first round passes
        const uint32_t dst = base + s * GS_STAGE_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, GS_STAGE_BYTES);
        if (A_MN) {
          tma_load_2d(dst, tmA, bar, m0, kt * GS_K);
          tma_load_2d(dst + GS_B_BOX_BYTES, tmA, bar, m0 + GS_BOX_N,
                      kt * GS_K);
        } else {
          tma_load_2d(dst, tmA, bar, kt * GS_K, m0);
        }
        if (B_NK) {
          tma_load_2d(dst + GS_A_BYTES, tmB, bar, kt * GS_K, n0);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_2d(dst + GS_A_BYTES + j * GS_B_BOX_BYTES, tmB, bar,
                        n0 + j * GS_BOX_N, kt * GS_K);
        }
        if (++s == GS_STAGES) {
          s = 0;
          ph ^= 1u;
        }
      }
    }
  } else {
    // consumer warpgroups: cw = 0 takes rows 0-63 of the tile, 1 rows 64-127
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = (threadIdx.x >> 7) - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = base + s * GS_STAGE_BYTES + cw * GS_B_BOX_BYTES;
      const uint32_t b = base + s * GS_STAGE_BYTES + GS_A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < GS_K / 16; ++kk) {
        // MN-major (B, and A with A_MN): 64-column boxes 8 KB apart
        // (leading), 8-k-row groups 1024 bytes apart (stride), a k16 step
        // 16 rows = 2048 bytes. K-major (A, and B with B_NK): 128-byte
        // rows, 8-row groups 1024 bytes apart, a k16 step 32 bytes along
        // the row.
        const uint64_t db =
            B_NK ? gmma_desc(b + kk * 32, 16, 1024)
                 : gmma_desc(b + kk * 2048, GS_B_BOX_BYTES, 1024);
        if (A_MN)
          wgmma_m64n256k16<1, B_NK ? 0 : 1>(
              acc, gmma_desc(a + kk * 2048, GS_B_BOX_BYTES, 1024), db);
        else
          wgmma_m64n256k16<0, B_NK ? 0 : 1>(
              acc, gmma_desc(a + kk * 32, 16, 1024), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous k-tile's group is done: its stage goes back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > kt0 && t == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == GS_STAGES) {
        s = 0;
        ph ^= 1u;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // every wgmma of both consumers has read the ring: stage the fp32 tile
    // over it. Accumulator layout (m64nNk16): warp w holds rows 16w + lane/4
    // (+8), register 4j + {0,1} (+{2,3}) columns 8j + 2 (lane % 4) + {0,1}.
    named_bar_sync(1, 256);
    const int r0 = cw * 64 + warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < GS_N / 8; ++j) {
      *reinterpret_cast<float2*>(stage_f32 + r0 * GS_LD + 8 * j + c0) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(stage_f32 + (r0 + 8) * GS_LD + 8 * j + c0) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_bar_sync(2 + cw, 128);  // this consumer's 64 rows are staged

    // lane: columns 8 lane .. 8 lane + 7 with vec (N % 8 == 0: all 8 are in),
    // else lane, lane + 32, ..., lane + 224; warp: rows warp, warp + 4, ...
    const int col = n0 + (vec ? 8 * lane : lane);
    if (col < N) {
      const int n = vec ? 8 : min(8, (N - col + GS_SPREAD - 1) / GS_SPREAD);
      float bias[8];
      if (ea.bias != nullptr) {
        const bf16* b = static_cast<const bf16*>(ea.bias) + col;
        if (vec)
          load_cols<true>(b, bias, 8);
        else
          load_cols<false>(b, bias, n);
      }
      for (int i = 0; i < 16; ++i) {
        const int rl = cw * 64 + warp + 4 * i, row = m0 + rl;
        if (row >= M) break;
        float v[8];
        if (vec) {
          const float4* src = reinterpret_cast<const float4*>(
              stage_f32 + rl * GS_LD + 8 * lane);
          const float4 lo = src[0], hi = src[1];
          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
          v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
          epilogue8<EPI, true, TRes, TOut>(ea, row, col, N, v, bias, 8);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = stage_f32[rl * GS_LD + lane + GS_SPREAD * e];
          epilogue8<EPI, false, TRes, TOut>(ea, row, col, N, v, bias, n);
        }
      }
    }
  }
}

// C = A . W (+ epilogue) for A (M, K) K-major and W (K, N) MN-major, or with
// B_NK W (N, K) K-major.
template <int EPI, bool B_NK, typename TRes, typename TOut>
__global__ void __launch_bounds__(GS_THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap tmA,
          const __grid_constant__ CUtensorMap tmB, int M, int N, int K,
          EpiArgs ea, int vec) {
  gemm_sm90_tile<EPI, false, B_NK, TRes, TOut>(&tmA, &tmB, M, N, 0,
                                                (K + GS_K - 1) / GS_K, ea,
                                                vec);
}

// The weight gradient out (I, J) = A^T . B, fp32, over the M rows of A
// (M, I) and B (M, J): the tile loop with A MN-major, stored whole. Slice
// blockIdx.z takes the k-tiles (64 rows each) z * per .. (z + 1) * per - 1
// and writes its partial tile to out + z * I * J.
static __global__ void __launch_bounds__(GS_THREADS, 1)
gemm_tn_sm90(const __grid_constant__ CUtensorMap tmA,
             const __grid_constant__ CUtensorMap tmB, int I, int J, int M,
             int per, float* out, int vec) {
  const int kt0 = blockIdx.z * per;
  const int kt1 = min((M + GS_K - 1) / GS_K, kt0 + per);
  gemm_sm90_tile<EPI_BIAS, true, false, bf16, float>(
      &tmA, &tmB, I, J, kt0, kt1,
      EpiArgs{nullptr, nullptr, out + (size_t)blockIdx.z * I * J}, vec);
}

// out[i] = part[0][i] + part[1][i] + ... + part[S - 1][i] in slice order,
// n4 float4s a slice
static __global__ void sum_slices(const float4* __restrict__ part,
                                  float4* __restrict__ out, size_t n4,
                                  int S) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int z = 1; z < S; ++z) {
      const float4 b = part[(size_t)z * n4 + i];
      a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
    }
    out[i] = a;
  }
}

// The same one element at a time, in the same order (I * J % 4 != 0, or a
// base off the 16-byte grid)
static __global__ void sum_slices_scalar(const float* __restrict__ part,
                                         float* __restrict__ out, size_t n,
                                         int S) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = part[i];
    for (int z = 1; z < S; ++z) a += part[(size_t)z * n + i];
    out[i] = a;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix at row stride ld (a multiple of 8)
// read in (box_rows, box_cols) boxes with 128-byte swizzle; out-of-bounds
// elements, the columns from cols to ld included, read as zeros.
static bool bf16_tensor_map(CUtensorMap* map, const void* base, int rows,
                            int cols, int ld, int box_rows, int box_cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The scratch an entry's wrapper gives its products for their packed
// operands (see the header), set around one entry's launch on the calling
// thread (gemm.cu afft_set_pack; ops/_common.py launch and pack_scratch): buf
// 16-byte aligned, cap bf16 elements, launches the pack_rows launches made
// since it was set. Each product packs from the arena's start: the products
// of an entry run one after the other on one stream.
struct PackArena {
  bf16* buf;
  size_t cap;
  long long launches;
};
inline thread_local PackArena pack_arena{nullptr, 0, 0};

// dst (rows, pad8(cols)) <- src (rows, cols), both row-major, dst 16-byte
// aligned: one warp a row, each lane 8 columns at a time (8 element loads,
// one 16-byte store); dst's columns past cols are written as zeros.
constexpr int PR_WARPS = 8;

static __global__ void __launch_bounds__(PR_WARPS * 32)
pack_rows(const bf16* __restrict__ src, bf16* __restrict__ dst, int rows,
          int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (cols + 7) / 8;
  for (int r = blockIdx.x * PR_WARPS + warp; r < rows;
       r += gridDim.x * PR_WARPS) {
    const bf16* s = src + (size_t)r * cols;
    uint4* d = reinterpret_cast<uint4*>(dst + (size_t)r * chunks * 8);
    for (int j = lane; j < chunks; j += 32) {
      uint4 u;
      bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 8 * j + e;
        h[e] = c < cols ? s[c] : __float2bfloat16(0.f);
      }
      d[j] = u;
    }
  }
}

static inline int pad8(int n) { return (n + 7) / 8 * 8; }

static void launch_pack_rows(const bf16* src, bf16* dst, int rows, int cols,
                             cudaStream_t stream) {
  const int blocks = cdiv(rows, PR_WARPS);
  pack_rows<<<blocks < (1 << 20) ? blocks : (1 << 20), PR_WARPS * 32, 0,
              stream>>>(src, dst, rows, cols);
}

// The contiguous (rows, cols) operand at *p where TMA can read it as it
// lies (cols % 8 == 0, a 16-byte aligned base; *ld = cols), else packed
// into the arena after its first *used elements (*p moved there, *ld =
// pad8(cols)).
static cudaError_t tma_operand(const bf16** p, int rows, int cols, int* ld,
                               size_t* used, cudaStream_t stream) {
  *ld = cols;
  if (cols % 8 == 0 && (uintptr_t)*p % 16 == 0) return cudaSuccess;
  PackArena& a = pack_arena;
  const size_t n = (size_t)rows * pad8(cols);
  if (a.buf == nullptr || (uintptr_t)a.buf % 16 || *used + n > a.cap)
    return cudaErrorInvalidValue;
  bf16* dst = a.buf + *used;
  launch_pack_rows(*p, dst, rows, cols, stream);
  ++a.launches;
  *used += n;
  *p = dst;
  *ld = pad8(cols);
  return cudaGetLastError();
}

// Whether the epilogue takes its 16-byte route: N % 8 == 0 and bias, res,
// out and out2 on the 16-byte grid (every row then starts on it).
static int epi_vec(const EpiArgs& ea, int N) {
  return N % 8 == 0 && ((uintptr_t)ea.bias | (uintptr_t)ea.res |
                        (uintptr_t)ea.out | (uintptr_t)ea.out2) %
                               16 ==
                           0;
}

// C = A . W (+ epilogue EPI) for A (M, K) and W (K, N), or with B_NK W
// (N, K), bf16 and contiguous; out TOut and residual TRes bf16 or fp32 as
// epilogue8 takes them, out2 bf16. Returns the launch's error.
template <int EPI, typename TOut = bf16, bool B_NK = false,
          typename TRes = bf16>
static cudaError_t launch_gemm_sm90(const bf16* A, const bf16* W, int M, int N,
                                    int K, EpiArgs ea, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  // on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      gemm_sm90<EPI, B_NK, TRes, TOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, GS_SMEM);
  if (err != cudaSuccess) return err;
  size_t used = 0;
  int lda, ldw;
  err = tma_operand(&A, M, K, &lda, &used, stream);
  if (err == cudaSuccess)
    err = B_NK ? tma_operand(&W, N, K, &ldw, &used, stream)
               : tma_operand(&W, K, N, &ldw, &used, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!bf16_tensor_map(&ta, A, M, K, lda, GS_M, GS_K) ||
      !(B_NK ? bf16_tensor_map(&tb, W, N, K, ldw, GS_N, GS_K)
             : bf16_tensor_map(&tb, W, K, N, ldw, GS_K, GS_BOX_N)))
    return cudaErrorInvalidValue;
  const dim3 grid(cdiv(N, GS_N), cdiv(M, GS_M));
  gemm_sm90<EPI, B_NK, TRes, TOut><<<grid, GS_THREADS, GS_SMEM, stream>>>(
      ta, tb, M, N, K, ea, epi_vec(ea, N));
  return cudaGetLastError();
}

// The slices over M of the TN route for an (I, J) output over M rows on the
// current device: 1, unless the output tiles fill less than half the SMs;
// then the count up to TN_MAX_SLICES that fills the SMs' waves best (tiles
// * slices blocks over whole waves of one block an SM; the fewest on a
// tie), each slice keeping at least TN_MIN_KTILES k-tiles (64 rows). On an
// H100 (132 SMs) at the flagship's shapes: 4 for the fuser's dWproj (32
// tiles over 20,480 rows: about 0.20 -> 0.075 ms), 1 for every other weight
// gradient (96 to 512 tiles; at 96, the fuser's dWqkv, 2 to 8 slices all
// took longer than one).
constexpr int TN_MAX_SLICES = 8, TN_MIN_KTILES = 32;

static int tn_slices(int I, int J, int M) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    return 1;
  const int tiles = cdiv(J, GS_N) * cdiv(I, GS_M), nk = cdiv(M, GS_K);
  if (2 * tiles >= sms) return 1;
  const auto fill = [&](int s) {
    const int blocks = tiles * s;
    return (double)blocks / ((double)cdiv(blocks, sms) * sms);
  };
  int best = 1;
  for (int s = 2; s <= TN_MAX_SLICES && nk / s >= TN_MIN_KTILES; ++s)
    if (fill(s) > fill(best)) best = s;
  return best;
}

// out (I, J) fp32 = A^T . B for A (M, I) and B (M, J), bf16 row-major, over
// ``slices`` slices of M (the partial tiles in scratch, slices * I * J fp32;
// one slice needs none). Returns the launch's error.
static cudaError_t launch_gemm_tn_sm90(const bf16* A, const bf16* B,
                                       float* out, int I, int J, int M,
                                       cudaStream_t stream, int slices = 1,
                                       float* scratch = nullptr) {
  if (M < 1 || I < 1 || J < 1 || slices < 1 ||
      (slices > 1 && scratch == nullptr) ||
      ((uintptr_t)out | (uintptr_t)scratch) % 4)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tn_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, GS_SMEM);
  if (err != cudaSuccess) return err;
  size_t used = 0;
  int lda, ldb;
  err = tma_operand(&A, M, I, &lda, &used, stream);
  if (err == cudaSuccess) err = tma_operand(&B, M, J, &ldb, &used, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!bf16_tensor_map(&ta, A, M, I, lda, GS_K, GS_BOX_N) ||
      !bf16_tensor_map(&tb, B, M, J, ldb, GS_K, GS_BOX_N))
    return cudaErrorInvalidValue;
  const int nk = cdiv(M, GS_K), per = cdiv(nk, slices);
  slices = cdiv(nk, per);  // no empty slice
  float* dst = slices > 1 ? scratch : out;
  // J % 8 == 0 keeps every slice's rows on the 16-byte grid, and I * J % 4
  // == 0 for the float4 sum
  const int vec = J % 8 == 0 && ((uintptr_t)out | (uintptr_t)dst) % 16 == 0;
  const dim3 grid(cdiv(J, GS_N), cdiv(I, GS_M), slices);
  gemm_tn_sm90<<<grid, GS_THREADS, GS_SMEM, stream>>>(ta, tb, I, J, M, per,
                                                       dst, vec);
  if (slices > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t n = (size_t)I * J, n4 = vec ? n / 4 : n;
    const size_t blocks = (n4 + 255) / 256;
    const int b = (int)(blocks < 4096 ? blocks : 4096);
    if (vec)
      sum_slices<<<b, 256, 0, stream>>>(reinterpret_cast<const float4*>(dst),
                                        reinterpret_cast<float4*>(out), n4,
                                        slices);
    else
      sum_slices_scalar<<<b, 256, 0, stream>>>(dst, out, n, slices);
  }
  return cudaGetLastError();
}

// C = A . W (+ epilogue) for W read as (K, N): the GPT-2 layer's Conv1D
// weight forward, the fuser's nn.Linear weight in dX = dY . W. This GEMM in
// bf16 (TOut bf16, or fp32 with EPI_BIAS); gemm_f32 (true fp32, for the
// parity checks) in fp32.
template <int EPI, typename T, typename TOut = T>
static cudaError_t gemm_kn(const T* A, const T* W, int M, int N, int K,
                           EpiArgs ea, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_gemm_sm90<EPI, TOut>(A, W, M, N, K, ea, stream);
  } else {
    launch_gemm<EPI, true, T, TOut>(A, W, M, N, K, ea, stream);
    return cudaGetLastError();
  }
}

// C = A . W^T (+ epilogue) for W read as (N, K): the fuser blocks' nn.Linear
// (out, in) weights in their serving and training forward, the GPT-2
// layer's Conv1D (in, out) weights in its backward dX. This GEMM's K-major B
// route in bf16 (TOut and TRes as epilogue8 takes them); gemm_f32 (true
// fp32, for the parity checks) in fp32.
template <int EPI, typename T, typename TRes, typename TOut>
static cudaError_t gemm_nk(const T* A, const T* W, int M, int N, int K,
                           EpiArgs ea, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_gemm_sm90<EPI, TOut, true, TRes>(A, W, M, N, K, ea, stream);
  } else {
    launch_gemm<EPI, false, TRes, TOut>(A, W, M, N, K, ea, stream);
    return cudaGetLastError();
  }
}

// The weight gradient out (I, J) = A^T . B over M rows, fp32: the TN route
// above in bf16, split over M as tn_slices says when the caller gives
// scratch (tn_slices(I, J, M) * I * J fp32), else one slice; gemm_tn_f32
// (common.cuh, true fp32) in fp32, which needs no scratch.
static cudaError_t gemm_tn(const bf16* A, const bf16* B, float* out, int I,
                           int J, int M, cudaStream_t stream,
                           float* scratch = nullptr) {
  return launch_gemm_tn_sm90(A, B, out, I, J, M, stream,
                             scratch != nullptr ? tn_slices(I, J, M) : 1,
                             scratch);
}

static cudaError_t gemm_tn(const float* A, const float* B, float* out, int I,
                           int J, int M, cudaStream_t stream,
                           float* /*scratch*/ = nullptr) {
  launch_gemm_tn(A, B, out, I, J, M, stream);
  return cudaGetLastError();
}

}  // namespace afft
