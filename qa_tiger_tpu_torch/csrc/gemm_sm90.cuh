// qt::gemm_sm90: a bf16 GEMM for Hopper (sm_90a), C[m, n] = sum_k A[m, k] B[n, k]
// with fp32 accumulation, the result handed element by element to one of the
// epilogue functors of common.cuh (EpiBias, EpiResidual, EpiF32, ...), so
// every rounding point stays where gemm_tile put it. A is [M, K] row-major
// and B [N, K] (torch's Linear layout): both K-major, as wgmma reads them.
//
// Serves the bf16 GEMMs of the fused kernels: resblock.cu attn<T> (the qkv
// projection and the out_proj + residual of the pre-LN attention half,
// replacing the matmuls of _attn_ln2_kernel / _attn_core in
// qa_tiger_tpu/ops/pallas/resblock.py) and mlp<T> (c_fc + QuickGELU and
// c_proj + residual of the MLP half, _mlp_kernel there), patch_select.cu
// run<T> (the seven projections of _kernel in
// qa_tiger_tpu/ops/pallas/patch_select.py), and through planned_gemm
// (gemm_tf32x3.cuh) the forward products of the two train kernels
// (patch_select_train.cu and avq.cu forward<T>).
//
// Bound on the H100: operations. The largest call, the CLIP image tower's
// qkv projection at M = 120 * 577 = 69,240, N = 3072, K = 1024, is 436 GFLOP
// against ~0.6 GB of A, B and C (qkv and out_proj together 581 GFLOP
// against ~0.43 GB per attention half): at 989 TFLOP/s and 3.35 TB/s the
// products need ~4x the time of the bytes. gemm_tile (common.cuh) loads its
// operands one element per thread, single-stage, into 64 x 64 WMMA tiles,
// and reaches ~35 TFLOP/s there. This kernel:
// - tiles C in 128 x BN blocks (BN = 256 for N >= 2304, else 128) over
//   K slabs of 64 bf16 (128 bytes: one 128-byte swizzle row);
// - brings A and B tiles in by TMA (cp.async.bulk.tensor, 128-byte swizzle,
//   zero fill past M, N and K) into a ring of 3-4 stages of dynamic shared
//   memory (Sm90Tile), each stage with a full and an empty mbarrier;
// - runs one or two persistent blocks per SM over the tiles, so that loads
//   of the next tile overlap the epilogue of the last;
// - one producer warp issues the loads; two consumer warpgroups each run
//   wgmma.mma_async m64nBNk16 (bf16 -> fp32) on one 64-row half of the
//   block's rows, straight from the swizzled tiles, keeping one group of
//   products in flight while the next stage's data lands;
// - applies the epilogue from the accumulator registers (wgmma's C layout),
//   masked to m < M, n < N, two adjacent columns per store: no shared-memory
//   round trip.
// A LayerNorm or a row interleave cannot ride on a TMA load, so the callers
// stage such an A operand in a scratch buffer first (resblock.cu, patch_select.cu).
//
// Needs 16-byte aligned A and B and row strides that are multiples of 8
// elements (TMA's 16-byte rule), and an 8-byte aligned output with an even
// row stride (the paired stores); a call that breaks that returns
// cudaErrorInvalidValue. The wrappers pass only buffers they allocated and
// weights they made contiguous and aligned, and gemm_route sends N or K not a
// multiple of 8 to gemm_tile.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace qt {
namespace {

// The GEMM routine a fused kernel takes for one product: fp32 stays on
// gemm_tile's FMA loop, bf16 takes gemm_sm90 where N and K are multiples of
// 8 (TMA's 16-byte rows) and gemm_tile's WMMA loop otherwise. A function of
// dtype and shape only; nothing falls back at run time. GEMM_ROUTE_TF32X3 is
// the 3xTF32 routine of every planned fp32 product (gemm_tf32x3.cuh,
// planned_gemm: TMA + wgmma).
enum GemmRoute {
  GEMM_ROUTE_FMA = 0,
  GEMM_ROUTE_WMMA = 1,
  GEMM_ROUTE_WGMMA = 2,
  GEMM_ROUTE_TF32X3 = 3
};

inline GemmRoute gemm_route(bool bf16, int M, int N, int K) {
  if (!bf16) return GEMM_ROUTE_FMA;
  return M > 0 && N % 8 == 0 && K % 8 == 0 ? GEMM_ROUTE_WGMMA : GEMM_ROUTE_WMMA;
}

constexpr int SM90_BM = 128, SM90_BK = 64;
// two consumer warpgroups (threads 0-255), then one producer warp
constexpr int SM90_THREADS = 288, SM90_PRODUCER = 256;

// A tile width and what it costs: 128 x 256 tiles in a 4-stage ring (192 KB,
// one block per SM); 128 x 128 tiles in a 3-stage ring (97 KB, two blocks
// per SM, so that one block's epilogue overlaps the other's products)
template <int BN> struct Sm90Tile {
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int BLOCKS_PER_SM = BN == 256 ? 1 : 2;
  static constexpr int A_BYTES = SM90_BM * SM90_BK * 2;
  static constexpr int STAGE_BYTES = (SM90_BM + BN) * SM90_BK * 2;
  // the stages, 1 KB of slack to align them to the 1 KB swizzle atom, and a
  // full and an empty barrier per stage
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one 2-D box (c0: the inner, K coordinate; c1: the row) into shared memory,
// completion counted in bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in 128-byte swizzle:
// start address and the 1024-byte stride between 8-row groups in 16-byte
// units, layout type 1 (128B swizzle); the leading offset is unused there
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a warpgroup's registers a thread, raised or lowered (sm_90a): the producer
// warpgroup of a warp-specialised kernel gives its share to the consumers
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, wgmma's C layout) = A (64 x 16) B (16 x 128), both bf16
// K-major in 128-byte-swizzled shared memory, given by their descriptors;
// scale_d 0 overwrites d, 1 adds to it
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256 fp32, wgmma's C layout) = A (64 x 16) B (16 x 256), both bf16
// K-major in 128-byte-swizzled shared memory, given by their descriptors;
// scale_d 0 overwrites d, 1 adds to it
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n128k16(d, desc_a, desc_b, scale_d);
}

// two adjacent values stored together: an 8-byte fp32 pair or a 4-byte
// bf16 pair, each value rounded to nearest as from_f rounds it
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// A functor that declares `static constexpr bool kStore2 = true` stores its
// own column pair through store2(m, n, a0, a1) (avq.cu's EpiReluDrop, which
// writes two tensors, out and out2); every other functor gives
// value(m, n, acc), which epi_store2 stores into out.
template <class Epi, class = void> struct has_store2 : std::false_type {};
template <class Epi>
struct has_store2<Epi, std::void_t<decltype(Epi::kStore2)>> : std::bool_constant<Epi::kStore2> {};

// the epilogue of columns n and n + 1 of row m, stored together (n even,
// the functor's ldo even)
template <class Epi>
__device__ __forceinline__ void epi_store2(const Epi& epi, int m, int n, float a0, float a1) {
  if constexpr (has_store2<Epi>::value)
    epi.store2(m, n, a0, a1);
  else
    store_pair(epi.out + (long long)m * epi.ldo + n, epi.value(m, n, a0),
               epi.value(m, n + 1, a1));
}

// the paired stores' rule: 8-byte aligned outputs, an even row stride
template <class Epi> inline bool pair_stores_ok(const Epi& epi) {
  uintptr_t out = reinterpret_cast<uintptr_t>(epi.out);
  if constexpr (has_store2<Epi>::value) out |= reinterpret_cast<uintptr_t>(epi.out2);
  return !(out & 7) && !(epi.ldo & 1);
}

// A persistent kernel: each block walks the 128 x BN tiles of C from
// blockIdx.x in steps of gridDim.x (n fastest, so that the blocks in flight
// share their A rows through L2). The producer runs ahead across tile
// boundaries, so the next tile's first slabs load while the consumers apply
// the epilogue of the last one.
template <int BN, class Epi>
__global__ void __launch_bounds__(SM90_THREADS, Sm90Tile<BN>::BLOCKS_PER_SM)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, int M, int N, int K, Epi epi) {
  static_assert(BN == 128 || BN == 256, "tile widths 128 and 256");
  using Cfg = Sm90Tile<BN>;
  constexpr int STAGES = Cfg::STAGES, STAGE = Cfg::STAGE_BYTES;
  extern __shared__ unsigned char sm90_smem[];
  // the 128-byte swizzle repeats every 1 KB: stage bases sit on 1 KB
  unsigned char* base = sm90_smem + ((1024 - (smem_addr(sm90_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int n_tiles = (N + BN - 1) / BN, tiles = (M + SM90_BM - 1) / SM90_BM * n_tiles;
  const int kt_count = (K + SM90_BK - 1) / SM90_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the ring position: stage and the parity of its current use
  int stage = 0, phase = 0;
  auto advance = [&]() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (threadIdx.x >= SM90_PRODUCER) {
    if (threadIdx.x == SM90_PRODUCER) {
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * SM90_BM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < kt_count; ++kt) {
          // a stage's first use passes at once (parity 1 of a fresh barrier)
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);
          unsigned char* st = base + stage * STAGE;
          tma_load_2d(st, &map_a, &full[stage], kt * SM90_BK, m0);
          tma_load_2d(st + Cfg::A_BYTES, &map_b, &full[stage], kt * SM90_BK, n0);
          advance();
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;  // this warpgroup's 64-row half
  const bool signals = (threadIdx.x & 127) == 0;
  // d[i] of thread (warp w, lane l) is row 16 w + l / 4 + 8 ((i / 2) % 2) of
  // the warpgroup's 64 and column 8 (i / 4) + 2 (l % 4) + i % 2 of the tile
  const int t = threadIdx.x & 127, lane = t & 31;
  const int row_off = wg * 64 + (t >> 5) * 16 + (lane >> 2), col_off = (lane & 3) * 2;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;  // each tile's first product overwrites d
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * SM90_BM, n0 = tile % n_tiles * BN;
    int prev = 0;  // the stage of the slab before
    for (int kt = 0; kt < kt_count; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = base + stage * STAGE;
      const uint64_t da = sw128_desc(st + wg * 64 * SM90_BK * 2);
      const uint64_t db = sw128_desc(st + Cfg::A_BYTES);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SM90_BK / 16; ++kk)  // 16 bf16 = 32 bytes = 2 descriptor units
        wgmma_tile<BN>(d, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      wgmma_commit();
      // the products of the slab before are done: its stage goes back to
      // the producer
      wgmma_wait<1>();
      fence_regs(d);
      if (kt > 0 && signals) mbar_arrive(&empty[prev]);
      prev = stage;
      advance();
    }
    wgmma_wait<0>();
    fence_regs(d);
    if (signals) mbar_arrive(&empty[prev]);

    const int row = m0 + row_off, col = n0 + col_off;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      // N is a multiple of 8 on this route, so n < N means n + 1 < N too
      const int m = row + 8 * ((i >> 1) & 1), n = col + (i >> 2) * 8;
      if (m < M && n < N) epi_store2(epi, m, n, d[i], d[i + 1]);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query, so that the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a row-major bf16 or fp32 [rows, cols] with row stride ld
// (elements), read in boxes of box_rows x 128 bytes of columns (64 bf16, 32
// fp32) in 128-byte swizzle, zero past the edges
template <typename T>
inline bool tensor_map_2d(CUtensorMap* map, const T* p, long long ld, int rows, int cols,
                          int box_rows) {
  static_assert(std::is_same<T, __nv_bfloat16>::value || std::is_same<T, float>::value,
                "bf16 or fp32 rows");
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map,
                std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<T*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static int count = 0;
  if (!count) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 0;
  }
  return count;
}

template <int BN, class Epi>
inline cudaError_t gemm_sm90_launch(const __nv_bfloat16* A, long long lda,
                                    const __nv_bfloat16* B, long long ldb, int M, int N,
                                    int K, const Epi& epi, cudaStream_t stream) {
  using Cfg = Sm90Tile<BN>;
  CUtensorMap map_a, map_b;
  if (!tensor_map_2d(&map_a, A, lda, M, K, SM90_BM) || !tensor_map_2d(&map_b, B, ldb, N, K, BN))
    return cudaErrorInvalidValue;
  static bool sized = false;  // once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(gemm_sm90_kernel<BN, Epi>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const long long tiles = (long long)((M + SM90_BM - 1) / SM90_BM) * ((N + BN - 1) / BN);
  const int sms = sm_count();
  if (!sms || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long grid = tiles < (long long)sms * Cfg::BLOCKS_PER_SM
                             ? tiles : (long long)sms * Cfg::BLOCKS_PER_SM;
  gemm_sm90_kernel<BN, Epi><<<(unsigned)grid, SM90_THREADS, Cfg::SMEM, stream>>>(
      map_a, map_b, M, N, K, epi);
  return cudaGetLastError();
}

// C = A B^T on the wgmma route (gemm_route gives GEMM_ROUTE_WGMMA)
template <class Epi>
inline cudaError_t gemm_sm90(const __nv_bfloat16* A, long long lda, const __nv_bfloat16* B,
                             long long ldb, int M, int N, int K, const Epi& epi,
                             cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B);
  if (gemm_route(true, M, N, K) != GEMM_ROUTE_WGMMA || (ptrs & 15) || ((lda | ldb) & 7) ||
      !pair_stores_ok(epi))
    return cudaErrorInvalidValue;
  if (N >= 2304) return gemm_sm90_launch<256>(A, lda, B, ldb, M, N, K, epi, stream);
  return gemm_sm90_launch<128>(A, lda, B, ldb, M, N, K, epi, stream);
}

// C = A B^T for a row-major A (row stride lda) of the fused kernels' type T:
// gemm_sm90 where gemm_route gives wgmma, gemm_tile (gemm) otherwise
template <typename T, class Epi>
inline cudaError_t gemm_rows(const T* A, long long lda, const T* B, long long ldb, int M, int N,
                             int K, const Epi& epi, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (gemm_route(true, M, N, K) == GEMM_ROUTE_WGMMA)
      return gemm_sm90(A, lda, B, ldb, M, N, K, epi, stream);
  }
  gemm<T, true>(RowLoad<T>{A, lda}, B, ldb, M, N, K, epi, stream);
  return cudaGetLastError();
}

// out row 2 f = a0 row f, out row 2 f + 1 = a1 row f (rows of width D): the
// (video, audio) query interleave of PatchSelecter, staged for a TMA load
template <typename T>
__global__ void interleave_rows_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
                                       T* __restrict__ out, int rows, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2LL * rows * D) return;
  const long long r = i / D, c = i % D;
  out[i] = ((r & 1) ? a1 : a0)[(r >> 1) * D + c];
}

}  // namespace
}  // namespace qt
