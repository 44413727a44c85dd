// qt::attention_sm90 ("mma_sm90", route "wgmma"): the bf16 attention past
// 2 AM_K = 128 keys for Hopper (sm_90a), head size 64, with or without an
// additive [Sq, Sk] mask and a [B, Sk] key bias, no keep mask. It replaces,
// for this card, qa_tiger_tpu/ops/pallas/attention.py:351 (the
// pl.pallas_call of fused_attention_wide: _wide_kernel, _wide_nomask_kernel,
// _wide_kb_kernel, _wide_nomask_kb_kernel) at the lengths where the two-pass
// form of attention_mma_kernel (common.cuh) served it: the CLIP image
// tower's 577 tokens (fused_attn_ln2) and ToMe's layers of 152-577 tokens
// (attention_wide, with the key bias from layer 1 on).
//
// The op contract of _wide_body, per (batch element, head): s = q_h k_hᵀ
// scale in fp32, plus the mask and the key bias; the row's max m and sum
// l = Σ exp(s - m) over all keys; p = round_bf16(exp(s - m) / l); ctx =
// round_bf16(Σ p v) summed in fp32. p is rounded from the final max and sum,
// so the online rescaling of a one-pass kernel (which would multiply rounded
// p by later factors) is not this function.
//
// Bound on the H100 at qkv[120, 577, 3072] (16 heads of 64): bytes, 0.1693
// ms (q, k, v read once, the context written once); the tensor work of the
// two passes is 245 GFLOP (0.25 ms at 989 TFLOP/s; 302 GFLOP with the tiles'
// padding to 640 x 640) and the exponentials 2 x 120 x 16 x 577² = 1.28 G
// (≈0.34 ms at 16 ex2 a clock per SM), which the design has to hide behind
// each other. attention_mma_kernel reaches 11% of the byte bound there:
// mma.sync from four warps, 64 query rows a block (19,200 blocks, each
// pulling its head's K twice and V once through L2), a two-stage cp.async
// ring with two block barriers a tile, per-element branches in its score
// code, and exponentials issued by the warps that issue the products. This
// kernel:
// - one persistent block per SM walks the (batch element, head, 128-query
//   tile) tiles, the query tiles of one head next to each other so that
//   their K and V stay in L2 (one block per tile measured slower, PERF.md);
// - one producer warp brings Q (128 rows, double-buffered across tiles), K
//   and V tiles of 128 keys into shared memory by TMA through 3-D tensor
//   maps (lanes, rows, batch elements) with the call's own strides, 128-byte
//   swizzled, zero past Sq and Sk and never into the next element's rows:
//   K twice (one ring of AS9_KSTAGES stages serves both passes, so the next
//   tile's loads run while this one's pass 2 does), V once (AS9_VSTAGES);
//   with a key bias every producer lane copies its share of a K tile's bias
//   by cp.async onto the tile's barrier, so no load stalls the warp; its
//   warpgroup gives registers to the consumers (setmaxnreg);
// - two consumer warpgroups own 64 query rows each; each takes its Q rows
//   into registers once (ldmatrix out of the swizzle) and frees Q's stage,
//   so S = Q Kᵀ runs on wgmma.m64n128k16 with A from registers and only K
//   read from shared memory (K-major: at head size 64 a row is one 128-byte
//   swizzle span); pass 1 keeps each row's running max and rescaled sum
//   (trees over a thread's 32 scores of a row, then the 4 lanes of the
//   row); pass 2 computes S again, forms p from the final max and sum,
//   rounds it to bf16 in the registers that wgmma's accumulator layout
//   shares with its A operand, and issues P V (wgmma.m64n64k16, P from
//   registers, V read MN-major through a transposed descriptor) together
//   with the next tile's S, so that they run while it waits;
// - warps whose 16 rows lie past Sq and 8-key chunks past Sk skip their
//   exponentials; the score code is compiled per case (mask, key bias, the
//   edge tile), so an interior tile runs no key test and no branch; the
//   scale rides on the exponent's FMA; the division by the row's sum is
//   folded into the exponent (exp(s - m - ln l)), the same p to a few fp32
//   ulps, far below its bf16 rounding;
// - the mask is read by the thread that owns each score, once a pass; the
//   context leaves from the accumulators as bf16 pairs.
// The exponentials are base 2 of s scale log2e, as attention_mma_kernel
// takes them, on exp2f's instruction without its subnormal range; sums run
// in another order. No score or probability reaches device memory. A row
// whose keys are all masked to -inf gives NaN, as attention_mma_kernel does.
// Measured on the H100 (PERF.md): 0.93 ms at qkv[120, 577], under
// attention_mma_kernel's 1.53; what holds it above its bound is the
// products' issue (a warpgroup's wgmma waits on the tensor cores the other
// warpgroup keeps busy) and pass 1's exponentials, which each warpgroup runs
// after its own products. Pipelining two score buffers in a warpgroup, a
// ping-pong order between the warpgroups, K resident across query tiles and
// 64-key steps each ran no faster on the H100. Its 128-row and 128-key
// tiles pay a whole tile for a partial one, so the plan keeps the short
// lengths where attention_mma_kernel's 64-row tiles win (sm90_faster).
//
// Needs 16-byte aligned q, k, v and out and batch and row strides that are
// multiples of 8 elements (TMA's rule, tc_aligned); a call that breaks it, a
// tensor map the driver refuses or a launch the device refuses returns an
// error, and nothing falls back to another kernel.
#pragma once

#include "gemm_sm90.cuh"

namespace qt {
namespace {

static_assert(AS9_SMEM == 1024 + (size_t)(2 * AS9_Q + (AS9_KSTAGES + AS9_VSTAGES) * AS9_K) * 128 +
                              (size_t)AS9_KSTAGES * AS9_K * 4 +
                              8 * (size_t)(2 * 2 + 2 * AS9_KSTAGES + 2 * AS9_VSTAGES),
              "the plan's shared memory is the kernel's layout");

// one 3-D box (c0: lanes, c1: rows, c2: batch element) into shared memory,
// completion counted in bytes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// mbar_wait with a guard: a phase still open after 2^34 clocks (about ten
// seconds) traps, so that a fault in the ring ends the launch with an error
// instead of holding the card
__device__ __forceinline__ void as9_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// d (64 x 64 fp32, wgmma's C layout) += A (64 x 16 bf16, registers in the
// A fragment layout) B (16 x 64), B MN-major (N contiguous) in
// 128-byte-swizzled shared memory: the transposed descriptor wgmma takes for
// 16-bit types
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128 fp32, wgmma's C layout) (+)= A (64 x 16 bf16, registers in
// the A fragment layout) B (16 x 128), B K-major in 128-byte-swizzled
// shared memory. FIRST: scale_d 0 and d written only, so that its old values
// need not stay live until a key tile's first product.
template <bool FIRST>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
          "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
          "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]),
          "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
          "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
          "=f"(d[62]), "=f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

// keeps the registers of an A operand live until the products that read
// them asynchronously have completed
template <int R, int C> __device__ __forceinline__ void fence_regs(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 4 bytes global -> shared by cp.async, zero-filled where !valid (src is then
// not read), and the arrival on bar that this thread's copies complete
// (noinc: the barrier's count includes it)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// two consumer warpgroups, then the producer warpgroup, whose first warp
// issues the loads and which gives registers to the consumers
constexpr int AS9_THREADS = 384, AS9_PRODUCER = 256;
constexpr int AS9_PRODUCER_REGS = 40, AS9_CONSUMER_REGS = 232;
static_assert(128 * AS9_PRODUCER_REGS + 256 * AS9_CONSUMER_REGS <= 65536, "the register file");

constexpr int AS9_TILE_BYTES = AS9_K * 128;  // 128 rows of 64 bf16 lanes

// the ex2 of exp2f without its subnormal range (ex2.approx.ftz): a result
// below 2^-126 is 0, a probability far below anything bf16 keeps beside the
// row's largest
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The shared-memory layout, from a 1 KB aligned base: Q[2], K[AS9_KSTAGES],
// V[AS9_VSTAGES] tiles of 128 rows x 128 bytes, the key bias of each K
// stage, then the barriers
struct As9Smem {
  unsigned char* base;
  __device__ unsigned char* q(int i) const { return base + i * AS9_TILE_BYTES; }
  __device__ unsigned char* k(int i) const { return base + (2 + i) * AS9_TILE_BYTES; }
  __device__ unsigned char* v(int i) const {
    return base + (2 + AS9_KSTAGES + i) * AS9_TILE_BYTES;
  }
  __device__ float* kb(int i) const {
    return reinterpret_cast<float*>(base + (2 + AS9_KSTAGES + AS9_VSTAGES) * AS9_TILE_BYTES) +
           i * AS9_K;
  }
  __device__ uint64_t* bars() const { return reinterpret_cast<uint64_t*>(kb(AS9_KSTAGES)); }
};

// A ring position: stage and the parity of its current use
template <int N> struct Ring {
  int stage = 0, phase = 0;
  __device__ void advance() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int HD, bool HAS_MASK, bool HAS_KB>
__global__ void __launch_bounds__(AS9_THREADS, 1)
attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                      long long o_bs, long long o_ss, const float* __restrict__ mask,
                      const float* __restrict__ key_bias, int B, int Sq, int Sk, int heads,
                      float scale) {
  static_assert(HD == 64, "a row of one 128-byte swizzle span");
  static_assert(AS9_Q == 128 && AS9_K == 128, "two warpgroups of 64 rows, 128-key tiles");
  extern __shared__ unsigned char as9_smem[];
  const As9Smem sm{as9_smem + ((1024 - (smem_addr(as9_smem) & 1023)) & 1023)};
  uint64_t* qfull = sm.bars();
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* kempty = kfull + AS9_KSTAGES;
  uint64_t* vfull = kempty + AS9_KSTAGES;
  uint64_t* vempty = vfull + AS9_VSTAGES;

  const int ntq = (Sq + AS9_Q - 1) / AS9_Q, nkt = (Sk + AS9_K - 1) / AS9_K;
  const int tiles = B * heads * ntq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);   // the producer's expect_tx arrival
      mbar_init(&qempty[i], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < AS9_KSTAGES; ++i) {
      // with a key bias also the producer lanes' cp.async arrivals
      mbar_init(&kfull[i], HAS_KB ? 33 : 1);
      mbar_init(&kempty[i], 8);
    }
    for (int i = 0; i < AS9_VSTAGES; ++i) {
      mbar_init(&vfull[i], 1);
      mbar_init(&vempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Ring<2> qr;
  Ring<AS9_KSTAGES> kr;
  Ring<AS9_VSTAGES> vr;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= AS9_PRODUCER) {
    // the producer warp: lane 0 issues the tensor copies; with a key bias
    // every lane copies its share of a K tile's bias by cp.async, which
    // completes on the tile's barrier, so no load stalls the warp. Each
    // tile: Q, its K tiles for pass 1, then K and V tile by tile for pass 2.
    // The warpgroup's other three warps leave.
    setmaxnreg_dec<AS9_PRODUCER_REGS>();
    if (threadIdx.x >= AS9_PRODUCER + 32) return;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int qtile = tile % ntq, bh = tile / ntq, h = bh % heads, b = bh / heads;
      as9_wait(&qempty[qr.stage], qr.phase ^ 1);  // a fresh barrier passes parity 1
      if (lane == 0) {
        mbar_expect_tx(&qfull[qr.stage], AS9_TILE_BYTES);
        tma_load_3d(sm.q(qr.stage), &map_q, &qfull[qr.stage], h * HD, qtile * AS9_Q, b);
      }
      qr.advance();
      auto load_k = [&](int i) {
        as9_wait(&kempty[kr.stage], kr.phase ^ 1);
        if constexpr (HAS_KB) {
          const float* kbr = key_bias + (long long)b * Sk;
          float* dst = sm.kb(kr.stage);
#pragma unroll
          for (int j = 0; j < AS9_K / 32; ++j) {
            const int kj = i * AS9_K + 32 * j + lane;
            cp_async4(dst + 32 * j + lane, kbr + min(kj, Sk - 1), kj < Sk);
          }
          cp_async_arrive(&kfull[kr.stage]);
        }
        if (lane == 0) {
          mbar_expect_tx(&kfull[kr.stage], AS9_TILE_BYTES);
          tma_load_3d(sm.k(kr.stage), &map_k, &kfull[kr.stage], h * HD, i * AS9_K, b);
        }
        kr.advance();
      };
      for (int i = 0; i < nkt; ++i) load_k(i);
      for (int i = 0; i < nkt; ++i) {
        load_k(i);
        as9_wait(&vempty[vr.stage], vr.phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&vfull[vr.stage], AS9_TILE_BYTES);
          tma_load_3d(sm.v(vr.stage), &map_v, &vfull[vr.stage], h * HD, i * AS9_K, b);
        }
        vr.advance();
      }
    }
    return;
  }

  // a consumer warpgroup: wg's 64 rows of the tile; s[i] of thread (warp w,
  // lane l) is row 16 w + l / 4 + 8 ((i / 2) % 2) of them and key
  // 8 (i / 4) + 2 (l % 4) + i % 2 of the tile (wgmma's C layout), which is
  // also the A fragment layout of P V: keys 16 c .. 16 c + 15 of P are
  // s[8 c .. 8 c + 7], packed in pairs
  setmaxnreg_inc<AS9_CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, t4 = lane & 3;
  // a score x of this kernel, times mul, is in base 2: without a mask or a
  // key bias x is the raw product (the scale rides on the exponent's FMA),
  // else x = s scale + mask + key bias
  constexpr bool RAW = !HAS_MASK && !HAS_KB;
  const float mul = RAW ? scale * LOG2E : LOG2E;
  float s[64], o[32];
  uint32_t qf[HD / 16][4], pa[8][4];

  // issues S = Q Kᵀ of one key tile into s, Q from registers (the first
  // product overwrites s)
  auto qk_issue = [&](const unsigned char* kt) {
    const uint64_t dk = sw128_desc(kt);
    wgmma_fence();
    wgmma_m64n128k16_rs<true>(s, qf[0], dk);
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk)  // 16 bf16 = 32 bytes = 2 descriptor units
      wgmma_m64n128k16_rs<false>(s, qf[kk], dk + 2 * kk);
    wgmma_commit();
  };
  // issues O += P V of one key tile (V in vt, P in pa)
  auto pv_issue = [&](const unsigned char* vt) {
    const uint64_t dv = sw128_desc(vt);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < AS9_K / 16; ++c)  // 16 keys = 16 rows of 128 bytes = 128 units
      wgmma_m64n64k16_rs_mn(o, pa[c], dv + 128 * c);
    wgmma_commit();
  };
  // this warp's part of a stage is read: one arrival of the 8 a stage waits for
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int qtile = tile % ntq, bh = tile / ntq, h = bh % heads, b = bh / heads;
    const int row_w = qtile * AS9_Q + wg * 64 + warp * 16;  // this warp's first row
    const int r0 = row_w + (lane >> 2), r1 = r0 + 8;        // this thread's two rows
    // a warp whose 16 rows lie past Sq joins the products and computes nothing
    const bool live = row_w < Sq;
    // mask rows (a row past Sq reads row Sq - 1: its context is not stored)
    const float* mrow0 = HAS_MASK ? mask + (long long)min(r0, Sq - 1) * Sk : nullptr;
    const float* mrow1 = HAS_MASK ? mask + (long long)min(r1, Sq - 1) * Sk : nullptr;

    // A tile's products to scores x (keys k0 .. k0 + 127, the key bias of K
    // stage `stage`); in the last tile (EDGE) keys past Sk are -inf.
    // Branch-free: the mask and the key bias are compiled in or out, and
    // only the edge tile tests key indices.
    auto scores = [&](auto edge, int stage, int k0) {
      constexpr bool EDGE = decltype(edge)::value;
      const float* kbt = sm.kb(stage);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t4;
        float2 bias = make_float2(0.0f, 0.0f);
        if constexpr (HAS_KB) bias = *reinterpret_cast<const float2*>(kbt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + c + (e & 1);
          float y = s[4 * j + e];
          if constexpr (!RAW) {
            float add = HAS_KB ? ((e & 1) ? bias.y : bias.x) : 0.0f;
            if constexpr (HAS_MASK)
              add += __ldg(((e >> 1) ? mrow1 : mrow0) + (EDGE ? min(kj, Sk - 1) : kj));
            y = fmaf(y, scale, add);
          }
          if constexpr (EDGE) y = kj < Sk ? y : -INFINITY;
          s[4 * j + e] = y;
        }
      }
    };
    // pass 1 on one tile: per row the running max (times mul) and this
    // thread's part of the sum rescaled to it (the row's sum is the 4 parts'
    // total); in the edge tile the 8-key chunks past Sk (nch on) add nothing
    // and are skipped. The max and the sum are trees over the thread's 32
    // scores of a row, so that their adds do not wait on each other.
    auto row_stats = [&](auto edge, int stage, int k0, float (&m)[2], float (&l)[2]) {
      constexpr bool EDGE = decltype(edge)::value;
      scores(edge, stage, k0);
      const int nch = EDGE ? (Sk - k0 + 7) / 8 : 16;
      float mx[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx[r][j] = fmaxf(fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]),
                           fmaxf(s[4 * (j + 8) + 2 * r], s[4 * (j + 8) + 2 * r + 1]));
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < w; ++j) mx[r][j] = fmaxf(mx[r][j], mx[r][j + w]);
      float mn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) mn[r] = fmaxf(m[r], quad_max(mx[r][0]) * mul);
      float part[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[r][j] = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (!EDGE || j < nch)
            part[r][j & 7] += ex2_ftz(fmaf(s[4 * j + 2 * r], mul, -mn[r])) +
                              ex2_ftz(fmaf(s[4 * j + 2 * r + 1], mul, -mn[r]));
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < w; ++j) part[r][j] += part[r][j + w];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (mn[r] == -INFINITY) continue;  // every key so far masked out
        l[r] = fmaf(l[r], ex2_ftz(m[r] - mn[r]), part[r][0]);
        m[r] = mn[r];
      }
    };
    // pass 2 on one tile: p = exp(s - m) / l, the division folded into the
    // exponent (ml = m + log2 l), rounded to bf16 as it is packed into P's A
    // fragments (keys 16 c .. 16 c + 15 in pa[c])
    auto probs = [&](auto edge, int stage, int k0, const float (&ml)[2]) {
      constexpr bool EDGE = decltype(edge)::value;
      scores(edge, stage, k0);
      const int nch = EDGE ? (Sk - k0 + 7) / 8 : 16;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * c + 2 * r, row = r & 1;
          const bool in = !EDGE || 2 * c + (r >> 1) < nch;
          pa[c][r] = in ? pack_bf16(ex2_ftz(fmaf(s[i], mul, -ml[row])),
                                    ex2_ftz(fmaf(s[i + 1], mul, -ml[row])))
                        : 0u;
        }
    };

    // Q's fragments into registers (16-byte rows read out of the 128-byte
    // swizzle: chunk c of row r lies at chunk c ^ (r % 8)); then Q's stage
    // goes back to the producer
    as9_wait(&qfull[qr.stage], qr.phase);
    {
      const int r = wg * 64 + warp * 16 + (lane & 15);
      const unsigned char* qrow = sm.q(qr.stage) + r * 128;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], qrow + (((2 * kk + (lane >> 4)) ^ (r & 7)) << 4));
    }
    release(&qempty[qr.stage]);
    qr.advance();
    const bool edge = nkt * AS9_K > Sk;  // the last tile passes Sk

    // pass 1: each row's max and sum over all key tiles
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    for (int i = 0; i < nkt; ++i) {
      as9_wait(&kfull[kr.stage], kr.phase);
      qk_issue(sm.k(kr.stage));
      wgmma_wait<0>();
      fence_regs(s);
      if (live) {
        if (edge && i == nkt - 1)
          row_stats(std::true_type{}, kr.stage, i * AS9_K, m, l);
        else
          row_stats(std::false_type{}, kr.stage, i * AS9_K, m, l);
      }
      release(&kempty[kr.stage]);
      kr.advance();
    }
    // p = exp(s - m) / l as one exponential: m takes log2 l on
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ml[r] = m[r] + __log2f(quad_sum(l[r]));

    // pass 2: S again, p from the final max and sum, then P V. Step i waits
    // for tile i's scores and the P V of tile i - 1, forms P, then issues
    // its P V and the products of tile i + 1 together (tile i's scores are
    // spent in P).
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    as9_wait(&kfull[kr.stage], kr.phase);
    qk_issue(sm.k(kr.stage));
    Ring<AS9_VSTAGES> v_prev = vr;
    for (int i = 0; i < nkt; ++i) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(o);
      fence_regs(pa);
      if (i > 0) release(&vempty[v_prev.stage]);  // the P V of tile i - 1 is done
      if (!live) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[c][r] = 0u;
      } else if (edge && i == nkt - 1) {
        probs(std::true_type{}, kr.stage, i * AS9_K, ml);
      } else {
        probs(std::false_type{}, kr.stage, i * AS9_K, ml);
      }
      release(&kempty[kr.stage]);
      kr.advance();
      as9_wait(&vfull[vr.stage], vr.phase);
      if (i + 1 < nkt) as9_wait(&kfull[kr.stage], kr.phase);
      pv_issue(sm.v(vr.stage));
      if (i + 1 < nkt) qk_issue(sm.k(kr.stage));
      v_prev = vr;
      vr.advance();
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(&vempty[v_prev.stage]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r ? r1 : r0;
      if (qi >= Sq) continue;
      __nv_bfloat16* orow = out + (long long)b * o_bs + (long long)qi * o_ss + h * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
    }
  }
}

// the map of a bf16 [B, S, W] operand (row stride ss, batch stride bs
// elements), read in boxes of 64 lanes (128 bytes) x AS9_K rows x one batch
// element in 128-byte swizzle, zero past S and W
inline bool tensor_map_3d(CUtensorMap* map, const __nv_bfloat16* p, int W, int S, int B,
                          long long ss, long long bs) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  if (B == 1) bs = (long long)S * ss;  // any valid stride: the dimension has one element
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ss * sizeof(__nv_bfloat16),
                                 (cuuint64_t)bs * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)AS9_K, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(p), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// the measurement switch (attention_sm90_mode in common.cuh)
static int g_attention_sm90_mode = ATT_SM90_DEFAULT;
int attention_sm90_mode() { return g_attention_sm90_mode; }
void set_attention_sm90_mode(int mode) { g_attention_sm90_mode = mode; }

cudaError_t attention_sm90(const __nv_bfloat16* q, long long q_bs, long long q_ss,
                           const __nv_bfloat16* k, long long k_bs, long long k_ss,
                           const __nv_bfloat16* v, long long v_bs, long long v_ss,
                           __nv_bfloat16* out, long long o_bs, long long o_ss, const float* mask,
                           const float* key_bias, int B, int Sq, int Sk, int heads, int hd,
                           float scale, cudaStream_t stream) {
  if (hd != 64 || !tc_aligned(q, k, v, out, q_bs | q_ss | k_bs | k_ss | v_bs | v_ss | o_bs | o_ss))
    return cudaErrorInvalidValue;
  const int W = heads * hd;
  CUtensorMap map_q, map_k, map_v;
  if (!tensor_map_3d(&map_q, q, W, Sq, B, q_ss, q_bs) ||
      !tensor_map_3d(&map_k, k, W, Sk, B, k_ss, k_bs) ||
      !tensor_map_3d(&map_v, v, W, Sk, B, v_ss, v_bs))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)B * heads * ((Sq + AS9_Q - 1) / AS9_Q);
  const int sms = sm_count();
  if (!sms || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : (long long)sms);
  // the mask and the key bias compiled in or out
  auto launch = [&](auto kernel, bool& done) {
    if (!done) {  // once per instantiation
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)AS9_SMEM);
      if (err != cudaSuccess) return err;
      done = true;
    }
    kernel<<<grid, AS9_THREADS, AS9_SMEM, stream>>>(map_q, map_k, map_v, out, o_bs, o_ss, mask,
                                                    key_bias, B, Sq, Sk, heads, scale);
    return cudaGetLastError();
  };
  static bool sized[4] = {false, false, false, false};
  if (mask && key_bias) return launch(attention_sm90_kernel<64, true, true>, sized[3]);
  if (mask) return launch(attention_sm90_kernel<64, true, false>, sized[2]);
  if (key_bias) return launch(attention_sm90_kernel<64, false, true>, sized[1]);
  return launch(attention_sm90_kernel<64, false, false>, sized[0]);
}

}  // namespace qt
