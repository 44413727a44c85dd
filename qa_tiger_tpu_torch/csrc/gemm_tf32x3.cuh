// qt::gemm_tf32x3: an fp32 GEMM on the TF32 tensor cores at about fp32
// accuracy, C[m, n] = sum_k A(m, k) B(k, n), fp32 in, fp32 accumulation, the
// result handed element by element to one of the epilogue functors of
// common.cuh (EpiStoreF32, EpiBias, ...), so every rounding point stays where
// gemm_tile put it.
//
// Replaces the fp32 products of the two train kernels, forward and
// backward: _kernel_train / _kernel_bwd of qa_tiger_tpu/ops/pallas/
// patch_select.py (pallas_call :827, :880) and _kernel_fwd / _kernel_bwd of
// qa_tiger_tpu/ops/pallas/avq.py (pallas_call :532, :558), which run on
// patch_select_train.cu and avq.cu forward<float> and backward<float>; of
// the eval PatchSelecter's _kernel (patch_select.py pallas_call :738,
// patch_select.cu run<float> and its tensor-parallel stages); of the fp32
// attention halves (resblock.py pallas_call :391, :329: resblock.cu ln_qkv
// and out_proj); and of the MoE's second product (gaussian_moe.py :107).
//
// Bound on the H100: operations. At B=32 the PatchSelecter backward's 14
// products are ~181 GFLOP against ~0.5 GB of operands, and the CLIP image
// tower's qkv projection (69,240 x 3,072 x 1,024) is 436 GFLOP against
// ~1.1 GB. The TF32 tensor cores give 495 TFLOP/s dense but keep 10
// mantissa bits; the card's fp32 FMA peak is 67. This routine:
// - splits each operand x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi)
//   (cvt.rna.tf32.f32: round to nearest, ties away from zero), and sums
//   lo·hi + hi·lo + hi·hi per k step of 8 (small terms first). The dropped
//   lo·lo term is below 2^-22 of a product, so the sum keeps about fp32's
//   accuracy at a third of the TF32 rate (165 TFLOP/s); no product runs
//   single-pass TF32;
// - sums each K slab (TF_BK = 32 deep: 12 products) on the tensor cores into
//   a fresh fragment (the slab's first product with scale-d 0) and, once
//   wgmma.wait_group says it is done, adds it to the fp32 accumulator with
//   IEEE adds: the tensor cores' own accumulation does not round to
//   nearest, and one chain over 26,880 rows drifted by 2e-4 of the result
//   on the card, past the train kernels' 1e-4 rule, where a chain of 12
//   products per slab does not;
// - is a Hopper kernel (sm_90a): one persistent block per SM walks the
//   128 x 128 output tiles and split-K chunks; one producer warp keeps TMA
//   loads of the raw fp32 A and B slabs (128 rows x 128 bytes, 128-byte
//   swizzle, zero past M, N and K) in flight into a ring of TFW_STAGES
//   stages (a full and an empty mbarrier each); two consumer warpgroups own
//   64 rows each and run wgmma.m64n128k8.f32.tf32.tf32;
// - takes all four layouts of its callers. wgmma reads a tf32 B only
//   K-major from shared memory, and neither B as [K, N] (a dgrad's weight,
//   a weight gradient's X) nor a column-major A (a weight gradient's G) is.
//   So the consumers split each staged B slab once a block (not once a
//   warp) into hi and lo tiles, K-major in the 128-byte swizzle the wgmma
//   descriptor reads, transposing on the way where B is [K, N] (each thread
//   moves a 4 x 4 block, the blocks given to the lanes on a diagonal so that
//   both the MN-major reads and the K-major writes of 16 bytes are free of
//   bank conflicts); A takes wgmma's register form: each thread reads its
//   fragment straight from the staged tile in either layout and splits it
//   in registers, so A needs no transposing write. B's split of the next
//   slab runs while the tensor cores work on this one (two hi/lo buffers);
// - cuts K into S chunks (split-K) where the output has too few tiles to
//   fill the SMs once (every weight gradient: 512 x 512 is 16 tiles, K the
//   26,880 patch rows): each chunk's fp32 partial tile goes to a workspace
//   [S, M, N], and a second pass adds the S partials in a fixed order and
//   applies the epilogue. No atomics: bitwise deterministic. The caller
//   plans the chunks (ops/gemm.py splitk_plan, handed to a planned launch
//   in its GemmPlan) and allocates the workspace; the routine allocates
//   nothing.
//
// Needs 16-byte aligned A and B and leading dimensions that are multiples of
// 4 floats (TMA's 16-byte rule); M, N and K may be ragged. A call that
// breaks that, whose split-K plan needs more workspace than it was given,
// or whose tensor maps cuTensorMapEncodeTiled refuses, returns
// cudaErrorInvalidValue; nothing falls back to another kernel. Every fp32
// product of the two train kernels, of the eval PatchSelecter, of the fp32
// attention halves and the MoE's second product takes this routine: their
// leading dimensions are D, 2D, 3D, D/2, 4W and their shares under tensor
// parallelism.
#pragma once

#include "gemm_sm90.cuh"

namespace qt {
namespace {

// The output tile and K slab of gemm_tf32x3 (ops/gemm.py TF32X3_TILE holds
// the same, for the split-K plan)
constexpr int TF_BM = 128, TF_BN = 128, TF_BK = 32;

// gemm_tf32x3's kernel: two consumer warpgroups (threads 0-255), then the
// producer warpgroup, whose first warp issues the loads and which gives
// registers to the consumers (the accumulator, the slab's fragment and the
// A fragments are 160 a thread). Shared memory, from a 1 KB aligned base: a
// ring of TFW_STAGES raw stages (A, then B: 128 rows x 128 bytes each), two
// hi/lo buffers of B (hi, then lo), the full and empty barriers.
constexpr int TFW_STAGES = 4, TFW_THREADS = 384, TFW_PRODUCER = 256;
constexpr int TFW_PRODUCER_REGS = 40, TFW_CONSUMER_REGS = 232;
static_assert(128 * TFW_PRODUCER_REGS + 256 * TFW_CONSUMER_REGS <= 65536, "the register file");
constexpr int TFW_TILE = 128 * TF_BK;  // floats of one 128 x 32 tile: 16 KB
constexpr int TFW_SMEM = 1024 + (2 * TFW_STAGES + 4) * TFW_TILE * 4 + 2 * TFW_STAGES * 8;
static_assert(TFW_SMEM <= 232448, "one block's shared memory on an H100");
static_assert(TF_BM == 128 && TF_BN == 128 && TF_BK == 32,
              "two warpgroups of 64 rows, m64n128k8, a slab row of one 128-byte swizzle span");

// float offset of element (r, k) of a tile of 128 rows r x 32 k in 128-byte
// swizzle (K-major: a row of 128 bytes holds 32 k; the 16-byte chunk k / 4
// sits at chunk (k / 4) ^ (r % 8)): what a TMA box {32, 128} of a
// row-major [rows, K] matrix lands as, and what wgmma's descriptor reads
__device__ __forceinline__ int tfw_kmajor(int r, int k) {
  return r * 32 + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}
// the same element in a tile of four 32-row boxes {32, 32} of a matrix
// whose rows are k (MN-major: A column-major, B as [K, N]): box r / 32,
// k-row k, chunk (r % 32) / 4 at ((r % 32) / 4) ^ (k % 8)
__device__ __forceinline__ int tfw_mnmajor(int r, int k) {
  return (r >> 5) * 1024 + k * 32 + ((((r >> 2) ^ k) & 7) << 2) + (r & 3);
}

// d (64 x 128 fp32, wgmma's C layout) += A (64 x 8 tf32, registers in the
// A fragment layout: a[0] (row g, k t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4) of the warp's 16 rows) B (8 x 128 tf32, K-major in
// 128-byte-swizzled shared memory); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// keeps the compiler from reusing the registers of A fragments that an
// asynchronous product may still read (placed after its wait)
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

__device__ __forceinline__ float4 tfw_split4(float4 v, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

// An epilogue functor with `static constexpr bool after_pass = true` is
// applied by the split-K pass alone, at one chunk too: inlined at each of
// a thread's 64 sums beside the accumulator, a functor with a loop of its
// own (the MoE's output: the bias term over the experts) made ptxas spill
// the kernel's registers
template <class Epi, class = void> struct AfterPass : std::false_type {};
template <class Epi>
struct AfterPass<Epi, std::void_t<decltype(Epi::after_pass)>>
    : std::integral_constant<bool, Epi::after_pass> {};

// A persistent kernel over works = output tiles x split-K chunks (chunk
// index outermost; n fastest inside, so that the blocks in flight share
// their A rows through L2). With ws null the epilogue applies directly;
// else the raw sums of chunk s go to ws[s][m][n].
template <bool A_COL, bool B_NK, class Epi>
__global__ void __launch_bounds__(TFW_THREADS, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, int M, int N, int K, int chunk,
                   Epi epi, float* __restrict__ ws) {
  extern __shared__ unsigned char tfw_smem[];
  float* base = reinterpret_cast<float*>(tfw_smem + ((1024 - (smem_addr(tfw_smem) & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (2 * TFW_STAGES + 4) * TFW_TILE);
  uint64_t* empty = full + TFW_STAGES;

  const int n_tiles = (N + TF_BN - 1) / TF_BN, tiles = (M + TF_BM - 1) / TF_BM * n_tiles;
  const int works = tiles * ((K + chunk - 1) / chunk);

  if (threadIdx.x == 0) {
    for (int s = 0; s < TFW_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 1);  // one consumer thread, after both warpgroups read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the ring position: stage and the parity of its current use
  int stage = 0, phase = 0;
  auto advance = [&]() {
    if (++stage == TFW_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (threadIdx.x >= TFW_PRODUCER) {
    setmaxnreg_dec<TFW_PRODUCER_REGS>();
    if (threadIdx.x == TFW_PRODUCER) {
      for (int w = blockIdx.x; w < works; w += gridDim.x) {
        const int tile = w % tiles, kb = w / tiles * chunk;
        const int m0 = tile / n_tiles * TF_BM, n0 = tile % n_tiles * TF_BN;
        const int ke = K - kb < chunk ? K : kb + chunk;
        for (int k0 = kb; k0 < ke; k0 += TF_BK) {
          // a stage's first use passes at once (parity 1 of a fresh barrier)
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * TFW_TILE * 4);
          float* sa = base + stage * 2 * TFW_TILE;
          float* sb = sa + TFW_TILE;
          if (A_COL) {
#pragma unroll
            for (int j = 0; j < 4; ++j) tma_load_2d(sa + j * 1024, &map_a, &full[stage], m0 + 32 * j, k0);
          } else {
            tma_load_2d(sa, &map_a, &full[stage], k0, m0);
          }
          if (B_NK) {
            tma_load_2d(sb, &map_b, &full[stage], k0, n0);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) tma_load_2d(sb + j * 1024, &map_b, &full[stage], n0 + 32 * j, k0);
          }
          advance();
        }
      }
    }
    return;
  }

  setmaxnreg_inc<TFW_CONSUMER_REGS>();
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's first A row of the tile (r0 + 8 the other)
  // the B split's share of this thread: in K-major, 16-byte chunks tid + 256 j;
  // in MN-major, the 4 x 4 block (k 4 q .., n 32 jb + 4 c ..), c = q + d (mod 8)
  const int jb = tid >> 6, bq = tid & 7, bc = (((tid & 63) >> 3) + bq) & 7;
  float acc[64], part[64];
  uint32_t ah[4][4], al[4][4];  // the slab's A fragments, k step kk = 8 kk ..
  // split the staged B slab into the hi and lo tiles wgmma reads
  auto split_b = [&](const float* sb, float* hi, float* lo) {
    if (B_NK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tid + 256 * j;
        float4 l;
        const float4 h = tfw_split4(reinterpret_cast<const float4*>(sb)[c], l);
        reinterpret_cast<float4*>(hi)[c] = h;
        reinterpret_cast<float4*>(lo)[c] = l;
      }
    } else {
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * bq + i;
        const float4 x =
            *reinterpret_cast<const float4*>(sb + jb * 1024 + k * 32 + ((bc ^ (k & 7)) << 2));
        v[i][0] = x.x;
        v[i][1] = x.y;
        v[i][2] = x.z;
        v[i][3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * jb + 4 * bc + j, at = n * 32 + ((bq ^ (n & 7)) << 2);
        float4 l;
        const float4 h = tfw_split4(make_float4(v[0][j], v[1][j], v[2][j], v[3][j]), l);
        *reinterpret_cast<float4*>(hi + at) = h;
        *reinterpret_cast<float4*>(lo + at) = l;
      }
    }
  };
  auto a_at = [](int r, int k) { return A_COL ? tfw_mnmajor(r, k) : tfw_kmajor(r, k); };
  // this thread's A fragments of the staged slab: read while the slab
  // before still runs on the tensor cores, split once it is done
  float araw[4][4];
  auto load_a = [&](const float* sa) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 8 * kk + t4;
      araw[kk][0] = sa[a_at(r0, k)];
      araw[kk][1] = sa[a_at(r0 + 8, k)];
      araw[kk][2] = sa[a_at(r0, k + 4)];
      araw[kk][3] = sa[a_at(r0 + 8, k + 4)];
    }
  };
  // the slab's 12 products into a fresh part: per k step lo·hi, hi·lo, hi·hi
  auto issue = [&](const float* hi, const float* lo) {
    const uint64_t dh = sw128_desc(hi), dl = sw128_desc(lo);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 8 tf32 = 32 bytes = 2 descriptor units
      wgmma_m64n128k8_tf32(part, al[kk], dh + 2 * kk, kk > 0);
      wgmma_m64n128k8_tf32(part, ah[kk], dl + 2 * kk, 1);
      wgmma_m64n128k8_tf32(part, ah[kk], dh + 2 * kk, 1);
    }
    wgmma_commit();
  };
  // the slab in flight is done: its sums into acc by IEEE adds
  auto fold = [&]() {
    wgmma_wait<0>();
    fence_regs(part);
    fence_frags(ah);
    fence_frags(al);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  };
  int slab = 0;  // slabs this block has run: the hi/lo buffer is slab % 2
  const float* sa;
  float *hi, *lo;
  // the next slab staged: B split into its hi/lo buffer (whose last reader,
  // the slab two back, both warpgroups waited for before the last barrier),
  // this thread's A fragments read
  auto prepare = [&]() {
    mbar_wait(&full[stage], phase);
    sa = base + stage * 2 * TFW_TILE;
    hi = base + (2 * TFW_STAGES + 2 * (slab++ & 1)) * TFW_TILE;
    lo = hi + TFW_TILE;
    split_b(sa + TFW_TILE, hi, lo);
    load_a(sa);
  };
  // its A fragments split and its products issued, once every consumer
  // thread has written its hi/lo share (made visible to wgmma, the async
  // proxy) and is done with the stage, which goes back to the producer
  auto launch = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(araw[kk][e], ah[kk][e], al[kk][e]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (tid == 0) mbar_arrive(&empty[stage]);
    advance();
    issue(hi, lo);
  };

  for (int w = blockIdx.x; w < works; w += gridDim.x) {
    const int tile = w % tiles, split = w / tiles, kb = split * chunk;
    const int m0 = tile / n_tiles * TF_BM, n0 = tile % n_tiles * TF_BN;
    const int ke = K - kb < chunk ? K : kb + chunk;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    prepare();
    launch();
    for (int k0 = kb + TF_BK; k0 < ke; k0 += TF_BK) {
      prepare();  // while the slab before runs
      fold();
      launch();
    }
    fold();

    float* slice = ws ? ws + (long long)split * M * N : nullptr;
    // the output's coordinates, opaque to the compiler, so that it computes
    // no epilogue address before the K loop and holds it across the loop
    int row = m0 + r0, col = n0 + 2 * t4;
    asm volatile("" : "+r"(row), "+r"(col));
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      // d[i]: row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t4 + i % 2
      const int m = row + 8 * ((i >> 1) & 1), n = col + 8 * (i >> 2) + (i & 1);
      if (m < M && n < N) {
        if (AfterPass<Epi>::value || slice)
          slice[(long long)m * N + n] = acc[i];
        else
          epi(m, n, acc[i]);
      }
    }
  }
}

// out(m, n) = epi(sum over s = 0 .. S-1 of ws[s][m][n]), summed in that order
template <class Epi>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, int S, int M, int N, Epi epi) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float s = ws[i];
  for (int p = 1; p < S; ++p) s += ws[p * mn + i];
  epi((int)(i / N), (int)(i % N), s);
}

// C = A B through epi, K cut into chunks of `chunk` rows (a positive
// multiple of TF_BK; chunk >= K: no split); more than one chunk, or an
// after_pass epilogue, needs ws with room for chunks * M * N floats. The
// caller plans the chunk (ops/gemm.py splitk_plan).
template <bool A_COL, bool B_NK, class Epi>
inline cudaError_t gemm_tf32x3(const float* A, long long lda, const float* B, long long ldb,
                               int M, int N, int K, const Epi& epi, int chunk, float* ws,
                               long long ws_floats, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B);
  if (M <= 0 || N <= 0 || K <= 0 || (ptrs & 15) || (lda & 3) || (ldb & 3) || chunk <= 0 ||
      chunk % TF_BK)
    return cudaErrorInvalidValue;
  const long long splits = (K + (long long)chunk - 1) / chunk;
  const long long works = (long long)((M + TF_BM - 1) / TF_BM) * ((N + TF_BN - 1) / TF_BN) * splits;
  if (works > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool pass = splits > 1 || AfterPass<Epi>::value;  // the sums go through ws
  if (pass && (!ws || (reinterpret_cast<uintptr_t>(ws) & 3) || splits * M * N > ws_floats))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  // A column-major is a row-major [K, M]; B as [K, N] a row-major [K, N]
  const bool mapped = (A_COL ? tensor_map_2d(&map_a, A, lda, K, M, 32)
                             : tensor_map_2d(&map_a, A, lda, M, K, TF_BM)) &&
                      (B_NK ? tensor_map_2d(&map_b, B, ldb, N, K, TF_BN)
                            : tensor_map_2d(&map_b, B, ldb, K, N, 32));
  if (!mapped) return cudaErrorInvalidValue;
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(gemm_tf32x3_kernel<A_COL, B_NK, Epi>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 TFW_SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidValue;
  const long long grid = works < sms ? works : sms;
  gemm_tf32x3_kernel<A_COL, B_NK, Epi><<<(unsigned)grid, TFW_THREADS, TFW_SMEM, stream>>>(
      map_a, map_b, M, N, K, chunk, epi, pass ? ws : nullptr);
  if (pass) {
    const long long mn = (long long)M * N;
    splitk_reduce_kernel<Epi><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        ws, (int)splits, M, N, epi);
  }
  return cudaGetLastError();
}

// The pointer, leading dimension and layout of an A loader that reads an
// fp32 matrix as it is. At fp32, round_t is the identity
// (to_f<float>(from_f<float>(v)) returns v), so RoundRowLoad<float> and
// RoundColLoad<float> read a[...] exactly as RowLoad<float> and
// ColLoad<float> do; no other loader (LnRowLoad applies a LayerNorm) has a
// plain view.
template <class L> struct PlainF32A { static constexpr bool ok = false; };
template <> struct PlainF32A<RowLoad<float>> { static constexpr bool ok = true, col = false; };
template <> struct PlainF32A<ColLoad<float>> { static constexpr bool ok = true, col = true; };
template <> struct PlainF32A<RoundRowLoad<float>> { static constexpr bool ok = true, col = false; };
template <> struct PlainF32A<RoundColLoad<float>> { static constexpr bool ok = true, col = true; };

// The products of one planned launch (a train kernel, the eval
// PatchSelecter, or a tensor-parallel stage of either) as its wrapper
// planned them (ops/gemm.py gemm_plan): row i of `rows` is (M, N, K, chunk,
// route) of the i-th product launched, and the kernel writes route (a
// GemmRoute) as it launches it; ws holds the split-K partials (ws_floats
// floats). Row i of `attn` is (Sq, Sk, kernel) of the i-th attention launched
// (ops/attention.py keep_rows), and qt::attention / qt::attention_bwd write
// kernel (an AttentionKernel) as they launch it.
struct GemmPlan {
  int* rows;
  int count;
  int next;
  float* ws;
  long long ws_floats;
  int* attn;
  int attn_count;
  int attn_next = 0;
  bool attn_refused = false;
  int attn_sink = 0;
  // where the next attention writes its kernel: its row's last entry, or a
  // slot of its own (and the launch refused by done()) where the plan names
  // another shape or no more attentions
  int* attention(int Sq, int Sk) {
    int* row = attn_next < attn_count ? attn + 3 * attn_next++ : nullptr;
    if (row && row[0] == Sq && row[1] == Sk) return row + 2;
    attn_refused = true;
    return &attn_sink;
  }
  // every row used: a plan longer than the products or attentions launched
  // is refused
  cudaError_t done() const {
    return next == count && attn_next == attn_count && !attn_refused ? cudaSuccess
                                                                      : cudaErrorInvalidValue;
  }
};

// One product of a planned launch, C = A B through epi: fp32 on gemm_tf32x3,
// in the plan's chunks; bf16 with a plain row-major A and an [N, K] B (the
// forwards' projections) on gemm_rows (gemm_sm90 where gemm_route gives
// wgmma), any other bf16 product (the backwards') on gemm_tile's WMMA loop.
// A product the plan does not name (M, N, K) is refused.
template <typename T, bool B_NK, class ALoad, class Epi>
inline cudaError_t planned_gemm(const ALoad& a, const T* B, long long ldb, int M, int N, int K,
                                const Epi& epi, GemmPlan& plan, cudaStream_t stream) {
  if (plan.next >= plan.count) return cudaErrorInvalidValue;
  int* row = plan.rows + 5 * plan.next++;
  if (row[0] != M || row[1] != N || row[2] != K) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    static_assert(PlainF32A<ALoad>::ok, "an fp32 planned product needs a plain A");
    row[4] = GEMM_ROUTE_TF32X3;
    return gemm_tf32x3<PlainF32A<ALoad>::col, B_NK>(a.a, a.lda, B, ldb, M, N, K, epi, row[3],
                                                   plan.ws, plan.ws_floats, stream);
  } else if constexpr (B_NK && std::is_same<ALoad, RowLoad<T>>::value) {
    row[4] = gemm_route(true, M, N, K);
    return gemm_rows<T>(a.a, a.lda, B, ldb, M, N, K, epi, stream);
  } else {
    row[4] = GEMM_ROUTE_WMMA;
    gemm<T, B_NK>(a, B, ldb, M, N, K, epi, stream);
    return cudaGetLastError();
  }
}

// dW (torch layout [O, I], fp32) = sum over rows of G[r, o] X[r, i]: one
// planned_gemm whose K dimension is the rows, G read column-major
template <typename T, class GLoad>
inline cudaError_t bwd_weight_grad(const GLoad& gload, const T* X, long long ldx, float* dW,
                                   int O, int I, int rows, GemmPlan& plan, cudaStream_t stream) {
  return planned_gemm<T, false>(gload, X, ldx, O, I, rows, EpiStoreF32{dW, (long long)I, false},
                                plan, stream);
}

}  // namespace
}  // namespace qt
