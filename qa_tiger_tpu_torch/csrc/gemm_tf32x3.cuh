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
// patch_select_train.cu and avq.cu forward<float> and backward<float>, and
// of the eval PatchSelecter's _kernel (patch_select.py pallas_call :738,
// patch_select.cu run<float> and its tensor-parallel stages).
//
// Bound on the H100: operations. At B=32 the PatchSelecter backward's 14
// products are ~181 GFLOP against ~0.5 GB of operands and the AVQ
// backward's 20 are ~59 GFLOP; gemm_tile's fp32 FMA loop ran them at
// 8-10 TFLOP/s, and the card's FMA peak is 67. The TF32 tensor cores give
// 495 TFLOP/s dense but keep 10 mantissa bits. This routine:
// - splits each operand x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi)
//   (cvt.rna.tf32.f32: round to nearest, ties away from zero), and sums
//   lo·hi + hi·lo + hi·hi per k step on mma.sync.m16n8k8 tf32 -> fp32
//   (small terms first). The dropped lo·lo term is below 2^-22 of a product,
//   so the sum keeps about fp32's accuracy at a third of the TF32 rate
//   (165 TFLOP/s); no product runs single-pass TF32;
// - sums each K slab on the tensor cores into a fresh fragment and adds it
//   to the fp32 accumulator with an IEEE add: the tensor cores' own
//   accumulation does not round to nearest, and one chain over 26,880 rows
//   drifted by 2e-4 of the result on the card, past the train kernels'
//   1e-4 rule, where a chain of 12 products per slab does not;
// - reads A row-major ([M, K], RowLoad / RoundRowLoad) or column-major
//   (A(m, k) at a[k * lda + m], ColLoad / RoundColLoad: a weight gradient's
//   transposed G) and B as [N, K] or [K, N], without a transposing copy:
//   cp.async moves 16-byte chunks along whichever dimension is contiguous
//   into a 3-stage ring of padded shared-memory tiles (128 x 128 output
//   tile, K slabs of 32). A tile contiguous along K has rows of 32 + 4
//   floats, one contiguous along M or N rows of 128 + 8, so that the 8 x 4
//   fragment pattern (lane = 4 g + t reads (g, t) or (t, g)) hits 32
//   different banks in either layout; fragments are read with scalar lds
//   and split in registers. wgmma takes tf32 only with both operands
//   K-major in shared memory, which the column-major weight-gradient A and
//   the [K, N] dgrad B are not, so this routine stays on mma.sync;
// - cuts K into S chunks (split-K) where the output has too few tiles to
//   fill the SMs once (every weight gradient: 512 x 512 is 16 tiles, K the
//   26,880 patch rows): each block writes its fp32 partial tile to a
//   workspace [S, M, N], and a second pass adds the S partials in a fixed
//   order and applies the epilogue. No atomics: bitwise deterministic.
//   The caller plans the chunks (ops/gemm.py splitk_plan, handed to a train
//   backward in its GemmPlan) and allocates the workspace; the routine
//   allocates nothing.
//
// Needs 16-byte aligned A and B and leading dimensions that are multiples of
// 4 floats (the 16-byte chunks); M, N and K may be ragged (chunks past an
// edge are zero-filled). A call that breaks that, or whose split-K plan needs
// more workspace than it was given, returns cudaErrorInvalidValue; nothing
// falls back to gemm_tile. Every fp32 product of the two train kernels and
// of the eval PatchSelecter takes this routine: their leading dimensions
// are D, 2D, 3D and D/2, and their shares under tensor parallelism.
#pragma once

#include "gemm_sm90.cuh"

namespace qt {
namespace {

// ops/gemm.py TF32X3_TILE holds the same tile, for the split-K plan
constexpr int TF_BM = 128, TF_BN = 128, TF_BK = 32, TF_STAGES = 3, TF_THREADS = 256;

// A shared-memory tile of 128 rows (the m or n index) by TF_BK k: rows of
// TF_BK + 4 when K is the contiguous dimension, else k-rows of 128 + 8
template <bool KCONTIG> struct TfTile {
  static constexpr int LD = KCONTIG ? TF_BK + 4 : TF_BM + 8;
  static constexpr int FLOATS = KCONTIG ? TF_BM * LD : TF_BK * LD;
  __device__ static __forceinline__ int at(int r, int k) {
    return KCONTIG ? r * LD + k : k * LD + r;
  }
};

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (bytes 0: nothing is read)
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// Rows [r0, r0 + 128) x k [k0, k0 + TF_BK) of g into a tile: element (r, k)
// at g[r * ld + k] (KCONTIG) or g[k * ld + r]; rows >= rlim and k >= klim
// are zero. 1024 chunks of 4 floats, four per thread.
template <bool KCONTIG>
__device__ __forceinline__ void tf_load_tile(float* s, const float* __restrict__ g, long long ld,
                                             int r0, int rlim, int k0, int klim, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * TF_THREADS;
    int r, k;
    if (KCONTIG) {
      r = c >> 3;
      k = (c & 7) * 4;
    } else {
      k = c >> 5;
      r = (c & 31) * 4;
    }
    const int gr = r0 + r, gk = k0 + k;
    const float* src = g;
    int bytes = 0;
    if (gr < rlim && gk < klim) {
      const int left = KCONTIG ? klim - gk : rlim - gr;
      bytes = (left < 4 ? left : 4) * 4;
      src = KCONTIG ? g + (long long)gr * ld + gk : g + (long long)gk * ld + gr;
    }
    cp_async16_n(s + TfTile<KCONTIG>::at(r, k), src, bytes);
  }
}

// One K slab (TF_BK deep) of a warp's 64 x 32 share of a 128 x 128 tile:
// the slab's 3xTF32 sums on the tensor cores into a fresh fragment, folded
// into the fp32 accumulator acc with IEEE adds. As and Bs hold the slab's
// A rows (m) and B columns (n) in the layouts TA and TB; warp offsets wm, wn,
// g = lane / 4, t = lane % 4.
template <class TA, class TB>
__device__ __forceinline__ void tf32x3_slab(float (&acc)[4][4][4], const float* As,
                                            const float* Bs, int wm, int wn, int g, int t) {
  float part[4][4][4];  // this slab's sums, on the tensor cores
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < TF_BK; kk += 8) {
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + i * 16 + g;
      split_tf32(As[TA::at(r, kk + t)], ah[i][0], al[i][0]);
      split_tf32(As[TA::at(r + 8, kk + t)], ah[i][1], al[i][1]);
      split_tf32(As[TA::at(r, kk + t + 4)], ah[i][2], al[i][2]);
      split_tf32(As[TA::at(r + 8, kk + t + 4)], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + j * 8 + g;
      split_tf32(Bs[TB::at(c, kk + t)], bh[j][0], bl[j][0]);
      split_tf32(Bs[TB::at(c, kk + t + 4)], bh[j][1], bl[j][1]);
    }
    // one pass over all 16 fragments at a time, so that two products on
    // the same accumulator are 16 instructions apart, not back to back
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], ah[i], bh[j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

template <bool A_COL, bool B_NK> struct TfSmem {
  using TA = TfTile<!A_COL>;
  using TB = TfTile<B_NK>;
  static constexpr int STAGE = TA::FLOATS + TB::FLOATS;
  static constexpr int BYTES = TF_STAGES * STAGE * (int)sizeof(float);
};

// One 128 x 128 output tile over the K chunk blockIdx.z: 8 warps in 2 x 4,
// each 64 x 32 (4 x 4 m16n8 fragments). With ws null the epilogue applies
// directly; else the raw sums go to ws[blockIdx.z][m][n].
template <bool A_COL, bool B_NK, class Epi>
__global__ void __launch_bounds__(TF_THREADS)
gemm_tf32x3_kernel(const float* __restrict__ A, long long lda, const float* __restrict__ B,
                   long long ldb, int M, int N, int K, int chunk, Epi epi, float* __restrict__ ws) {
  extern __shared__ __align__(16) float tf_smem[];
  using Sm = TfSmem<A_COL, B_NK>;
  using TA = typename Sm::TA;
  using TB = typename Sm::TB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * TF_BM, n0 = blockIdx.x * TF_BN;
  const int kb = blockIdx.z * chunk;
  const int ke = K - kb < chunk ? K : kb + chunk;
  const int nk = (ke - kb + TF_BK - 1) / TF_BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto load = [&](int stage, int kt) {
    float* s = tf_smem + stage * Sm::STAGE;
    const int k0 = kb + kt * TF_BK;
    tf_load_tile<!A_COL>(s, A, lda, m0, M, k0, ke, tid);
    tf_load_tile<B_NK>(s + TA::FLOATS, B, ldb, n0, N, k0, ke, tid);
  };
#pragma unroll
  for (int s = 0; s < TF_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TF_STAGES - 2>();
    __syncthreads();  // slab kt has landed; every warp is done with slab kt - 1
    if (kt + TF_STAGES - 1 < nk) load((kt + TF_STAGES - 1) % TF_STAGES, kt + TF_STAGES - 1);
    cp_async_commit();
    const float* As = tf_smem + (kt % TF_STAGES) * Sm::STAGE;
    tf32x3_slab<TA, TB>(acc, As, As + TA::FLOATS, wm, wn, g, t);
  }
  cp_async_wait<0>();

  float* slice = ws ? ws + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (m < M && n < N) {
          if (slice)
            slice[(long long)m * N + n] = acc[i][j][e];
          else
            epi(m, n, acc[i][j][e]);
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
// multiple of TF_BK; chunk >= K: no split); more than one chunk needs ws
// with room for chunks * M * N floats. The caller plans the chunk
// (ops/gemm.py splitk_plan).
template <bool A_COL, bool B_NK, class Epi>
inline cudaError_t gemm_tf32x3(const float* A, long long lda, const float* B, long long ldb,
                               int M, int N, int K, const Epi& epi, int chunk, float* ws,
                               long long ws_floats, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B);
  if (M <= 0 || N <= 0 || K <= 0 || (ptrs & 15) || (lda & 3) || (ldb & 3) || chunk <= 0 ||
      chunk % TF_BK)
    return cudaErrorInvalidValue;
  const long long splits = (K + (long long)chunk - 1) / chunk;
  const long long mt = (M + TF_BM - 1) / TF_BM;
  if (mt > 65535 || splits > 65535) return cudaErrorInvalidValue;
  if (splits > 1 && (!ws || (reinterpret_cast<uintptr_t>(ws) & 3) || splits * M * N > ws_floats))
    return cudaErrorInvalidValue;
  using Sm = TfSmem<A_COL, B_NK>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(gemm_tf32x3_kernel<A_COL, B_NK, Epi>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 Sm::BYTES);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((N + TF_BN - 1) / TF_BN, (unsigned)mt, (unsigned)splits);
  gemm_tf32x3_kernel<A_COL, B_NK, Epi><<<grid, TF_THREADS, Sm::BYTES, stream>>>(
      A, lda, B, ldb, M, N, K, chunk, epi, splits > 1 ? ws : nullptr);
  if (splits > 1) {
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
