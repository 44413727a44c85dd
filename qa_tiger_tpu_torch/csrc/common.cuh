// Device code shared by the kernels of this package: type conversion, warp
// reductions, a block-level tiled GEMM with a pluggable A loader (row- and
// column-major), the multi-head attention kernels and the FMA backward (the
// keep-masked tensor-core forward and backward, declared here, are built in
// attention_keep.cu), the row LayerNorm kernels and LayerNorm backward,
// column sums.
//
// Conventions: activations and parameters arrive in one type T (float or
// __nv_bfloat16); every sum is taken in fp32; a value is rounded to T where
// the JAX package rounds it (round_t), so the bf16 kernels and their plain
// PyTorch versions agree to bf16 rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace qt {

// One operand of the keep-masked tensor-core attention: element (b, row,
// lane) at p + b * bs + row * ss + lane
struct KeepIn {
  const void* p;
  long long bs, ss;
};
struct KeepOut {
  void* p;
  long long bs, ss;
};

// The keep-masked attention on tensor cores (kernel "mma_keep"), forward and
// backward, for bf16 (bf16 true) or fp32 operands; the forward with keep
// null is the same kernel without the keep multiply (kernel "mma_nokeep"),
// which in fp32 also adds an additive [Sq, Sk] mask and a [B, Sk] key bias
// (both may be null; bf16 and keep-masked calls take neither).
// attention_nokeep_tiled is the fp32 forward without a keep mask past
// ATT_KEEP_MAX_SK keys (kernel "mma_nokeep_tiled"). Defined in
// attention_keep.cu, the one source that builds their kernels;
// qt::attention and qt::attention_bwd call them where attention_plan and
// attention_bwd_plan choose them.
cudaError_t attention_keep_fwd(bool bf16, KeepIn q, KeepIn k, KeepIn v, KeepOut out,
                               const void* keep, long long keep_ld, int B, int Sq, int Sk,
                               int heads, int hd, float scale, bool round_p_first,
                               cudaStream_t stream, const float* mask = nullptr,
                               const float* key_bias = nullptr);
cudaError_t attention_nokeep_tiled(KeepIn q, KeepIn k, KeepIn v, KeepOut out, const float* mask,
                                   const float* key_bias, int B, int Sq, int Sk, int heads,
                                   int hd, float scale, cudaStream_t stream);
cudaError_t attention_keep_bwd(bool bf16, KeepIn q, KeepIn k, KeepIn v, KeepIn g, KeepOut gq,
                               KeepOut gk, KeepOut gv, const void* keep, long long keep_ld,
                               int B, int Sq, int Sk, int heads, int hd, float scale,
                               bool round_p_first, bool accumulate_kv, cudaStream_t stream);
// The fp32 attention at head sizes 256 and 512 (kernel "lane_split"):
// attention_tp.cuh's two lane-split stages at one rank, one head at a time,
// the fp32 scores [B, Sq, Sk] of a head in scratch. Defined in attention.cu.
cudaError_t attention_lanes(KeepIn q, KeepIn k, KeepIn v, KeepOut out, int B, int Sq, int Sk,
                            int heads, int hd, float scale, float* scratch,
                            cudaStream_t stream);
// The bf16 attention past 128 keys for Hopper (kernel "mma_sm90", route
// "wgmma"): TMA and wgmma, two passes, head size 64 (attention_sm90.cuh,
// built in attention.cu). attention_sm90_mode is a measurement switch that
// chip_smoke.py's kernel lines and the card's tests set through
// qt_attention_sm90_mode: ATT_SM90_DEFAULT (what every caller gets: the
// calls sm90_faster names), ATT_SM90_OFF (attention_plan leaves every
// such call on attention_mma_kernel, to time it on the same inputs) or
// ATT_SM90_ALWAYS (the Hopper kernel at every length past 128 keys, to time
// and test it where the rule declines it).
cudaError_t attention_sm90(const __nv_bfloat16* q, long long q_bs, long long q_ss,
                           const __nv_bfloat16* k, long long k_bs, long long k_ss,
                           const __nv_bfloat16* v, long long v_bs, long long v_ss,
                           __nv_bfloat16* out, long long o_bs, long long o_ss, const float* mask,
                           const float* key_bias, int B, int Sq, int Sk, int heads, int hd,
                           float scale, cudaStream_t stream);
enum Sm90Mode { ATT_SM90_DEFAULT = 0, ATT_SM90_OFF = 1, ATT_SM90_ALWAYS = 2 };
int attention_sm90_mode();
void set_attention_sm90_mode(int mode);

// Everything below has internal linkage (an unnamed namespace), so each
// source that includes this header owns its instantiations and no two
// objects share a kernel symbol at link time.
namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A loader may declare `static constexpr bool kColMajor = true` when A(m, k)
// lies at a[k * lda + m] (a weight gradient's transposed operand): the tile
// load then walks m fastest so that neighbouring threads read neighbouring
// addresses.
template <class L, class = void> struct a_col_major : std::false_type {};
template <class L>
struct a_col_major<L, std::void_t<decltype(L::kColMajor)>> : std::bool_constant<L::kColMajor> {};

// ---------------------------------------------------------------------------
// Tiled GEMM: C[m, n] = sum_k A(m, k) * B(k, n) for one BM x BN output tile,
// fp32 accumulation, result left in shared memory for the caller's epilogue.
//
// A(m, k) comes from a loader functor (returns float), so a LayerNorm or a
// row interleave can ride on the A load. B is a weight matrix in type T,
// either [N, K] (B_NK: torch's Linear layout, element (k, n) at
// B[n * ldb + k]) or [K, N] (element (k, n) at B[k * ldb + n]).
//
// Two main loops: TC uses bf16 tensor cores through WMMA 16x16x16 tiles
// (T must be bf16); otherwise a register-tiled fp32 FMA loop, used for fp32
// and wherever A must stay fp32. Both are single-stage: load a K slab into
// shared memory, synchronise, multiply. Edges are zero-filled.
// ---------------------------------------------------------------------------
constexpr int BM = 64, BN = 64, GEMM_THREADS = 256;
constexpr int CS_LD = BN + 4;

struct GemmSmem {
  // the fp32 tile the epilogue reads; 32-byte aligned for wmma stores
  __align__(32) float c[BM * CS_LD];
};

template <typename T, bool TC, bool B_NK, class ALoad>
__device__ void gemm_tile(GemmSmem& sm, const ALoad& aload, const T* __restrict__ B,
                          long long ldb, int M, int N, int K, int m0, int n0) {
  const int tid = threadIdx.x;
  if constexpr (TC) {
    static_assert(std::is_same<T, __nv_bfloat16>::value, "WMMA path is bf16");
    using namespace nvcuda;
    constexpr int BK = 32, LDS = BK + 8;
    __shared__ __align__(32) __nv_bfloat16 As[BM * LDS];
    __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDS];  // (k, n) at Bs[n*LDS+k]
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
        int m, k;
        if constexpr (a_col_major<ALoad>::value) {
          k = i / BM; m = i % BM;
        } else {
          m = i / BK; k = i % BK;
        }
        const int gm = m0 + m, gk = k0 + k;
        As[m * LDS + k] = __float2bfloat16(gm < M && gk < K ? aload(gm, gk) : 0.0f);
      }
      for (int i = tid; i < BN * BK; i += GEMM_THREADS) {
        int n, k;
        if constexpr (B_NK) { n = i / BK; k = i % BK; } else { k = i / BN; n = i % BN; }
        const int gn = n0 + n, gk = k0 + k;
        __nv_bfloat16 v = __float2bfloat16(0.0f);
        if (gn < N && gk < K)
          v = B_NK ? B[(long long)gn * ldb + gk] : B[(long long)gk * ldb + gn];
        Bs[n * LDS + k] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (wm * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.c + (wm * 16) * CS_LD + wn * 32 + j * 16, acc[j],
                              CS_LD, wmma::mem_row_major);
  } else {
    constexpr int BK = 16, TM = 4, TN = 4;
    __shared__ float As[BK * (BM + 4)];  // (m, k) at As[k*(BM+4)+m]
    __shared__ float Bs[BK * BN];        // (k, n) at Bs[k*BN+n]
    const int ty = tid / 16, tx = tid % 16;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
        int m, k;
        if constexpr (a_col_major<ALoad>::value) {
          k = i / BM; m = i % BM;
        } else {
          m = i / BK; k = i % BK;
        }
        const int gm = m0 + m, gk = k0 + k;
        As[k * (BM + 4) + m] = gm < M && gk < K ? aload(gm, gk) : 0.0f;
      }
      for (int i = tid; i < BN * BK; i += GEMM_THREADS) {
        int n, k;
        if constexpr (B_NK) { n = i / BK; k = i % BK; } else { k = i / BN; n = i % BN; }
        const int gn = n0 + n, gk = k0 + k;
        float v = 0.0f;
        if (gn < N && gk < K)
          v = to_f<T>(B_NK ? B[(long long)gn * ldb + gk] : B[(long long)gk * ldb + gn]);
        Bs[k * BN + n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k * (BM + 4) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k * BN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sm.c[(ty + 16 * i) * CS_LD + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
}

// A loaders ---------------------------------------------------------------
template <typename TA> struct RowLoad {  // A(m, k) = a[m * lda + k]
  const TA* a;
  long long lda;
  __device__ float operator()(int m, int k) const { return to_f<TA>(a[(long long)m * lda + k]); }
};

template <typename T> struct LnRowLoad {  // A = round_T(LayerNorm(x)) from row stats
  const T* x;
  long long ldx;
  const float* mean;
  const float* rstd;
  const T* w;
  const T* b;
  __device__ float operator()(int m, int k) const {
    const float v = (to_f<T>(x[(long long)m * ldx + k]) - mean[m]) * rstd[m];
    return round_t<T>(v * to_f<T>(w[k]) + to_f<T>(b[k]));
  }
};

template <typename TA> struct ColLoad {  // A(m, k) = a[k * lda + m]
  static constexpr bool kColMajor = true;
  const TA* a;
  long long lda;
  __device__ float operator()(int m, int k) const { return to_f<TA>(a[(long long)k * lda + m]); }
};

template <typename T> struct RoundRowLoad {  // A(m, k) = round_T(a[m * lda + k]), a fp32
  const float* a;
  long long lda;
  __device__ float operator()(int m, int k) const { return round_t<T>(a[(long long)m * lda + k]); }
};

template <typename T> struct RoundColLoad {  // A(m, k) = round_T(a[k * lda + m]), a fp32
  static constexpr bool kColMajor = true;
  const float* a;
  long long lda;
  __device__ float operator()(int m, int k) const { return round_t<T>(a[(long long)k * lda + m]); }
};

// Epilogues ---------------------------------------------------------------
// EpiBias, EpiBiasQuickGelu, EpiResidual and EpiF32 also give value(m, n,
// acc), the fp32 value that operator() rounds into out[m * ldo + n], so that
// gemm_sm90 can store two adjacent columns at once with the same arithmetic.
template <typename T> struct EpiBias {  // out = round_T(act(acc + bias)); bias may be null
  T* out;
  long long ldo;
  const T* bias;
  bool relu;
  __device__ float value(int m, int n, float acc) const {
    float v = bias ? acc + to_f<T>(bias[n]) : acc;
    return relu ? fmaxf(v, 0.0f) : v;
  }
  __device__ void operator()(int m, int n, float acc) const {
    out[(long long)m * ldo + n] = from_f<T>(value(m, n, acc));
  }
};

// out = round_T(QuickGELU(acc + bias)): CLIP's x * sigmoid(1.702 x) on the
// unrounded fp32 value, as the Pallas MLP body takes it
template <typename T> struct EpiBiasQuickGelu {
  T* out;
  long long ldo;
  const T* bias;
  __device__ float value(int, int n, float acc) const {
    const float v = acc + to_f<T>(bias[n]);
    return v / (1.0f + expf(-1.702f * v));
  }
  __device__ void operator()(int m, int n, float acc) const {
    out[(long long)m * ldo + n] = from_f<T>(value(m, n, acc));
  }
};

template <typename T> struct EpiResidual {  // out = res + round_T(acc + bias); bias may be null
  T* out;
  long long ldo;
  const T* bias;
  const T* res;
  long long ldr;
  __device__ float value(int m, int n, float acc) const {
    const float v = round_t<T>(bias ? acc + to_f<T>(bias[n]) : acc);
    return to_f<T>(res[(long long)m * ldr + n]) + v;
  }
  __device__ void operator()(int m, int n, float acc) const {
    out[(long long)m * ldo + n] = from_f<T>(value(m, n, acc));
  }
};

struct EpiStoreF32 {  // out (fp32) = acc, or += acc: a parameter gradient
  float* out;
  long long ldo;
  bool accumulate;
  __device__ void operator()(int m, int n, float acc) const {
    float* o = out + (long long)m * ldo + n;
    *o = accumulate ? *o + acc : acc;
  }
};

struct EpiAddF32 {  // out (fp32) = base + acc; out may alias base
  float* out;
  const float* base;
  long long ld;
  __device__ void operator()(int m, int n, float acc) const {
    const long long i = (long long)m * ld + n;
    out[i] = base[i] + acc;
  }
};

template <typename T> struct EpiAddRound {  // out = round_T(base + acc), base fp32
  T* out;
  const float* base;
  long long ld;
  __device__ void operator()(int m, int n, float acc) const {
    const long long i = (long long)m * ld + n;
    out[i] = from_f<T>(base[i] + acc);
  }
};

template <typename T> struct EpiF32 {  // out (fp32) = acc + bias; bias may be null
  float* out;
  long long ldo;
  const T* bias;
  __device__ float value(int, int n, float acc) const {
    return bias ? acc + to_f<T>(bias[n]) : acc;
  }
  __device__ void operator()(int m, int n, float acc) const {
    out[(long long)m * ldo + n] = value(m, n, acc);
  }
};

template <typename T, bool TC, bool B_NK, class ALoad, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(ALoad aload, const T* __restrict__ B, long long ldb, int M, int N, int K, Epi epi) {
  __shared__ GemmSmem sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  gemm_tile<T, TC, B_NK>(sm, aload, B, ldb, M, N, K, m0, n0);
  for (int i = threadIdx.x; i < BM * BN; i += GEMM_THREADS) {
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (m < M && n < N) epi(m, n, sm.c[(i / BN) * CS_LD + i % BN]);
  }
}

// Launch C = A @ B with the tensor-core loop where T is bf16.
template <typename T, bool B_NK, class ALoad, class Epi>
inline void gemm(const ALoad& aload, const T* B, long long ldb, int M, int N, int K,
                 const Epi& epi, cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, TC, B_NK><<<grid, GEMM_THREADS, 0, stream>>>(aload, B, ldb, M, N, K, epi);
}

// ---------------------------------------------------------------------------
// Multi-head attention on dense heads-in-lanes tensors.
//
// q [B, Sq, H*hd], k/v [B, Sk, H*hd] given by base pointer, batch stride and
// row stride (so q, k and v may be column slices of one packed qkv buffer);
// out [B, Sq, H*hd] likewise. Scores are s = q_h k_h^T * scale + mask +
// key_bias[b, key]; an fp32 softmax with max subtraction; the probabilities
// rounded to T (as the JAX kernels cast p to v's dtype); the context summed
// in fp32. mask is an optional additive fp32 [Sq, Sk]; key_bias an optional
// fp32 [B, Sk] (ToMe's proportional attention, log of the token sizes).
//
// Eleven kernels; attention_plan decides. A call with a keep mask (the train
// kernels' dropout attentions) at head sizes 32, 64 and 128 over at most
// ATT_KEEP_MAX_SK keys takes the keep-masked tensor-core kernel in bf16 and
// fp32 (attention_keep.cu; attention_bwd_plan its backward). An fp32 call
// without a keep mask at those head sizes takes 3xTF32 tensor cores,
// additive mask and key bias included: that kernel with its keep multiply
// compiled out ("mma_nokeep") up to ATT_KEEP_MAX_SK keys (the fp32
// evaluation forward's AVQ, TempMoE, QstGrounding and PatchSelecter
// attentions, the fp32 text towers' causal calls, the short ToMe layers),
// its key-tiled two-pass form past that ("mma_nokeep_tiled": the fp32 CLIP
// image tower, 577 keys, and the long ToMe layers); at head sizes 256 and
// 512 without a mask or key bias, the lane split's two 3xTF32 stages
// ("lane_split", attention_tp.cuh at one rank: TSPM's one-head calls in
// fp32). A bf16 call without a keep mask, a mask or a key bias at head sizes
// 32, 64 and 128 over at most ATT_KEEP_MAX_SK keys takes "mma_nokeep" where
// no kernel below takes it (fewer than 16 queries over more than 16 keys:
// TempMoE's 1 x 60). bf16 calls
// without a keep mask, at head sizes 32, 64 and 128, take one of two
// tensor-core kernels:
// - at most ATT_SHORT_MAX queries and keys (PatchSelecter's 14-key self- and
//   cross-attention, fused_attention's packed [BH, 14, 64], QstGrounding's
//   one query over 2 keys, the last ToMe layers): attention_short_kernel,
//   one warp per (batch element, head) problem, a 16 x 16 score tile;
// - at least 16 queries and 16 keys otherwise: attention_mma_kernel, 64
//   query rows per block, keys streamed in 64-key tiles.
// At head sizes 256 and 512 they take one of two tensor-core kernels that
// stream the head in 64-lane slabs (TSPM's one-head attentions):
// - at most ATT_SHORT_MAX queries and keys (TokensAttn, 14 over 14 keys):
//   attention_wide_short_kernel, one warp per problem;
// - any other length (AV_Attn, 60 over 60 keys; 577 keys) whose
//   probabilities fit the block's shared memory: attention_mma_wide_kernel,
//   64 query rows per block.
// A bf16 head between 128 and 512 lanes has no kernel at its own size: the
// wrapper zero-pads it to 256 or 512.
// Every other call (fp32 at head sizes 256 and 512 with a mask or a key
// bias, or at other head sizes; a keep mask at other head sizes or past
// ATT_KEEP_MAX_SK keys; bf16 with fewer than 16 queries over more keys with
// a mask or a key bias or past ATT_KEEP_MAX_SK keys; a wide head past
// ~1,500 keys in bf16; a call whose tensor-core kernel passes the shared
// memory limit) runs on fp32 FMAs, in one of three kernels chosen by
// the shared memory each needs against the device's opt-in limit per block:
// - Sk <= ATT_STAGED_MAX_SK where K_h and V_h fit (the bf16 calls above
//   with a mask or a key bias): one block per (batch element, head, tile
//   of ATT_QROWS queries) stages all of K_h and V_h in shared memory as
//   fp32, one warp per query row.
// - head sizes 256 and 512 otherwise: the wide-head kernel below, keys in
//   tiles.
// - longer keys: one block per (batch element, head, tile of AT_Q queries) streams
//   K_h and V_h through shared memory in tiles of AT_K keys, so its shared
//   memory does not grow with Sk. Two passes keep the JAX kernels' rounding
//   point (p = round_T(exp(s - max) / sum), then p v in fp32): the first
//   takes each row's max and sum over the key tiles (an online rescaled sum),
//   the second recomputes the scores, forms the rounded p and accumulates
//   p v. Head sizes 32, 64 and 128.
//
// keep is an optional multiplicative post-softmax dropout mask in T, already
// scaled by 1/(1-p): row b*Sq + query, lane h*Sk + key, row stride keep_ld
// (the geometry of the port's mask samplers). With it the probability that
// multiplies v is round_T(p' * keep), where p' is the fp32 probability
// (round_p_first false: the AVQ kernels) or round_T(p) (true: the
// PatchSelecter kernels), as in the Pallas kernels each one replaces.
// ---------------------------------------------------------------------------
constexpr int ATT_WARPS = 4, ATT_QROWS = 32, ATT_STAGED_MAX_SK = 128;

template <typename T>
__device__ __forceinline__ float dropped_prob(float p, const T* keep_row, int j,
                                              bool round_p_first) {
  if (!keep_row) return round_t<T>(p);
  return round_t<T>((round_p_first ? round_t<T>(p) : p) * to_f<T>(keep_row[j]));
}

inline size_t attention_smem_bytes(int Sk, int hd) {
  return sizeof(float) * ((size_t)Sk * (hd + 1) + (size_t)Sk * hd + ATT_WARPS * (size_t)(hd + Sk));
}

template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const T* __restrict__ q, long long q_bs, long long q_ss,
                 const T* __restrict__ k, long long k_bs, long long k_ss,
                 const T* __restrict__ v, long long v_bs, long long v_ss,
                 T* __restrict__ out, long long o_bs, long long o_ss,
                 const float* __restrict__ mask, const float* __restrict__ key_bias, int Sq,
                 int Sk, int hd, float scale, const T* __restrict__ keep, long long keep_ld,
                 bool round_p_first) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // [Sk][hd + 1]
  float* Vs = Ks + (size_t)Sk * (hd + 1);  // [Sk][hd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = Vs + (size_t)Sk * hd + warp * (hd + Sk);  // [hd]
  float* ps = qs + hd;                                   // [Sk]

  const int ntiles = (Sq + ATT_QROWS - 1) / ATT_QROWS;
  const int b = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const int h = blockIdx.y;
  const long long col = (long long)h * hd;
  const float* kb = key_bias ? key_bias + (long long)b * Sk : nullptr;

  for (int i = threadIdx.x; i < Sk * hd; i += blockDim.x) {
    const int j = i / hd, d = i % hd;
    Ks[j * (hd + 1) + d] = to_f<T>(k[b * k_bs + j * k_ss + col + d]);
    Vs[j * hd + d] = to_f<T>(v[b * v_bs + j * v_ss + col + d]);
  }
  __syncthreads();

  const int q_end = min(Sq, (tile + 1) * ATT_QROWS);
  for (int qi = tile * ATT_QROWS + warp; qi < q_end; qi += ATT_WARPS) {
    for (int d = lane; d < hd; d += 32) qs[d] = to_f<T>(q[b * q_bs + qi * q_ss + col + d]);
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < Sk; j += 32) {
      const float* kr = Ks + j * (hd + 1);
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[d], kr[d], s);
      s *= scale;
      if (mask) s += mask[(long long)qi * Sk + j];
      if (kb) s += kb[j];
      ps[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < Sk; j += 32) {
      const float e = expf(ps[j] - mx);
      ps[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    const T* kr = keep ? keep + (long long)(b * Sq + qi) * keep_ld + col / hd * Sk : nullptr;
    for (int j = lane; j < Sk; j += 32) ps[j] = dropped_prob<T>(ps[j] * inv, kr, j, round_p_first);
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < Sk; ++j) acc = fmaf(ps[j], Vs[j * hd + d], acc);
      out[b * o_bs + qi * o_ss + col + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

// The key-tiled kernel. 128 threads own a 64 x 64 score tile as a 16 x 8
// grid: thread (tr, tc) holds rows tr + 16i (i < 4) and keys tc + 8j (j < 8)
// in registers, and in the context product the same rows by lanes tc + 8c.
// The 8 threads of a row group are 8 neighbouring lanes of one warp, so a
// row's max and sum are shuffles within the group.
constexpr int AT_Q = 64, AT_K = 64, AT_THREADS = 128;

template <int HD>
constexpr size_t attention_tiled_smem_bytes() {
  return sizeof(float) * ((size_t)(AT_Q + AT_K) * (HD + 1) + (size_t)AT_K * HD
                          + (size_t)AT_Q * (AT_K + 1));
}

__device__ __forceinline__ float group8_max(float v) {
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(AT_THREADS)
attention_tiled_kernel(const T* __restrict__ q, long long q_bs, long long q_ss,
                       const T* __restrict__ k, long long k_bs, long long k_ss,
                       const T* __restrict__ v, long long v_bs, long long v_ss,
                       T* __restrict__ out, long long o_bs, long long o_ss,
                       const float* __restrict__ mask, const float* __restrict__ key_bias,
                       int Sq, int Sk, float scale, const T* __restrict__ keep,
                       long long keep_ld, bool round_p_first) {
  constexpr int LD = HD + 1, LDP = AT_K + 1, NC = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;              // [AT_Q][LD]
  float* Ks = Qs + AT_Q * LD;    // [AT_K][LD]
  float* Vs = Ks + AT_K * LD;    // [AT_K][HD]
  float* Ps = Vs + AT_K * HD;    // [AT_Q][LDP]: the rounded probabilities of one key tile
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int ntiles = (Sq + AT_Q - 1) / AT_Q;
  const long long b = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x % ntiles) * AT_Q, h = blockIdx.y;
  const long long col = (long long)h * HD;
  const float* kb = key_bias ? key_bias + b * Sk : nullptr;

  for (int i = tid; i < AT_Q * HD; i += AT_THREADS) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? to_f<T>(q[b * q_bs + qi * q_ss + col + d]) : 0.0f;
  }
  auto load_tile = [&](int k0, bool with_v) {
    for (int i = tid; i < AT_K * HD; i += AT_THREADS) {
      const int j = i / HD, d = i % HD, kj = k0 + j;
      const bool in = kj < Sk;
      Ks[j * LD + d] = in ? to_f<T>(k[b * k_bs + kj * k_ss + col + d]) : 0.0f;
      if (with_v) Vs[j * HD + d] = in ? to_f<T>(v[b * v_bs + kj * v_ss + col + d]) : 0.0f;
    }
  };
  // s[i][j] = the score of row q0 + tr + 16i and key k0 + tc + 8j; -inf
  // past the last key
  auto scores = [&](int k0, float (&s)[4][8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = Ks[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tc + 8 * j;
        float x = s[i][j] * scale;
        if (kj >= Sk) {
          x = -INFINITY;
        } else {
          if (mask && qi < Sq) x += mask[(long long)qi * Sk + kj];
          if (kb) x += kb[kj];
        }
        s[i][j] = x;
      }
    }
  };

  // pass 1: each row's max and sum of exp(s - max) over all key tiles; each
  // thread rescales its own partial sum whenever the row's max grows
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.0f; }
  float s[4][8];
  for (int k0 = 0; k0 < Sk; k0 += AT_K) {
    __syncthreads();
    load_tile(k0, false);
    __syncthreads();
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float mn = fmaxf(m[i], group8_max(tmax));
      if (mn == -INFINITY) continue;  // every key so far masked out
      float part = l[i] * expf(m[i] - mn);
#pragma unroll
      for (int j = 0; j < 8; ++j) part += expf(s[i][j] - mn);
      l[i] = part;
      m[i] = mn;
    }
  }
  float inv[4];
  const T* krow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = 1.0f / group8_sum(l[i]);
    const int qi = q0 + tr + 16 * i;
    krow[i] = keep && qi < Sq ? keep + (b * Sq + qi) * keep_ld + (long long)h * Sk : nullptr;
  }

  // pass 2: the scores again, p = round_T(exp(s - max) / sum), ctx += p v
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int k0 = 0; k0 < Sk; k0 += AT_K) {
    __syncthreads();
    load_tile(k0, true);
    __syncthreads();
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tc + 8 * j;
        float p = 0.0f;
        if (kj < Sk) p = dropped_prob<T>(expf(s[i][j] - m[i]) * inv[i], krow[i], kj, round_p_first);
        Ps[(tr + 16 * i) * LDP + tc + 8 * j] = p;
      }
    __syncthreads();
    const int kn = min(AT_K, Sk - k0);
    for (int j = 0; j < kn; ++j) {
      float a[4], c[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(tr + 16 * i) * LDP + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) c[cc] = Vs[j * HD + tc + 8 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[i][cc] = fmaf(a[i], c[cc], acc[i][cc]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    T* o = out + b * o_bs + qi * o_ss + col;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) o[tc + 8 * cc] = from_f<T>(acc[i][cc]);
  }
}

template <typename T, int HD>
inline cudaError_t attention_tiled(const T* q, long long q_bs, long long q_ss, const T* k,
                                   long long k_bs, long long k_ss, const T* v, long long v_bs,
                                   long long v_ss, T* out, long long o_bs, long long o_ss,
                                   const float* mask, const float* key_bias, int B, int Sq,
                                   int Sk, int heads, float scale, cudaStream_t stream,
                                   const T* keep, long long keep_ld, bool round_p_first) {
  constexpr size_t smem = attention_tiled_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attention_tiled_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + AT_Q - 1) / AT_Q;
  const dim3 grid((unsigned)(B * ntiles), heads);
  attention_tiled_kernel<T, HD><<<grid, AT_THREADS, smem, stream>>>(
      q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, Sq, Sk,
      scale, keep, keep_ld, round_p_first);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide-head kernel: head sizes 256 and 512, any key length, fp32 FMAs.
// It takes the FMA calls whose head is too wide for the other two: the
// staged kernel's fp32 K_h and V_h outgrow a block's shared memory (at head
// size 512 past 54 keys: TSPM's one-head AV_Attn over 60 frames, in fp32),
// and the 64 x 64 register tile of the tiled kernel does not fit a 256- or
// 512-lane context row. Since the tensor-core kernels for these head sizes
// (attention_mma_wide_kernel, attention_wide_short_kernel) it runs only
// fp32 calls, keep-masked calls, and bf16 calls whose probabilities would
// pass the mma kernel's shared memory (far past 577 keys). The TPU kernel it
// stands in for is the same fused_attention_wide
// (qa_tiger_tpu/ops/pallas/attention.py), which takes one head of 512 lanes.
//
// One block of AW_THREADS threads owns AW_Q query rows of one (batch
// element, head) and streams the keys through shared memory in tiles of
// AW_KEYS<HD> keys (16 at 512 lanes, 32 at 256), so its shared memory is
// fixed by HD (99,904 bytes at 512, 84,800 at 256) and not by Sk. The same
// two passes as the tiled kernel keep the JAX rounding point: the first takes
// each row's max and rescaled sum of exp over the key tiles, the second
// recomputes the scores, forms p = round_T(exp(s - max) / sum) and
// accumulates p v in fp32. Scores: thread (r, c) of the 16 x 16 grid holds
// row r and keys c + 16 j, its dot products read q and k as float4 out of
// fp32 shared memory into four partial sums; a row's max and sum are
// shuffles over the 16 lanes that share it. Context: each thread holds 4
// rows by HD / 64 lanes (c + 64 n) in registers.
//
// Bound on the card: bytes in bf16 at TSPM's AV_Attn shape ([512, 60, 512],
// one head: 4 x 60 x 60 x 512 operations on 4 x 60 x 512 bf16 values per
// problem, 60 per byte, under the bf16 ridge) and at hd 256 over 577 keys;
// operations in fp32 at the latter. The design is the simple one, FMAs
// out of shared memory: it is bound by
// the shared memory's bandwidth (three 16-byte reads per eight FMAs in the
// score loop, the scores computed twice), far above either bound. PERF.md
// has its time beside the bound and SDPA's; bf16 without a keep mask takes
// the tensor-core kernels instead.
// ---------------------------------------------------------------------------
constexpr int AW_Q = 16, AW_THREADS = 256;

// keys per tile of the wide-head kernel
template <int HD> constexpr int AW_KEYS = HD >= 512 ? 16 : 32;

template <int HD>
constexpr size_t attention_wide_smem_bytes() {
  constexpr int KT = AW_KEYS<HD>;
  return sizeof(float) * ((size_t)(AW_Q + KT) * (HD + 4) + (size_t)KT * HD
                          + (size_t)AW_Q * (KT + 1));
}

__device__ __forceinline__ float group16_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(AW_THREADS)
attention_wide_head_kernel(const T* __restrict__ q, long long q_bs, long long q_ss,
                           const T* __restrict__ k, long long k_bs, long long k_ss,
                           const T* __restrict__ v, long long v_bs, long long v_ss,
                           T* __restrict__ out, long long o_bs, long long o_ss,
                           const float* __restrict__ mask, const float* __restrict__ key_bias,
                           int Sq, int Sk, float scale, const T* __restrict__ keep,
                           long long keep_ld, bool round_p_first) {
  // rows padded by 4 floats: 16-byte aligned for float4 reads, and the 8
  // rows a quarter-warp reads start 4 banks apart
  constexpr int KT = AW_KEYS<HD>, NK = KT / 16, LD = HD + 4, LDP = KT + 1, NC = HD / 64;
  static_assert(AW_THREADS == 16 * AW_Q && AW_THREADS / 64 * 4 == AW_Q && KT % 16 == 0,
                "the thread grids cover the tiles");
  extern __shared__ __align__(16) float aw_smem[];
  float* Qs = aw_smem;          // [AW_Q][LD]
  float* Ks = Qs + AW_Q * LD;   // [KT][LD]
  float* Vs = Ks + KT * LD;     // [KT][HD]
  float* Ps = Vs + KT * HD;     // [AW_Q][LDP]: the rounded probabilities of one key tile
  const int tid = threadIdx.x;
  const int sr = tid >> 4, sc = tid & 15;        // scores: row sr, keys sc + 16 j
  const int cr = (tid >> 6) * 4, cc = tid & 63;  // context: rows cr + i, lanes cc + 64 n
  const int ntiles = (Sq + AW_Q - 1) / AW_Q;
  const long long b = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x % ntiles) * AW_Q, h = blockIdx.y;
  const int qi = q0 + sr;
  const long long col = (long long)h * HD;
  const float* kb = key_bias ? key_bias + b * Sk : nullptr;

  for (int i = tid; i < AW_Q * HD; i += AW_THREADS) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    Qs[r * LD + d] = qr < Sq ? to_f<T>(q[b * q_bs + (long long)qr * q_ss + col + d]) : 0.0f;
  }
  auto load_tile = [&](int k0, bool with_v) {
    for (int i = tid; i < KT * HD; i += AW_THREADS) {
      const int j = i / HD, d = i % HD, kj = k0 + j;
      const bool in = kj < Sk;
      Ks[j * LD + d] = in ? to_f<T>(k[b * k_bs + (long long)kj * k_ss + col + d]) : 0.0f;
      if (with_v) Vs[j * HD + d] = in ? to_f<T>(v[b * v_bs + (long long)kj * v_ss + col + d]) : 0.0f;
    }
  };
  // s[j] = the score of row qi and key k0 + sc + 16 j; -inf past the last key.
  // Each dot product runs as four independent partial sums (lanes d = 4i +
  // 0..3), so a thread keeps 4 NK FMA chains in flight instead of one
  // chain HD long.
  auto scores = [&](int k0, float (&s)[NK]) {
    float4 part[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) part[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4* qrow = reinterpret_cast<const float4*>(Qs + sr * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 a = qrow[d4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float4 c = reinterpret_cast<const float4*>(Ks + (sc + 16 * j) * LD)[d4];
        part[j].x = fmaf(a.x, c.x, part[j].x);
        part[j].y = fmaf(a.y, c.y, part[j].y);
        part[j].z = fmaf(a.z, c.z, part[j].z);
        part[j].w = fmaf(a.w, c.w, part[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int kj = k0 + sc + 16 * j;
      float x = ((part[j].x + part[j].y) + (part[j].z + part[j].w)) * scale;
      if (kj >= Sk) {
        x = -INFINITY;
      } else {
        if (mask && qi < Sq) x += mask[(long long)qi * Sk + kj];
        if (kb) x += kb[kj];
      }
      s[j] = x;
    }
  };

  // pass 1: the row's max and sum of exp(s - max) over all key tiles
  float m = -INFINITY, l = 0.0f, s[NK];
  for (int k0 = 0; k0 < Sk; k0 += KT) {
    __syncthreads();
    load_tile(k0, false);
    __syncthreads();
    scores(k0, s);
    float tmax = s[0];
#pragma unroll
    for (int j = 1; j < NK; ++j) tmax = fmaxf(tmax, s[j]);
    const float mn = fmaxf(m, group16_max(tmax));
    if (mn == -INFINITY) continue;  // every key so far masked out
    float part = l * expf(m - mn);
#pragma unroll
    for (int j = 0; j < NK; ++j) part += expf(s[j] - mn);
    l = part;
    m = mn;
  }
  const float inv = 1.0f / group16_sum(l);
  const T* krow = keep && qi < Sq ? keep + (b * Sq + qi) * keep_ld + (long long)h * Sk : nullptr;

  // pass 2: the scores again, p = round_T(exp(s - max) / sum), ctx += p v
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;
  for (int k0 = 0; k0 < Sk; k0 += KT) {
    __syncthreads();
    load_tile(k0, true);
    __syncthreads();
    scores(k0, s);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int kj = k0 + sc + 16 * j;
      Ps[sr * LDP + sc + 16 * j] =
          kj < Sk ? dropped_prob<T>(expf(s[j] - m) * inv, krow, kj, round_p_first) : 0.0f;
    }
    __syncthreads();
    const int kn = min(KT, Sk - k0);
    for (int j = 0; j < kn; ++j) {
      float a[4], c[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(cr + i) * LDP + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) c[n] = Vs[j * HD + cc + 64 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(a[i], c[n], acc[i][n]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + cr + i;
    if (qr >= Sq) continue;
    T* o = out + b * o_bs + (long long)qr * o_ss + col;
#pragma unroll
    for (int n = 0; n < NC; ++n) o[cc + 64 * n] = from_f<T>(acc[i][n]);
  }
}

template <typename T, int HD>
inline cudaError_t attention_wide_head(const T* q, long long q_bs, long long q_ss, const T* k,
                                       long long k_bs, long long k_ss, const T* v,
                                       long long v_bs, long long v_ss, T* out, long long o_bs,
                                       long long o_ss, const float* mask,
                                       const float* key_bias, int B, int Sq, int Sk, int heads,
                                       float scale, cudaStream_t stream, const T* keep,
                                       long long keep_ld, bool round_p_first) {
  constexpr size_t smem = attention_wide_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attention_wide_head_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + AW_Q - 1) / AW_Q;
  const dim3 grid((unsigned)(B * ntiles), heads);
  attention_wide_head_kernel<T, HD><<<grid, AW_THREADS, smem, stream>>>(
      q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, Sq, Sk,
      scale, keep, keep_ld, round_p_first);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel (the mma route): q·kᵀ and p·v on
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulation), the same function
// as the two FMA kernels above without a keep mask.
//
// One block of 4 warps owns 64 query rows of one (batch element, head); each
// warp owns 16 rows, one m16 tile, whose Q fragments it reads once with
// ldmatrix and keeps in registers. K and V stream through a two-stage ring
// of 64-key tiles in shared memory: cp.async brings the next tile while the
// current one computes. Rows are padded by 8 bf16 (16 bytes), so the eight
// rows an ldmatrix phase reads fall in eight distinct 16-byte bank groups.
//
// The scores' epilogue runs on the accumulator fragments in registers, in the
// FMA kernels' order: s * scale, + mask, + key_bias, -inf past Sk. The
// softmax runs in base 2: scale * log2(e) is folded into one multiply of the
// accumulator, mask and key_bias are added times log2(e), and exp(s - max)
// is exp2f(s' - max'); that differs from the FMA kernels' expf by fp32
// rounding only.
//
// The JAX rounding point is kept, p = round_bf16(exp(s - max) / sum) with the
// row's global max and sum, so p is exactly a bf16 A operand: the fp32 score
// fragment of m16n8k16's C layout is packed straight into the A layout of
// the p·v product and never touches shared memory.
//
// Up to 128 keys (two tiles) one pass suffices: a warp's 16 x 128 scores stay
// in registers, the row max and sum are shuffles over the 4 lanes that share
// a row. Longer keys take two passes, as the tiled FMA kernel does: the first
// computes the scores and each row's running max and rescaled sum; the
// second recomputes the scores, forms the rounded p and accumulates p·v, so
// q·kᵀ runs twice (1.5x the tensor work of a single-pass kernel; the price of
// keeping the rounding point without rescaling rounded values).
//
// Needs 16-byte aligned q, k, v and out and batch and row strides that are
// multiples of 8 elements (cp.async moves 16 bytes); a call that breaks that
// returns cudaErrorInvalidValue.
// ---------------------------------------------------------------------------
constexpr int AM_Q = 64, AM_K = 64, AM_THREADS = 128, AM_PAD = 8;
// attention_sm90's geometry (attention_sm90.cuh): 128 query rows and
// 128-key tiles, Q double-buffered, AS9_KSTAGES K stages (a call of at most
// that many key tiles keeps K for both passes) and AS9_VSTAGES V stages of
// 128 rows x 128 bytes, each K stage's key bias, the barriers, 1 KB of
// slack to align the tiles to the swizzle atom. It takes bf16 calls at head
// size 64 with at least ATT_MMA_MIN_SQ queries over at least ATT_SM90_MIN_SK
// keys (shorter ones keep attention_mma_kernel's one-pass form) where
// sm90_faster says it beats attention_mma_kernel's two-pass form.
constexpr int AS9_Q = 128, AS9_K = 128, AS9_KSTAGES = 5, AS9_VSTAGES = 3;
constexpr int ATT_SM90_MIN_SK = 2 * AM_K + 1;
// The measured rule (PERF.md, chip_smoke.py's sm90_sweep over ToMe's
// layers, Sq = Sk): the Hopper kernel's 128-row, 128-key tiles cost a whole
// tile for a partial one, where attention_mma_kernel's are 64; up to 3
// tiles it is faster only where the last tile is more than half full (or
// full), past 3 tiles at every length.
inline bool sm90_faster(int Sk) {
  return Sk > 3 * AS9_K || Sk % AS9_K == 0 || Sk % AS9_K > AS9_K / 2;
}
constexpr size_t AS9_SMEM = 1024 + (size_t)(2 * AS9_Q + (AS9_KSTAGES + AS9_VSTAGES) * AS9_K) * 128 +
                            (size_t)AS9_KSTAGES * AS9_K * 4 +
                            8 * (size_t)(2 * 2 + 2 * AS9_KSTAGES + 2 * AS9_VSTAGES);
constexpr int ATT_MMA_MIN_SQ = 16, ATT_MMA_MIN_SK = 16, ATT_SHORT_MAX = 16;
constexpr float LOG2E = 1.4426950408889634f;

// The kernel family qt::attention takes ("wgmma": the Hopper kernel of
// attention_sm90.cuh, bf16 past 128 keys at head size 64, which
// attention_plan picks among the "mma" calls). With a keep mask, at head sizes
// 32, 64 and 128 over at most ATT_KEEP_MAX_SK keys, in bf16 and fp32: the
// keep-masked tensor-core kernel (attention_keep.cu). For bf16 without a
// keep mask at a head size the tensor-core kernels are built for: a warp per
// problem when both lengths are at most ATT_SHORT_MAX, else 64 query rows
// per block when there are at least ATT_MMA_MIN_SQ queries and
// ATT_MMA_MIN_SK keys or the head is 256 or 512 lanes wide (the wide kernels
// mask any length). Without a keep mask, an additive mask or a key bias, at
// head sizes 32, 64 and 128 over at most ATT_KEEP_MAX_SK keys, the same
// kernel with its keep multiply compiled out ("mma_nokeep") in bf16 for
// fewer than ATT_MMA_MIN_SQ queries over more than ATT_SHORT_MAX keys. In
// fp32 without a keep mask: at head sizes 32, 64 and 128 route
// "mma_nokeep" at any length, with or without a mask or a key bias (past
// ATT_KEEP_MAX_SK keys its key-tiled form); at head sizes 256 and 512
// without a mask or a key bias route "tf32x3", the lane split's stages.
// The FMA kernels otherwise (fp32 wide heads with a mask or key bias, other
// head sizes; bf16 with a mask or key bias at those lengths; a keep mask at
// other head sizes or past ATT_KEEP_MAX_SK keys). attention_plan has the
// last word: a call whose tensor-core kernel would pass the shared memory
// goes to the FMA kernels.
enum AttentionRoute {
  ATT_ROUTE_FMA = 0,
  ATT_ROUTE_MMA = 1,
  ATT_ROUTE_MMA_SHORT = 2,
  ATT_ROUTE_MMA_KEEP = 3,
  ATT_ROUTE_MMA_NOKEEP = 4,
  ATT_ROUTE_TF32X3 = 5,
  ATT_ROUTE_WGMMA = 6
};

inline bool wide_head(int hd) { return hd == 256 || hd == 512; }

// The keep-masked kernels' geometry (attention_keep.cu): a warp owns 16
// query rows; at most AK_ROWS queries and keys a warp owns a whole problem
// (the short form), else a block of AK_WARPS warps owns AK_Q query rows
// (forward) or the whole problem (backward). Staged rows hold hd lanes plus
// 16 bytes; the backward's dS and pd rows Sk rounded up to 16 keys plus 16
// bytes (bf16) or 4 lanes (fp32), so that their fragment reads hit 32 banks.
constexpr int AK_WARPS = 4, AK_THREADS = AK_WARPS * 32, AK_ROWS = 16, AK_Q = AK_WARPS * AK_ROWS;
constexpr int ATT_KEEP_MAX_SK = 128;

inline bool keep_head(int hd) { return hd == 32 || hd == 64 || hd == 128; }
inline __host__ __device__ int keep_pad16(int n) { return (n + 15) / 16 * 16; }
constexpr __host__ __device__ int keep_stage_ld(int hd, int esize) { return hd + 16 / esize; }
inline __host__ __device__ int keep_pld(int Sk, int esize) {
  return keep_pad16(Sk) + (esize == 4 ? 4 : 8);
}
inline __host__ __device__ bool keep_short(int Sq, int Sk) {
  return Sq <= AK_ROWS && Sk <= AK_ROWS;
}

// The forward's three forms: AK_SHORT at most AK_ROWS queries and keys
// (AK_WARPS warps a block, a problem each); AK_WARP, without a keep mask, at
// most AK_ROWS queries over more keys (one query over 17-128 keys,
// TempMoE's 1 x 60: a block of one warp that owns the problem, where a
// 64-row block would idle three of its four warps; no keep-masked call of
// a model has that shape, and those keep the long form); AK_LONG otherwise
// (64 query rows a block)
enum KeepForm { AK_SHORT = 0, AK_WARP = 1, AK_LONG = 2 };
inline __host__ __device__ KeepForm keep_form(int Sq, int Sk, bool has_keep) {
  return keep_short(Sq, Sk) ? AK_SHORT : Sq <= AK_ROWS && !has_keep ? AK_WARP : AK_LONG;
}

// each forward form's dynamic shared memory per block: Q, K and V rows
inline size_t attention_keep_smem_bytes(int esize, int Sq, int Sk, int hd, bool has_keep) {
  const size_t ld = keep_stage_ld(hd, esize);
  switch (keep_form(Sq, Sk, has_keep)) {
    case AK_SHORT: return (size_t)esize * AK_WARPS * 3 * AK_ROWS * ld;
    case AK_WARP: return (size_t)esize * (AK_ROWS + 2 * keep_pad16(Sk)) * ld;
    default: return (size_t)esize * (AK_Q + 2 * keep_pad16(Sk)) * ld;
  }
}

// the long backward's K and V rows, which stage its warps' dk and dv tiles
// once K and V are read: at least AK_Q together
inline __host__ __device__ int keep_kv_rows(int Sk) {
  return 2 * keep_pad16(Sk) > AK_Q ? 2 * keep_pad16(Sk) : AK_Q;
}

inline size_t attention_keep_bwd_smem_bytes(int esize, int Sq, int Sk, int hd) {
  const size_t ld = keep_stage_ld(hd, esize), pld = keep_pld(Sk, esize);
  if (keep_short(Sq, Sk)) return (size_t)esize * AK_WARPS * AK_ROWS * (4 * ld + 2 * pld);
  const size_t sq = keep_pad16(Sq);
  return (size_t)esize * ((2 * sq + keep_kv_rows(Sk)) * ld + 2 * sq * pld);
}

// The key-tiled fp32 forward without a keep mask (attention_keep.cu,
// "mma_nokeep_tiled"): a block of AKT_WARPS warps owns AKT_Q query rows of a
// problem and streams its keys in AKT_K-key tiles through a two-stage ring;
// shared memory: the Q rows, then two stages of K and two of V, rows of hd
// lanes plus 16 bytes
constexpr int AKT_WARPS = 8, AKT_THREADS = AKT_WARPS * 32, AKT_Q = AKT_WARPS * AK_ROWS,
              AKT_K = 64;
inline size_t attention_nokeep_tiled_smem_bytes(int hd) {
  return sizeof(float) * (size_t)(AKT_Q + 4 * AKT_K) * keep_stage_ld(hd, (int)sizeof(float));
}

// The lane split's two stages (attention_tp.cuh, "lane_split"): the larger
// of their rings, two stages of 128 rows of 144 bytes (the scores stage's
// Q and K slabs; attention_tp.cuh checks it against its geometry)
constexpr size_t ATT_LANES_SMEM = 2 * 128 * 144;

// has_bias: the call adds an additive mask or a key bias to its scores,
// which the keep-masked kernel takes only in fp32 without a keep mask, and
// the lane split not at all
inline AttentionRoute attention_route(bool bf16, int Sq, int Sk, int hd, bool has_keep,
                                      bool has_bias) {
  const bool head = hd == 32 || hd == 64 || hd == 128 || wide_head(hd);
  const bool keep_shape = keep_head(hd) && Sk >= 1 && Sk <= ATT_KEEP_MAX_SK;
  if (has_keep) return keep_shape ? ATT_ROUTE_MMA_KEEP : ATT_ROUTE_FMA;
  if (!bf16) {
    if (keep_head(hd) && Sk >= 1) return ATT_ROUTE_MMA_NOKEEP;
    return wide_head(hd) && Sk >= 1 && !has_bias ? ATT_ROUTE_TF32X3 : ATT_ROUTE_FMA;
  }
  const bool nokeep = keep_shape && !has_bias;
  if (!head) return ATT_ROUTE_FMA;
  if (Sq <= ATT_SHORT_MAX && Sk <= ATT_SHORT_MAX) return ATT_ROUTE_MMA_SHORT;
  if (wide_head(hd) || (Sq >= ATT_MMA_MIN_SQ && Sk >= ATT_MMA_MIN_SK)) return ATT_ROUTE_MMA;
  // one query (fewer than ATT_MMA_MIN_SQ) over more than ATT_SHORT_MAX keys
  return nokeep && Sq < ATT_MMA_MIN_SQ ? ATT_ROUTE_MMA_NOKEEP : ATT_ROUTE_FMA;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: bf16 a (16 x 16) and b (16 x 8), fp32 c
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 3xTF32 split (gemm_tf32x3.cuh, attention_tp.cuh): x = hi + lo, both
// tf32 (fp32 bit patterns with the low 13 mantissa bits 0)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a b for one m16n8k8 tile: tf32 a (16 x 8, row) and b (8 x 8, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the tensor-core kernels' operands: 16-byte aligned pointers and strides
// (or'ed together) that are multiples of 8 elements, as cp.async moves 16
// bytes
inline bool tc_aligned(const void* q, const void* k, const void* v, const void* out,
                       long long strides) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  return !(ptrs & 15) && !(strides & 7);
}

template <int HD>
constexpr size_t attention_mma_smem_bytes() {
  // Q tile, then two stages of K and two of V
  return sizeof(__nv_bfloat16) * (size_t)(AM_Q + 4 * AM_K) * (HD + AM_PAD);
}

// A thread's fragments, with g = lane / 4 and t = lane % 4: score s[j][e] is
// row g + 8 (e / 2) of the warp's 16 and key 8 j + 2 t + e % 2 of the tile;
// context o[n][e] is the same row and lane 8 n + 2 t + e % 2 of the head.
template <int HD, bool ONE_PASS>
__global__ void __launch_bounds__(AM_THREADS)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, long long q_bs, long long q_ss,
                     const __nv_bfloat16* __restrict__ k, long long k_bs, long long k_ss,
                     const __nv_bfloat16* __restrict__ v, long long v_bs, long long v_ss,
                     __nv_bfloat16* __restrict__ out, long long o_bs, long long o_ss,
                     const float* __restrict__ mask, const float* __restrict__ key_bias, int Sq,
                     int Sk, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + AM_PAD, KD = HD / 16, ND = HD / 8, CHUNKS = HD / 8;
  static_assert(AM_Q == 64 && AM_K == 64 && (64 * CHUNKS) % AM_THREADS == 0,
                "4 warps of 16 rows, 64-key tiles");
  extern __shared__ __align__(16) unsigned char am_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(am_smem);  // [AM_Q][LD]
  bf16* Ks = Qs + AM_Q * LD;                     // [2][AM_K][LD]
  bf16* Vs = Ks + 2 * AM_K * LD;                 // [2][AM_K][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ntiles = (Sq + AM_Q - 1) / AM_Q, nkt = (Sk + AM_K - 1) / AM_K;
  const long long b = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x % ntiles) * AM_Q, h = blockIdx.y;
  const long long col = (long long)h * HD;
  const bf16* qh = q + b * q_bs + col;  // this head's columns
  const bf16* kh = k + b * k_bs + col;
  const bf16* vh = v + b * v_bs + col;
  const float* kbias = key_bias ? key_bias + b * Sk : nullptr;
  const int row0 = q0 + warp * 16 + g;  // this thread's first row; the second is row0 + 8
  // a warp whose 16 rows all lie past Sq loads its share of the tiles and
  // computes nothing
  const bool live = q0 + warp * 16 < Sq;

  // rows r0 .. r0 + 63 of one head's [*, HD] slice into a tile, zero past n
  auto load_rows = [&](bf16* dst, const bf16* src, long long ss, int r0, int n) {
#pragma unroll
    for (int it = 0; it < 64 * CHUNKS / AM_THREADS; ++it) {
      const int i = tid + it * AM_THREADS, r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const bool in = r0 + r < n;
      cp_async16(dst + r * LD + c, in ? src + (long long)(r0 + r) * ss + c : src, in);
    }
  };

  uint32_t qf[KD][4];
  auto load_q_frags = [&]() {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  };

  // the scores of key tile k0 (K in Kt) in base 2, -inf past Sk; only the
  // last tile can pass Sk, so the others skip the bounds test
  const float scale2 = scale * LOG2E;
  auto scores = [&](const bf16* Kt, int k0, float (&s)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
    auto epilogue = [&](auto bounded) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = row0 + (e >> 1) * 8, kj = k0 + 8 * j + 2 * t4 + (e & 1);
          float x = s[j][e] * scale2;
          if (decltype(bounded)::value && kj >= Sk) {
            x = -INFINITY;
          } else {
            if (mask && qi < Sq) x = fmaf(mask[(long long)qi * Sk + kj], LOG2E, x);
            if (kbias) x = fmaf(kbias[kj], LOG2E, x);
          }
          s[j][e] = x;
        }
    };
    if (k0 + AM_K <= Sk)
      epilogue(std::false_type{});
    else
      epilogue(std::true_type{});
  };

  // o += p v over one key tile (V in Vt), p the tile's fp32 probabilities
  // rounded to bf16 as they are packed into A fragments
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  auto pv = [&](const bf16* Vt, const float (&p)[8][4]) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pa[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                              pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                              pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                              pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  };

  if constexpr (ONE_PASS) {
    // at most two key tiles: tile t in stage t, both resident at once
    load_rows(Qs, qh, q_ss, q0, Sq);
    load_rows(Ks, kh, k_ss, 0, Sk);
    load_rows(Vs, vh, v_ss, 0, Sk);
    cp_async_commit();
    if (nkt > 1) {
      load_rows(Ks + AM_K * LD, kh, k_ss, AM_K, Sk);
      load_rows(Vs + AM_K * LD, vh, v_ss, AM_K, Sk);
    }
    cp_async_commit();
    float s[2][8][4];
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      load_q_frags();
      scores(Ks, 0, s[0]);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!live) return;
    if (nkt > 1) {
      scores(Ks + AM_K * LD, AM_K, s[1]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[1][j][e] = -INFINITY;
    }
    float m[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[tt][j][2 * r], s[tt][j][2 * r + 1]));
      m[r] = quad_max(mx);
      float sum = 0.0f;
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2f(s[tt][j][e] - m[r]);
            s[tt][j][e] = p;
            sum += p;
          }
      inv[r] = 1.0f / quad_sum(sum);
    }
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[tt][j][e] *= inv[e >> 1];
    pv(Vs, s[0]);
    if (nkt > 1) pv(Vs + AM_K * LD, s[1]);
  } else {
    // item i of 2 nkt: key tile i (pass 1: K only), then key tile i - nkt
    // (pass 2: K and V), into stage i % 2
    const int items = 2 * nkt;
    auto fetch = [&](int i) {
      const int st = (i & 1) * AM_K * LD, k0 = (i < nkt ? i : i - nkt) * AM_K;
      load_rows(Ks + st, kh, k_ss, k0, Sk);
      if (i >= nkt) load_rows(Vs + st, vh, v_ss, k0, Sk);
    };
    load_rows(Qs, qh, q_ss, q0, Sq);
    fetch(0);
    cp_async_commit();
    // pass 1 keeps, per row, the running max and this thread's part of the
    // sum rescaled to it; the row's sum is the 4 parts' total
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
    for (int i = 0; i < items; ++i) {
      if (i + 1 < items) {
        fetch(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (live) {
        if (i == 0) load_q_frags();
        const int st = (i & 1) * AM_K * LD, k0 = (i < nkt ? i : i - nkt) * AM_K;
        float s[8][4];
        scores(Ks + st, k0, s);
        if (i < nkt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            const float mn = fmaxf(m[r], quad_max(mx));
            if (mn == -INFINITY) continue;  // every key so far masked out
            float part = l[r] * exp2f(m[r] - mn);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              part += exp2f(s[j][2 * r] - mn) + exp2f(s[j][2 * r + 1] - mn);
            l[r] = part;
            m[r] = mn;
          }
          if (i == nkt - 1) {
            inv[0] = 1.0f / quad_sum(l[0]);
            inv[1] = 1.0f / quad_sum(l[1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m[e >> 1]) * inv[e >> 1];
          pv(Vs + st, s);
        }
      }
      __syncthreads();  // stage i % 2 is refilled by the next iteration's fetch
    }
    if (!live) return;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    bf16* orow = out + b * o_bs + (long long)qi * o_ss + col + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
  }
}

template <int HD>
inline cudaError_t attention_mma(const __nv_bfloat16* q, long long q_bs, long long q_ss,
                                 const __nv_bfloat16* k, long long k_bs, long long k_ss,
                                 const __nv_bfloat16* v, long long v_bs, long long v_ss,
                                 __nv_bfloat16* out, long long o_bs, long long o_ss,
                                 const float* mask, const float* key_bias, int B, int Sq, int Sk,
                                 int heads, float scale, cudaStream_t stream) {
  if (!tc_aligned(q, k, v, out, q_bs | q_ss | k_bs | k_ss | v_bs | v_ss | o_bs | o_ss))
    return cudaErrorInvalidValue;
  constexpr size_t smem = attention_mma_smem_bytes<HD>();
  const bool one_pass = Sk <= 2 * AM_K;
  auto kernel = one_pass ? attention_mma_kernel<HD, true> : attention_mma_kernel<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + AM_Q - 1) / AM_Q;
  kernel<<<dim3((unsigned)(B * ntiles), heads), AM_THREADS, smem, stream>>>(
      q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, Sq, Sk,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The short-problem tensor-core kernel (route mma_short): bf16 without a keep
// mask, at most ATT_SHORT_MAX queries and keys. It replaces, for this card,
// the packed route of qa_tiger_tpu/ops/pallas/attention.py (_packed_kernel),
// which stacked 16 problems of 14 keys into one block-diagonal 128 x 128
// score matrix to fill the TPU's matrix unit.
//
// Such a problem is one m16n8k16 tile: its queries are the 16 rows of the A
// operand, its keys two n-tiles of 8. So one warp owns one (batch element,
// head) problem whole, and a block of AS_WARPS warps grid-strides over
// B * heads problems (122,880 at PatchSelecter's B=256 x T=60 x 8 heads, past
// the 65,535 that a grid's y and z allow). mma.sync and not wgmma: wgmma's
// 64-row minimum would force block-diagonal packing of four problems, with
// 75% of every score tile masked out, the waste the TPU layout paid and this
// card does not need.
//
// Bound: bytes. At [122880, 14, 64] a problem does 2 x 14 x 14 x 64 MACs on
// 4 x 14 x 64 bf16 values, about 7 operations per byte. So the design reads
// q, k and v once and writes the context once, all in 16-byte accesses:
// - each warp brings its problem's rows into shared memory with cp.async,
//   rows past Sq or Sk zero-filled (no address past them is read), through
//   a two-stage ring of its own, so the next problem's copies overlap this
//   one's math;
// - S = Q K^T on mma.sync (hd / 16 k-steps x 2 n-tiles); the epilogue in
//   registers in the FMA kernel's order and arithmetic: s * scale, + mask,
//   + key_bias, -inf past Sk; row max and sum over the 4 lanes of a row;
//   p = round_bf16(exp(s - max) / sum), the JAX rounding point;
// - p's C fragments are packed in registers as the A operand of P V (V
//   through ldmatrix.trans), hd / 8 n-tiles in fp32;
// - the context goes through the problem's Q rows in shared memory (read
//   into registers by then) so that rows < Sq leave as 16-byte stores.
// No score or probability reaches device memory.
//
// Needs the alignment of the mma kernel (16-byte pointers, strides that are
// multiples of 8 elements); a call that breaks it returns
// cudaErrorInvalidValue.
// ---------------------------------------------------------------------------
constexpr int AS_WARPS = 4, AS_ROWS = 16;

// The grid of a kernel with a warp per problem (AS_WARPS warps a block): as
// many blocks as the card holds at once, at most one per AS_WARPS problems;
// each warp then strides over problems, so its ring overlaps one problem's
// copies with another's math. Read once per kernel.
template <auto Kernel>
inline int warp_problem_blocks(size_t smem, long long problems) {
  static const int resident = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, AS_WARPS * 32, smem);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  const long long needed = (problems + AS_WARPS - 1) / AS_WARPS;
  return needed < resident ? (int)needed : resident;
}

template <int HD>
constexpr size_t attention_short_smem_bytes() {
  // per warp two stages, each the Q, K and V rows of one problem
  return sizeof(__nv_bfloat16) * (size_t)AS_WARPS * 2 * 3 * AS_ROWS * (HD + AM_PAD);
}

// A lane's fragments, with g = lane / 4 and t = lane % 4: score s[j][e] is
// query g + 8 (e / 2) and key 8 j + 2 t + e % 2; context o[n][e] the same
// query and lane 8 n + 2 t + e % 2 of the head.
template <int HD>
__global__ void __launch_bounds__(AS_WARPS * 32)
attention_short_kernel(const __nv_bfloat16* __restrict__ q, long long q_bs, long long q_ss,
                       const __nv_bfloat16* __restrict__ k, long long k_bs, long long k_ss,
                       const __nv_bfloat16* __restrict__ v, long long v_bs, long long v_ss,
                       __nv_bfloat16* __restrict__ out, long long o_bs, long long o_ss,
                       const float* __restrict__ mask, const float* __restrict__ key_bias,
                       int problems, int heads, int Sq, int Sk, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + AM_PAD, KD = HD / 16, ND = HD / 8, CHUNKS = HD / 8;
  constexpr int STAGE = 3 * AS_ROWS * LD, PER_LANE = AS_ROWS * CHUNKS / 32;
  static_assert(ATT_SHORT_MAX == AS_ROWS && (AS_ROWS * CHUNKS) % 32 == 0,
                "one m16 tile of queries, two n8 tiles of keys");
  extern __shared__ __align__(16) unsigned char as_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  bf16* const ring = reinterpret_cast<bf16*>(as_smem) + (size_t)warp * 2 * STAGE;
  const int stride = gridDim.x * AS_WARPS;

  // n rows of one head's [*, HD] slice into dst, zero past them
  auto load_rows = [&](bf16* dst, const bf16* src, long long ss, int n) {
#pragma unroll
    for (int it = 0; it < PER_LANE; ++it) {
      const int i = lane + it * 32, r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const bool in = r < n;
      cp_async16(dst + r * LD + c, in ? src + r * ss + c : src, in);
    }
  };
  auto fetch = [&](int pr, int st) {
    const long long b = pr / heads, col = (long long)(pr % heads) * HD;
    bf16* dst = ring + st * STAGE;
    load_rows(dst, q + b * q_bs + col, q_ss, Sq);
    load_rows(dst + AS_ROWS * LD, k + b * k_bs + col, k_ss, Sk);
    load_rows(dst + 2 * AS_ROWS * LD, v + b * v_bs + col, v_ss, Sk);
  };

  int pr = blockIdx.x * AS_WARPS + warp;
  if (pr < problems) fetch(pr, 0);
  cp_async_commit();
  for (int it = 0; pr < problems; ++it, pr += stride) {
    const int st = it & 1;
    if (pr + stride < problems) fetch(pr + stride, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this problem's group has landed
    __syncwarp();
    bf16* const Qs = ring + st * STAGE;
    const bf16* Ks = Qs + AS_ROWS * LD;
    const bf16* Vs = Ks + AS_ROWS * LD;
    const long long b = pr / heads, col = (long long)(pr % heads) * HD;

    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], bk[4];
      ldmatrix_x4(a, Qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(bk, Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }
    const float* kb = key_bias ? key_bias + b * Sk : nullptr;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = g + 8 * (e >> 1), kj = 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale;
        if (kj >= Sk) {
          x = -INFINITY;
        } else {
          if (mask && qi < Sq) x += mask[(long long)qi * Sk + kj];
          if (kb) x += kb[kj];
        }
        s[j][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx =
          quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]), fmaxf(s[1][2 * r], s[1][2 * r + 1])));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - mx);
          sum += s[j][e];
        }
      const float inv = 1.0f / quad_sum(sum);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * r] *= inv;
        s[j][2 * r + 1] *= inv;
      }
    }

    // o = p v: p rounded to bf16 as its C fragments become the A operand
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
    float o[ND][4] = {};
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
    }

    // the context through the Q rows (in registers since the scores), then
    // rows < Sq to device memory 16 bytes a lane
    __syncwarp();
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(Qs + (g + 8 * r) * LD + 8 * n + 2 * t4) =
            __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
    __syncwarp();
    bf16* const ob = out + b * o_bs + col;
#pragma unroll
    for (int it = 0; it < PER_LANE; ++it) {
      const int i = lane + it * 32, r = i / CHUNKS, c = (i % CHUNKS) * 8;
      if (r < Sq)
        *reinterpret_cast<uint4*>(ob + r * o_ss + c) =
            *reinterpret_cast<const uint4*>(Qs + r * LD + c);
    }
    __syncwarp();  // the next iteration's fetch refills the other stage; this
                   // one is refilled only after it
  }
}

template <int HD>
inline cudaError_t attention_short(const __nv_bfloat16* q, long long q_bs, long long q_ss,
                                   const __nv_bfloat16* k, long long k_bs, long long k_ss,
                                   const __nv_bfloat16* v, long long v_bs, long long v_ss,
                                   __nv_bfloat16* out, long long o_bs, long long o_ss,
                                   const float* mask, const float* key_bias, int B, int Sq,
                                   int Sk, int heads, float scale, cudaStream_t stream) {
  if (!tc_aligned(q, k, v, out, q_bs | q_ss | k_bs | k_ss | v_bs | v_ss | o_bs | o_ss))
    return cudaErrorInvalidValue;
  constexpr size_t smem = attention_short_smem_bytes<HD>();
  auto kernel = attention_short_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long problems = (long long)B * heads;
  if (problems > INT_MAX) return cudaErrorInvalidValue;
  const int blocks = warp_problem_blocks<attention_short_kernel<HD>>(smem, problems);
  kernel<<<blocks, AS_WARPS * 32, smem, stream>>>(q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss,
                                                  out, o_bs, o_ss, mask, key_bias,
                                                  (int)problems, heads, Sq, Sk, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide-head tensor-core kernels (kernels "mma_wide" and
// "mma_wide_short"): bf16 without a keep mask at head sizes 256 and 512.
// They replace, for this card, the body of fused_attention_wide's
// pl.pallas_call at those head sizes (_wide_body,
// qa_tiger_tpu/ops/pallas/attention.py), which TSPM calls with one head of
// 512 lanes: AV_Attn over 60 frames and TokensAttn over 14 patches.
//
// Bound: bytes. AV_Attn ([512, 60, 512], one head) does 4 x 60 x 60 x 512
// operations on 4 x 60 x 512 bf16 values per problem, 30 per byte against a
// ridge of ~295; TokensAttn about 7. So the design reads q, k and v once per
// block (per problem at the short shapes) and writes the context once, with
// 16-byte cp.async copies, and keeps the scores and probabilities on chip.
// The other mma kernels hold a warp's Q fragments in registers and whole
// 64-key tiles of K and V in shared memory: at 512 lanes that is 128
// registers a thread and, for a two-stage ring, more than a block's shared
// memory. So here the head streams in slabs of AWM_SLAB = 64 lanes:
// - q·kᵀ: each ring stage holds a 64-lane slab of Q's rows and of K's keys;
//   ldmatrix reads the fragments and mma.sync.m16n8k16 (bf16 in, fp32 out)
//   sums each warp's 16 x 64 score tile over the HD / 64 slabs in registers;
// - the epilogue runs on the fragments, as in attention_mma_kernel (base 2,
//   s * scale, + mask, + key_bias, -inf past Sk), then p = round_bf16(exp(s
//   - max) / sum) with the row's global max and sum;
// - p·v by lane chunks: V streams through the same ring in 64-lane chunks,
//   read with ldmatrix.trans; each warp sums a 16 x 64 fp32 context chunk
//   and stores it before the next, so registers stay bounded whatever HD is.
// The mma kernel (64 query rows of one (batch element, head) per block of 4
// warps, rows past Sq masked, so any Sq works) keeps up to 128 keys' scores
// in registers (one pass) and packs p from their C fragments straight into
// the A fragments of p·v; its shared memory is then the ring alone (36,864
// bytes), so five blocks share an SM and AV_Attn's 512 blocks run in one
// wave. Past 128 keys it takes two passes, as the tiled kernels do, to keep
// the JAX rounding point: the first takes each row's max and rescaled sum,
// the second recomputes the scores and writes p to shared memory, 64 rows x
// Sk rounded up to 16 (74 KB at 577 keys), which the lane chunks read with
// ldmatrix; a call whose p would not fit (past 1,520 keys) is planned onto
// the FMA wide-head kernel. The short kernel (at most 16 queries and keys)
// gives each warp one problem and a ring of its own, and keeps p in
// registers.
//
// Needs the alignment of the mma kernel (16-byte pointers, strides that are
// multiples of 8 elements); a call that breaks it returns
// cudaErrorInvalidValue.
// ---------------------------------------------------------------------------
// AWM_MIN_BLOCKS: blocks per SM the one-pass mma kernel is compiled for
// (registers; its ring of 36,864 bytes fits six): five ran AV_Attn fastest
// of four, five and six (PERF.md §6)
constexpr int AWM_SLAB = 64, AWM_LD = AWM_SLAB + AM_PAD, AWM_STAGES = 2, AWM_MIN_BLOCKS = 5;
constexpr int AWM_STAGE_ROWS = AM_Q + AM_K;  // a Q slab and a K slab; a V chunk uses AM_K rows

// the columns of the mma kernel's probability rows: Sk rounded up to a k-step
inline __host__ __device__ int attention_mma_wide_pcols(int Sk) { return (Sk + 15) / 16 * 16; }

// the ring; in two passes (past 2 AM_K keys) also p
inline size_t attention_mma_wide_smem_bytes(int Sk) {
  const size_t p = Sk > 2 * AM_K ? (size_t)AM_Q * (attention_mma_wide_pcols(Sk) + AM_PAD) : 0;
  return sizeof(__nv_bfloat16) * ((size_t)AWM_STAGES * AWM_STAGE_ROWS * AWM_LD + p);
}

constexpr size_t attention_wide_short_smem_bytes() {
  // per warp AWM_STAGES stages, each a Q and a K slab of one problem
  return sizeof(__nv_bfloat16) * (size_t)AS_WARPS * AWM_STAGES * 2 * AS_ROWS * AWM_LD;
}

// rows r0 .. r0 + ROWS - 1 of a bf16 source with row stride ss, lanes
// c0 .. c0 + 63, into a [ROWS][AWM_LD] slab, zero past row n; THREADS
// threads share the copy, this one being thread tid of them. Each copy asks
// L2 for the 256 bytes around it, so the row's next slab is there when its
// turn comes (a DRAM burst per two slabs).
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_slab(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int r0, int n, int c0, int tid) {
  static_assert(ROWS * 8 % THREADS == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i >> 3, c = (i & 7) * 8;
    const bool in = r0 + r < n;
    const void* from = in ? src + (long long)(r0 + r) * ss + c0 + c : src;
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst + r * AWM_LD + c)), "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// s += the 16 x 8 NJ scores of one slab: a warp's 16 Q rows (Qw) against
// 8 NJ keys (Kt), both [*][AWM_LD]
template <int NJ>
__device__ __forceinline__ void qk_slab(float (&s)[NJ][4], const __nv_bfloat16* Qw,
                                        const __nv_bfloat16* Kt, int lane) {
#pragma unroll
  for (int kk = 0; kk < AWM_SLAB / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, Qw + (lane & 15) * AWM_LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t bk[4];
      ldmatrix_x4(bk, Kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * AWM_LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jp], a, bk[0], bk[1]);
      mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
    }
  }
}

// o += p v over one 16-key step: p the A fragment, V 16 keys x 64 lanes
// ([*][AWM_LD], key 0 at Vt) read transposed
__device__ __forceinline__ void pv_step(float (&o)[8][4], const uint32_t (&pa)[4],
                                        const __nv_bfloat16* Vt, int lane) {
#pragma unroll
  for (int dp = 0; dp < AWM_SLAB / 16; ++dp) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * AWM_LD + dp * 16 +
                              (lane >> 4) * 8);
    mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
    mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
  }
}

// A thread's fragments, with g = lane / 4 and t = lane % 4: score s[.][j][e]
// is row g + 8 (e / 2) of the warp's 16 and key 8 j + 2 t + e % 2 of the
// tile; context o[n][e] the same row and lane 8 n + 2 t + e % 2 of the chunk.
template <int HD, int NT>
__global__ void __launch_bounds__(AM_THREADS, NT == 1 ? AWM_MIN_BLOCKS : 2)
attention_mma_wide_kernel(const __nv_bfloat16* __restrict__ q, long long q_bs, long long q_ss,
                          const __nv_bfloat16* __restrict__ k, long long k_bs, long long k_ss,
                          const __nv_bfloat16* __restrict__ v, long long v_bs, long long v_ss,
                          __nv_bfloat16* __restrict__ out, long long o_bs, long long o_ss,
                          const float* __restrict__ mask, const float* __restrict__ key_bias,
                          int Sq, int Sk, float scale) {
  using bf16 = __nv_bfloat16;
  // NT > 0: one pass, the scores of all NT key tiles held at once; 0: two
  constexpr bool ONE_PASS = NT > 0;
  constexpr int ND = HD / AWM_SLAB, STAGE = AWM_STAGE_ROWS * AWM_LD, NS = ONE_PASS ? NT : 1;
  static_assert(AM_Q == 4 * 16 && AM_K == 64 && HD % AWM_SLAB == 0 && NT <= 2,
                "4 warps of 16 rows");
  extern __shared__ __align__(16) unsigned char awm_smem[];
  bf16* const ring = reinterpret_cast<bf16*>(awm_smem);  // [AWM_STAGES][STAGE]
  const int pcols = attention_mma_wide_pcols(Sk), pld = pcols + AM_PAD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // two passes: the warp's 16 rows of p, [16][pld], after the ring; a row
  // stride of an odd number of 16-byte groups, so ldmatrix and the bf16x2
  // stores hit distinct banks
  bf16* const Pw = ring + AWM_STAGES * STAGE + (size_t)warp * 16 * pld;
  const int ntiles = (Sq + AM_Q - 1) / AM_Q, nkt = ONE_PASS ? NT : (Sk + AM_K - 1) / AM_K;
  const long long b = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x % ntiles) * AM_Q, h = blockIdx.y;
  const long long col = (long long)h * HD;
  const bf16* qh = q + b * q_bs + col;  // this head's columns
  const bf16* kh = k + b * k_bs + col;
  const bf16* vh = v + b * v_bs + col;
  const float* kbias = key_bias ? key_bias + b * Sk : nullptr;
  const int row0 = q0 + warp * 16 + g;  // this thread's first row; the second is row0 + 8
  // a warp whose 16 rows all lie past Sq loads its share of the slabs and
  // computes nothing
  const bool live = q0 + warp * 16 < Sq;

  // items: the score slabs (key tile t, lanes d), once or, in two passes,
  // twice; then the V chunks (lanes c, key tile t); item i in stage i % 2
  const int nqk = (ONE_PASS ? 1 : 2) * nkt * ND, items = nqk + ND * nkt;
  auto fetch = [&](int i) {
    bf16* st = ring + (i % AWM_STAGES) * STAGE;
    if (i < nqk) {
      const int t = (i / ND) % nkt, d = i % ND;
      load_slab<AM_Q, AM_THREADS>(st, qh, q_ss, q0, Sq, d * AWM_SLAB, tid);
      load_slab<AM_K, AM_THREADS>(st + AM_Q * AWM_LD, kh, k_ss, t * AM_K, Sk, d * AWM_SLAB, tid);
    } else {
      const int c = (i - nqk) / nkt, t = (i - nqk) % nkt;
      load_slab<AM_K, AM_THREADS>(st, vh, v_ss, t * AM_K, Sk, c * AWM_SLAB, tid);
    }
  };

  // the scores of key tile k0 in base 2, -inf past Sk
  const float scale2 = scale * LOG2E;
  auto finish_scores = [&](float (&s)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + (e >> 1) * 8, kj = k0 + 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale2;
        if (kj >= Sk) {
          x = -INFINITY;
        } else {
          if (mask && qi < Sq) x = fmaf(mask[(long long)qi * Sk + kj], LOG2E, x);
          if (kbias) x = fmaf(kbias[kj], LOG2E, x);
        }
        s[j][e] = x;
      }
  };
  // p = round_bf16(exp(s - max) / sum) of key tile k0 into the warp's rows
  // of p, the columns below pcols (p is 0 from Sk on)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
  auto store_p = [&](const float (&s)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kj = k0 + 8 * j + 2 * t4;
      if (kj >= pcols) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(Pw + (g + 8 * r) * pld + kj) =
            __floats2bfloat162_rn(exp2f(s[j][2 * r] - m[r]) * inv[r],
                                  exp2f(s[j][2 * r + 1] - m[r]) * inv[r]);
    }
  };

  // item i: its copies land (the next item's start behind them), then every
  // thread may read stage i % 2
  auto arrive = [&](int i) {
    if (i + 1 < items) {
      fetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return ring + (i % AWM_STAGES) * STAGE;
  };
  fetch(0);
  cp_async_commit();

  // the scores and p, then the context: two loops, so that the scores and
  // the context are never held in registers at once. In one pass p stays in
  // registers as the A fragments of p·v: pa[t][ks] holds keys 64 t + 16 ks
  // .. + 15 of the warp's 16 rows.
  float s[NS][8][4];
  uint32_t pa[ONE_PASS ? NS : 1][AM_K / 16][4];
  for (int i = 0; i < nqk; ++i) {
    const bf16* st = arrive(i);
    if (live) {
      const int t = (i / ND) % nkt, d = i % ND;
      auto slab = [&](float (&sc)[8][4]) {
        if (d == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
        }
        qk_slab<8>(sc, st + warp * 16 * AWM_LD, st + AM_Q * AWM_LD, lane);
        if (d == ND - 1) finish_scores(sc, t * AM_K);
      };
      if constexpr (ONE_PASS) {
        // nkt == NT key tiles, each in its own registers
        if (NS == 1 || t == 0)
          slab(s[0]);
        else
          slab(s[NS - 1]);
        if (d == ND - 1 && t == NT - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int tt = 0; tt < NS; ++tt)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                mx = fmaxf(mx, fmaxf(s[tt][j][2 * r], s[tt][j][2 * r + 1]));
            m[r] = quad_max(mx);
            float sum = 0.0f;
#pragma unroll
            for (int tt = 0; tt < NS; ++tt)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                sum += exp2f(s[tt][j][2 * r] - m[r]) + exp2f(s[tt][j][2 * r + 1] - m[r]);
            inv[r] = 1.0f / quad_sum(sum);
          }
#pragma unroll
          for (int tt = 0; tt < NS; ++tt)
#pragma unroll
            for (int ks = 0; ks < AM_K / 16; ++ks) {
              auto p = [&](int j, int e) { return exp2f(s[tt][j][e] - m[e >> 1]) * inv[e >> 1]; };
              pa[tt][ks][0] = pack_bf16(p(2 * ks, 0), p(2 * ks, 1));
              pa[tt][ks][1] = pack_bf16(p(2 * ks, 2), p(2 * ks, 3));
              pa[tt][ks][2] = pack_bf16(p(2 * ks + 1, 0), p(2 * ks + 1, 1));
              pa[tt][ks][3] = pack_bf16(p(2 * ks + 1, 2), p(2 * ks + 1, 3));
            }
        }
      } else {
        slab(s[0]);
        if (d == ND - 1 && i < nkt * ND) {
          // pass 1: per row the running max and this thread's part of the
          // sum rescaled to it; the row's sum is the 4 parts' total
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[0][j][2 * r], s[0][j][2 * r + 1]));
            const float mn = fmaxf(m[r], quad_max(mx));
            if (mn == -INFINITY) continue;  // every key so far masked out
            float part = l[r] * exp2f(m[r] - mn);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              part += exp2f(s[0][j][2 * r] - mn) + exp2f(s[0][j][2 * r + 1] - mn);
            l[r] = part;
            m[r] = mn;
          }
          if (t == nkt - 1) {
            inv[0] = 1.0f / quad_sum(l[0]);
            inv[1] = 1.0f / quad_sum(l[1]);
          }
        } else if (d == ND - 1) {
          store_p(s[0], t * AM_K);  // pass 2
        }
      }
    }
    __syncthreads();  // stage i % 2 is refilled by the next item's fetch
  }

  // o += p v over key tile t of lane chunk c; the chunk's context leaves
  // after its last tile. The warp reads only the rows of p it wrote.
  float o[8][4];
  for (int i = nqk; i < items; ++i) {
    const bf16* st = arrive(i);
    if (live) {
      const int c = (i - nqk) / nkt, t = (i - nqk) % nkt;
      if (t == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
      }
      const int ksn = min(AM_K, pcols - t * AM_K) / 16;
      if constexpr (ONE_PASS) {
        auto tile = [&](const uint32_t (&pt)[AM_K / 16][4]) {
#pragma unroll
          for (int ks = 0; ks < AM_K / 16; ++ks) {
            if (ks >= ksn) break;
            pv_step(o, pt[ks], st + ks * 16 * AWM_LD, lane);
          }
        };
        if (NS == 1 || t == 0)
          tile(pa[0]);
        else
          tile(pa[NS - 1]);
      } else {
#pragma unroll
        for (int ks = 0; ks < AM_K / 16; ++ks) {
          if (ks >= ksn) break;
          uint32_t pf[4];
          ldmatrix_x4(pf, Pw + (lane & 15) * pld + t * AM_K + ks * 16 + (lane >> 4) * 8);
          pv_step(o, pf, st + ks * 16 * AWM_LD, lane);
        }
      }
      if (t == nkt - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = row0 + 8 * r;
          if (qi >= Sq) continue;
          bf16* orow = out + b * o_bs + (long long)qi * o_ss + col + c * AWM_SLAB + 2 * t4;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
                __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
        }
      }
    }
    __syncthreads();
  }
}

template <int HD>
inline cudaError_t attention_mma_wide(const __nv_bfloat16* q, long long q_bs, long long q_ss,
                                      const __nv_bfloat16* k, long long k_bs, long long k_ss,
                                      const __nv_bfloat16* v, long long v_bs, long long v_ss,
                                      __nv_bfloat16* out, long long o_bs, long long o_ss,
                                      const float* mask, const float* key_bias, int B, int Sq,
                                      int Sk, int heads, float scale, cudaStream_t stream) {
  if (!tc_aligned(q, k, v, out, q_bs | q_ss | k_bs | k_ss | v_bs | v_ss | o_bs | o_ss))
    return cudaErrorInvalidValue;
  const size_t smem = attention_mma_wide_smem_bytes(Sk);
  // one pass holding one or two 64-key tiles of scores, else two passes
  const int nkt = (Sk + AM_K - 1) / AM_K;
  auto kernel = nkt == 1   ? attention_mma_wide_kernel<HD, 1>
                : nkt == 2 ? attention_mma_wide_kernel<HD, 2>
                           : attention_mma_wide_kernel<HD, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + AM_Q - 1) / AM_Q;
  kernel<<<dim3((unsigned)(B * ntiles), heads), AM_THREADS, smem, stream>>>(
      q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, Sq, Sk,
      scale);
  return cudaGetLastError();
}

// The short wide-head kernel: one warp per (batch element, head) problem of
// at most 16 queries and keys, blocks grid-striding over the problems as in
// attention_short_kernel. Each warp walks its problem's items, the HD / 64
// Q and K slabs and then the HD / 64 V chunks, through a two-stage ring of
// its own, the next problem's first slab fetched behind this one's last
// chunk. The scores and p stay in registers (one m16 tile, two n8 tiles);
// the epilogue is attention_short_kernel's (natural base).
template <int HD>
__global__ void __launch_bounds__(AS_WARPS * 32)
attention_wide_short_kernel(const __nv_bfloat16* __restrict__ q, long long q_bs, long long q_ss,
                            const __nv_bfloat16* __restrict__ k, long long k_bs, long long k_ss,
                            const __nv_bfloat16* __restrict__ v, long long v_bs, long long v_ss,
                            __nv_bfloat16* __restrict__ out, long long o_bs, long long o_ss,
                            const float* __restrict__ mask, const float* __restrict__ key_bias,
                            int problems, int heads, int Sq, int Sk, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int ND = HD / AWM_SLAB, ITEMS = 2 * ND, STAGE = 2 * AS_ROWS * AWM_LD;
  static_assert(ATT_SHORT_MAX == AS_ROWS && HD % AWM_SLAB == 0,
                "one m16 tile of queries, two n8 tiles of keys");
  extern __shared__ __align__(16) unsigned char aws_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  bf16* const ring = reinterpret_cast<bf16*>(aws_smem) + (size_t)warp * AWM_STAGES * STAGE;
  const int stride = gridDim.x * AS_WARPS;

  // item it of problem pr into stage st: the Q and K slab it (it < ND), else
  // the V chunk it - ND
  auto fetch = [&](int pr, int it, int st) {
    const long long b = pr / heads, col = (long long)(pr % heads) * HD;
    bf16* dst = ring + st * STAGE;
    if (it < ND) {
      load_slab<AS_ROWS, 32>(dst, q + b * q_bs + col, q_ss, 0, Sq, it * AWM_SLAB, lane);
      load_slab<AS_ROWS, 32>(dst + AS_ROWS * AWM_LD, k + b * k_bs + col, k_ss, 0, Sk,
                             it * AWM_SLAB, lane);
    } else {
      load_slab<AS_ROWS, 32>(dst, v + b * v_bs + col, v_ss, 0, Sk, (it - ND) * AWM_SLAB, lane);
    }
  };

  int pr = blockIdx.x * AS_WARPS + warp, it = 0;
  if (pr < problems) fetch(pr, 0, 0);
  cp_async_commit();
  float s[2][4];
  uint32_t pa[4];
  for (int n = 0; pr < problems; ++n) {
    const int npr = it + 1 < ITEMS ? pr : pr + stride, nit = it + 1 < ITEMS ? it + 1 : 0;
    if (npr < problems) fetch(npr, nit, (n + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this item's group has landed
    __syncwarp();
    const bf16* st = ring + (n & 1) * STAGE;
    const long long b = pr / heads, col = (long long)(pr % heads) * HD;
    if (it < ND) {
      if (it == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      }
      qk_slab<2>(s, st, st + AS_ROWS * AWM_LD, lane);
      if (it == ND - 1) {
        const float* kb = key_bias ? key_bias + b * Sk : nullptr;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = g + 8 * (e >> 1), kj = 8 * j + 2 * t4 + (e & 1);
            float x = s[j][e] * scale;
            if (kj >= Sk) {
              x = -INFINITY;
            } else {
              if (mask && qi < Sq) x += mask[(long long)qi * Sk + kj];
              if (kb) x += kb[kj];
            }
            s[j][e] = x;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx = quad_max(
              fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]), fmaxf(s[1][2 * r], s[1][2 * r + 1])));
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              s[j][e] = expf(s[j][e] - mx);
              sum += s[j][e];
            }
          const float inv = 1.0f / quad_sum(sum);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[j][2 * r] *= inv;
            s[j][2 * r + 1] *= inv;
          }
        }
        // p rounded to bf16 as its C fragments become the A operand of p·v
        pa[0] = pack_bf16(s[0][0], s[0][1]);
        pa[1] = pack_bf16(s[0][2], s[0][3]);
        pa[2] = pack_bf16(s[1][0], s[1][1]);
        pa[3] = pack_bf16(s[1][2], s[1][3]);
      }
    } else {
      float o[8][4] = {};
      pv_step(o, pa, st, lane);
      bf16* const oc = out + b * o_bs + col + (it - ND) * AWM_SLAB + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = g + 8 * r;
        if (qi >= Sq) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(oc + (long long)qi * o_ss + 8 * c) =
              __floats2bfloat162_rn(o[c][2 * r], o[c][2 * r + 1]);
      }
    }
    __syncwarp();  // the next iteration's fetch refills the other stage; this
                   // one is refilled only after it
    pr = npr;
    it = nit;
  }
}

template <int HD>
inline cudaError_t attention_wide_short(const __nv_bfloat16* q, long long q_bs, long long q_ss,
                                        const __nv_bfloat16* k, long long k_bs, long long k_ss,
                                        const __nv_bfloat16* v, long long v_bs, long long v_ss,
                                        __nv_bfloat16* out, long long o_bs, long long o_ss,
                                        const float* mask, const float* key_bias, int B, int Sq,
                                        int Sk, int heads, float scale, cudaStream_t stream) {
  if (!tc_aligned(q, k, v, out, q_bs | q_ss | k_bs | k_ss | v_bs | v_ss | o_bs | o_ss))
    return cudaErrorInvalidValue;
  constexpr size_t smem = attention_wide_short_smem_bytes();
  auto kernel = attention_wide_short_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long problems = (long long)B * heads;
  if (problems > INT_MAX) return cudaErrorInvalidValue;
  const int blocks = warp_problem_blocks<attention_wide_short_kernel<HD>>(smem, problems);
  kernel<<<blocks, AS_WARPS * 32, smem, stream>>>(q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss,
                                                  out, o_bs, o_ss, mask, key_bias,
                                                  (int)problems, heads, Sq, Sk, scale);
  return cudaGetLastError();
}

// Which kernel qt::attention launches, with the shared memory it asks for.
// The tensor-core routes come first (attention_route): a keep-masked call
// at head size 32, 64 or 128 over at most ATT_KEEP_MAX_SK keys takes the
// keep-masked kernel (bf16 and fp32) where its shared memory fits, and so,
// with the keep multiply compiled out ("mma_nokeep"), does an fp32 call
// without a keep mask at those head sizes and keys (a mask and a key bias
// included), and a bf16 call without a keep mask, a mask or a key bias
// that has fewer than 16 queries over more than 16 keys (the bf16 calls no
// other tensor-core kernel takes); an fp32 call without a keep mask at
// those head sizes past ATT_KEEP_MAX_SK keys takes the key-tiled form
// ("mma_nokeep_tiled") and one at head size 256 or 512 without a mask or a
// key bias the lane split ("lane_split"), each where its shared memory
// fits; a bf16 call that the mma kernel takes at head size 64 with at
// least ATT_SM90_MIN_SK keys takes the Hopper kernel ("mma_sm90", route
// "wgmma") where its shared memory fits and sm90_faster holds (the measured
// rule), the one-pass form up to 128 keys stays; head sizes 32 and 128 keep
// the two-pass form, which the Hopper kernel is not built for; a wide
// head whose probabilities pass the limit in the mma kernel (far past 577
// keys) falls to the FMA kernels, and a bf16 head between 128 and 512 lanes
// that no tensor-core kernel is built for has none (the wrapper pads it).
// An FMA call (fp32 or a keep mask the keep-masked kernel does not take)
// takes the staged kernel up to ATT_STAGED_MAX_SK keys when its Sk-sized
// shared memory fits the device's opt-in limit per block, else the tiled
// kernel (head sizes 32, 64, 128) or the wide-head one (256, 512), each if
// its fixed shared memory fits. Any other call has no kernel
// (ATT_KERNEL_NONE) and returns cudaErrorInvalidValue; ops/attention.py
// plans the same rule in Python (attention_plan) and zero-pads a head to the
// next size that has one.
enum AttentionKernel {
  ATT_KERNEL_NONE = -1,
  ATT_KERNEL_STAGED = 0,
  ATT_KERNEL_TILED = 1,
  ATT_KERNEL_WIDE = 2,
  ATT_KERNEL_MMA = 3,
  ATT_KERNEL_SHORT = 4,
  ATT_KERNEL_MMA_WIDE = 5,
  ATT_KERNEL_WIDE_SHORT = 6,
  ATT_KERNEL_MMA_KEEP = 7,
  ATT_KERNEL_MMA_NOKEEP = 8,
  ATT_KERNEL_MMA_NOKEEP_TILED = 9,
  ATT_KERNEL_LANES = 10,
  ATT_KERNEL_MMA_SM90 = 11,
};

inline AttentionKernel attention_plan(bool bf16, int Sq, int Sk, int hd, bool has_keep,
                                      bool has_bias, size_t limit, size_t* smem) {
  AttentionRoute route = attention_route(bf16, Sq, Sk, hd, has_keep, has_bias);
  size_t bytes = 0;
  AttentionKernel kernel = ATT_KERNEL_NONE;
  if (route == ATT_ROUTE_MMA_KEEP || route == ATT_ROUTE_MMA_NOKEEP) {
    // past ATT_KEEP_MAX_SK keys only fp32 without a keep mask has this route
    const bool tiled = Sk > ATT_KEEP_MAX_SK;
    bytes = tiled ? attention_nokeep_tiled_smem_bytes(hd)
                  : attention_keep_smem_bytes(bf16 ? 2 : 4, Sq, Sk, hd, has_keep);
    if (bytes <= limit) {
      if (smem) *smem = bytes;
      return route == ATT_ROUTE_MMA_KEEP ? ATT_KERNEL_MMA_KEEP
             : tiled                     ? ATT_KERNEL_MMA_NOKEEP_TILED
                                         : ATT_KERNEL_MMA_NOKEEP;
    }
    route = ATT_ROUTE_FMA;
    bytes = 0;
  }
  if (route == ATT_ROUTE_TF32X3) {
    if (ATT_LANES_SMEM <= limit) {
      if (smem) *smem = ATT_LANES_SMEM;
      return ATT_KERNEL_LANES;
    }
    route = ATT_ROUTE_FMA;
  }
  if (route != ATT_ROUTE_FMA) {
    const bool shrt = route == ATT_ROUTE_MMA_SHORT;
    if (wide_head(hd)) {
      kernel = shrt ? ATT_KERNEL_WIDE_SHORT : ATT_KERNEL_MMA_WIDE;
      bytes = shrt ? attention_wide_short_smem_bytes() : attention_mma_wide_smem_bytes(Sk);
    } else {
      kernel = shrt ? ATT_KERNEL_SHORT : ATT_KERNEL_MMA;
      switch (hd) {
        case 32: bytes = shrt ? attention_short_smem_bytes<32>() : attention_mma_smem_bytes<32>(); break;
        case 64: bytes = shrt ? attention_short_smem_bytes<64>() : attention_mma_smem_bytes<64>(); break;
        default: bytes = shrt ? attention_short_smem_bytes<128>() : attention_mma_smem_bytes<128>();
      }
      // past 128 keys at head size 64: the Hopper kernel (head sizes 32 and
      // 128 keep attention_mma_kernel's two-pass form)
      const int mode = attention_sm90_mode();
      if (kernel == ATT_KERNEL_MMA && hd == 64 && Sk >= ATT_SM90_MIN_SK && AS9_SMEM <= limit &&
          mode != ATT_SM90_OFF && (mode == ATT_SM90_ALWAYS || sm90_faster(Sk))) {
        kernel = ATT_KERNEL_MMA_SM90;
        bytes = AS9_SMEM;
      }
    }
  }
  const bool to_fma = route == ATT_ROUTE_FMA || (wide_head(hd) && bytes > limit);
  if (to_fma && bf16 && !has_keep && hd > 128 && hd < 512 && !wide_head(hd)) {
    kernel = ATT_KERNEL_NONE;
    bytes = 0;
  } else if (to_fma && Sk <= ATT_STAGED_MAX_SK && attention_smem_bytes(Sk, hd) <= limit) {
    kernel = ATT_KERNEL_STAGED;
    bytes = attention_smem_bytes(Sk, hd);
  } else if (to_fma) {
    kernel = ATT_KERNEL_NONE;
    bytes = 0;
    switch (hd) {
      case 32: kernel = ATT_KERNEL_TILED; bytes = attention_tiled_smem_bytes<32>(); break;
      case 64: kernel = ATT_KERNEL_TILED; bytes = attention_tiled_smem_bytes<64>(); break;
      case 128: kernel = ATT_KERNEL_TILED; bytes = attention_tiled_smem_bytes<128>(); break;
      case 256: kernel = ATT_KERNEL_WIDE; bytes = attention_wide_smem_bytes<256>(); break;
      case 512: kernel = ATT_KERNEL_WIDE; bytes = attention_wide_smem_bytes<512>(); break;
      default: break;
    }
  }
  if (bytes > limit) kernel = ATT_KERNEL_NONE;
  if (smem) *smem = bytes;
  return kernel;
}

// The route of a planned kernel: what qt_attention_route reports
inline AttentionRoute attention_kernel_route(AttentionKernel kernel) {
  switch (kernel) {
    case ATT_KERNEL_MMA:
    case ATT_KERNEL_MMA_WIDE: return ATT_ROUTE_MMA;
    case ATT_KERNEL_SHORT:
    case ATT_KERNEL_WIDE_SHORT: return ATT_ROUTE_MMA_SHORT;
    case ATT_KERNEL_MMA_KEEP: return ATT_ROUTE_MMA_KEEP;
    case ATT_KERNEL_MMA_NOKEEP:
    case ATT_KERNEL_MMA_NOKEEP_TILED: return ATT_ROUTE_MMA_NOKEEP;
    case ATT_KERNEL_LANES: return ATT_ROUTE_TF32X3;
    case ATT_KERNEL_MMA_SM90: return ATT_ROUTE_WGMMA;
    default: return ATT_ROUTE_FMA;
  }
}

// The current device's opt-in shared memory per block (232,448 bytes on an
// H100), read once per device.
inline size_t smem_optin() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)cached[dev];
}

template <typename T>
inline cudaError_t attention(const T* q, long long q_bs, long long q_ss, const T* k,
                             long long k_bs, long long k_ss, const T* v, long long v_bs,
                             long long v_ss, T* out, long long o_bs, long long o_ss,
                             const float* mask, int B, int Sq, int Sk, int heads, int hd,
                             float scale, cudaStream_t stream, const T* keep = nullptr,
                             long long keep_ld = 0, bool round_p_first = false,
                             const float* key_bias = nullptr, int* kernel_out = nullptr,
                             float* scratch = nullptr) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  size_t smem = 0;
  const AttentionKernel kernel = attention_plan(kBf16, Sq, Sk, hd, keep != nullptr,
                                                mask || key_bias, smem_optin(), &smem);
  if (kernel_out) *kernel_out = kernel;  // the plans' attention rows (GemmPlan::attention)
  if (kernel == ATT_KERNEL_MMA_KEEP || kernel == ATT_KERNEL_MMA_NOKEEP) {
    // the plan sends a mask or a key bias here only in fp32 without a keep
    // mask; no caller adds them to a keep mask
    if ((mask || key_bias) && (kBf16 || keep)) return cudaErrorInvalidValue;
    return attention_keep_fwd(kBf16, {q, q_bs, q_ss}, {k, k_bs, k_ss}, {v, v_bs, v_ss},
                              {out, o_bs, o_ss}, keep, keep_ld, B, Sq, Sk, heads, hd, scale,
                              round_p_first, stream, mask, key_bias);
  }
  if constexpr (!kBf16) {
    if (kernel == ATT_KERNEL_MMA_NOKEEP_TILED)
      return attention_nokeep_tiled({q, q_bs, q_ss}, {k, k_bs, k_ss}, {v, v_bs, v_ss},
                                    {out, o_bs, o_ss}, mask, key_bias, B, Sq, Sk, heads, hd,
                                    scale, stream);
    // the plan sends no mask or key bias to the lane split, and only
    // attention_wide's and fused_attention's entries give it the scratch
    if (kernel == ATT_KERNEL_LANES) {
      if (mask || key_bias) return cudaErrorInvalidValue;
      return attention_lanes({q, q_bs, q_ss}, {k, k_bs, k_ss}, {v, v_bs, v_ss},
                             {out, o_bs, o_ss}, B, Sq, Sk, heads, hd, scale, scratch, stream);
    }
  }
  if constexpr (kBf16) {
#define QT_TC(KERNEL, HD)                                                                   \
  KERNEL<HD>(q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, \
             B, Sq, Sk, heads, scale, stream)
    if (kernel == ATT_KERNEL_SHORT) {
      switch (hd) {
        case 32: return QT_TC(attention_short, 32);
        case 64: return QT_TC(attention_short, 64);
        default: return QT_TC(attention_short, 128);
      }
    }
    if (kernel == ATT_KERNEL_MMA_SM90)
      return attention_sm90(q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask,
                            key_bias, B, Sq, Sk, heads, hd, scale, stream);
    if (kernel == ATT_KERNEL_MMA) {
      switch (hd) {
        case 32: return QT_TC(attention_mma, 32);
        case 64: return QT_TC(attention_mma, 64);
        default: return QT_TC(attention_mma, 128);
      }
    }
    if (kernel == ATT_KERNEL_MMA_WIDE)
      return hd == 256 ? QT_TC(attention_mma_wide, 256) : QT_TC(attention_mma_wide, 512);
    if (kernel == ATT_KERNEL_WIDE_SHORT)
      return hd == 256 ? QT_TC(attention_wide_short, 256) : QT_TC(attention_wide_short, 512);
#undef QT_TC
  }
#define QT_FMA(KERNEL, HD)                                                                  \
  KERNEL<T, HD>(q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, \
                B, Sq, Sk, heads, scale, stream, keep, keep_ld, round_p_first)
  if (kernel == ATT_KERNEL_TILED) {
    switch (hd) {
      case 32: return QT_FMA(attention_tiled, 32);
      case 64: return QT_FMA(attention_tiled, 64);
      default: return QT_FMA(attention_tiled, 128);
    }
  }
  if (kernel == ATT_KERNEL_WIDE) {
    return hd == 256 ? QT_FMA(attention_wide_head, 256) : QT_FMA(attention_wide_head, 512);
  }
#undef QT_FMA
  if (kernel != ATT_KERNEL_STAGED) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + ATT_QROWS - 1) / ATT_QROWS;
  const dim3 grid((unsigned)(B * ntiles), heads);
  attention_kernel<T><<<grid, ATT_WARPS * 32, smem, stream>>>(
      q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, Sq, Sk, hd,
      scale, keep, keep_ld, round_p_first);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward of the keep-masked attention: given g = dL/dctx, writes
// dL/dq, dL/dk, dL/dv (in T, strided like the forward's operands). One block
// per (batch element, head) owns all of that head's queries and keys, so
// dk and dv are complete inside the block: no atomics, no second pass. The
// probabilities are recomputed from q and k with the forward's arithmetic
// (scores, max, exp, sum in the same order), then, as the Pallas backward
// bodies do:
//   dPd = g v^T;  dP = dPd * keep;  dS = round_T(P (dP - rowsum(dP P)))
//   dq = round_T(scale dS k);  dk = round_T(scale dS^T q);  dv = round_T(Pd^T g)
// with P the fp32 probability (AVQ) or its T rounding (PatchSelecter), as
// round_p_first says. accumulate_kv adds dk and dv to what the outputs hold:
// out = round_T(out + round_T(new)), the PatchSelecter's sum of its two
// query streams' key/value gradients.
//
// attention_bwd_plan picks the kernel: the keep-masked tensor-core backward
// (attention_keep.cu, ATT_KERNEL_MMA_KEEP) for a keep mask at head size 32,
// 64 or 128 over at most ATT_KEEP_MAX_SK keys where its shared memory fits
// (it grows with Sq); else attention_bwd_kernel below (ATT_KERNEL_STAGED:
// FMAs, the whole head staged in fp32) where its shared memory fits; else
// none. ops/attention.py plans the same rule (attention_bwd_plan).
// ---------------------------------------------------------------------------
inline size_t attention_bwd_smem_bytes(int Sq, int Sk, int hd) {
  return sizeof(float) * ((size_t)(2 * Sq + 2 * Sk) * (hd + 1) + 2 * (size_t)Sq * Sk
                          + ATT_WARPS * (size_t)Sk);
}

inline AttentionKernel attention_bwd_plan(bool bf16, int Sq, int Sk, int hd, bool has_keep,
                                          size_t limit, size_t* smem) {
  size_t bytes = 0;
  AttentionKernel kernel = ATT_KERNEL_NONE;
  if (has_keep && keep_head(hd) && Sk >= 1 && Sk <= ATT_KEEP_MAX_SK)
    bytes = attention_keep_bwd_smem_bytes(bf16 ? 2 : 4, Sq, Sk, hd);
  if (bytes && bytes <= limit) {
    kernel = ATT_KERNEL_MMA_KEEP;
  } else {
    bytes = attention_bwd_smem_bytes(Sq, Sk, hd);
    kernel = bytes <= limit ? ATT_KERNEL_STAGED : ATT_KERNEL_NONE;
  }
  if (smem) *smem = bytes;
  return kernel;
}

template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_bwd_kernel(const T* __restrict__ q, long long q_bs, long long q_ss,
                     const T* __restrict__ k, long long k_bs, long long k_ss,
                     const T* __restrict__ v, long long v_bs, long long v_ss,
                     const T* __restrict__ g, long long g_bs, long long g_ss,
                     T* gq, long long gq_bs, long long gq_ss,
                     T* gk, long long gk_bs, long long gk_ss,
                     T* gv, long long gv_bs, long long gv_ss,
                     const T* __restrict__ keep, long long keep_ld, int Sq, int Sk, int hd,
                     float scale, bool round_p_first, bool accumulate_kv) {
  extern __shared__ float smem[];
  const int L = hd + 1;
  float* Qs = smem;                       // [Sq][L]
  float* Gs = Qs + (size_t)Sq * L;        // [Sq][L]
  float* Ks = Gs + (size_t)Sq * L;        // [Sk][L]
  float* Vs = Ks + (size_t)Sk * L;        // [Sk][L]
  float* Ps = Vs + (size_t)Sk * L;        // [Sq][Sk]: P, then dS
  float* Pd = Ps + (size_t)Sq * Sk;       // [Sq][Sk]: the dropped, rounded probabilities
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row = Pd + (size_t)Sq * Sk + (size_t)warp * Sk;  // per-warp scratch [Sk]
  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  const long long col = (long long)h * hd;

  for (int i = threadIdx.x; i < Sq * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    Qs[r * L + d] = to_f<T>(q[b * q_bs + r * q_ss + col + d]);
    Gs[r * L + d] = to_f<T>(g[b * g_bs + r * g_ss + col + d]);
  }
  for (int i = threadIdx.x; i < Sk * hd; i += blockDim.x) {
    const int j = i / hd, d = i % hd;
    Ks[j * L + d] = to_f<T>(k[b * k_bs + j * k_ss + col + d]);
    Vs[j * L + d] = to_f<T>(v[b * v_bs + j * v_ss + col + d]);
  }
  __syncthreads();

  for (int i = warp; i < Sq; i += ATT_WARPS) {
    const T* kr = keep ? keep + (b * Sq + i) * keep_ld + (long long)h * Sk : nullptr;
    float mx = -INFINITY;
    for (int j = lane; j < Sk; j += 32) {
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(Qs[i * L + d], Ks[j * L + d], s);
      s *= scale;
      row[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < Sk; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    float dot = 0.0f;
    for (int j = lane; j < Sk; j += 32) {
      const float p = row[j] * inv;
      const float pr = (kr && round_p_first) ? round_t<T>(p) : p;
      Pd[i * Sk + j] = dropped_prob<T>(p, kr, j, round_p_first);
      float dp = 0.0f;
      for (int d = 0; d < hd; ++d) dp = fmaf(Gs[i * L + d], Vs[j * L + d], dp);
      if (kr) dp *= to_f<T>(kr[j]);
      row[j] = dp;
      Ps[i * Sk + j] = pr;
      dot = fmaf(dp, pr, dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < Sk; j += 32)
      Ps[i * Sk + j] = round_t<T>(Ps[i * Sk + j] * (row[j] - dot));
    __syncwarp();
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Sq * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    float acc = 0.0f;
    for (int j = 0; j < Sk; ++j) acc = fmaf(Ps[r * Sk + j], Ks[j * L + d], acc);
    gq[b * gq_bs + r * gq_ss + col + d] = from_f<T>(acc * scale);
  }
  for (int i = threadIdx.x; i < Sk * hd; i += blockDim.x) {
    const int j = i / hd, d = i % hd;
    float ak = 0.0f, av = 0.0f;
    for (int r = 0; r < Sq; ++r) {
      ak = fmaf(Ps[r * Sk + j], Qs[r * L + d], ak);
      av = fmaf(Pd[r * Sk + j], Gs[r * L + d], av);
    }
    float nk = round_t<T>(ak * scale), nv = round_t<T>(av);
    T* pk = gk + b * gk_bs + j * gk_ss + col + d;
    T* pv = gv + b * gv_bs + j * gv_ss + col + d;
    if (accumulate_kv) {
      nk += to_f<T>(*pk);
      nv += to_f<T>(*pv);
    }
    *pk = from_f<T>(nk);
    *pv = from_f<T>(nv);
  }
}

// q/k/v/g and gq/gk/gv as (pointer, batch stride, row stride).
template <typename T> struct Strided {
  T* p;
  long long bs, ss;
};

template <typename T>
inline cudaError_t attention_bwd(Strided<const T> q, Strided<const T> k, Strided<const T> v,
                                 Strided<const T> g, Strided<T> gq, Strided<T> gk, Strided<T> gv,
                                 const T* keep, long long keep_ld, int B, int Sq, int Sk,
                                 int heads, int hd, float scale, bool round_p_first,
                                 bool accumulate_kv, cudaStream_t stream,
                                 int* kernel_out = nullptr) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  size_t smem = 0;
  const AttentionKernel kernel =
      attention_bwd_plan(kBf16, Sq, Sk, hd, keep != nullptr, smem_optin(), &smem);
  if (kernel_out) *kernel_out = kernel;  // the train kernels' plans (GemmPlan::attention)
  if (kernel == ATT_KERNEL_MMA_KEEP)
    return attention_keep_bwd(kBf16, {q.p, q.bs, q.ss}, {k.p, k.bs, k.ss}, {v.p, v.bs, v.ss},
                              {g.p, g.bs, g.ss}, {gq.p, gq.bs, gq.ss}, {gk.p, gk.bs, gk.ss},
                              {gv.p, gv.bs, gv.ss}, keep, keep_ld, B, Sq, Sk, heads, hd, scale,
                              round_p_first, accumulate_kv, stream);
  if (kernel != ATT_KERNEL_STAGED) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<T><<<dim3((unsigned)B, heads), ATT_WARPS * 32, smem, stream>>>(
      q.p, q.bs, q.ss, k.p, k.bs, k.ss, v.p, v.bs, v.ss, g.p, g.bs, g.ss, gq.p, gq.bs, gq.ss,
      gk.p, gk.bs, gk.ss, gv.p, gv.bs, gv.ss, keep, keep_ld, Sq, Sk, hd, scale, round_p_first,
      accumulate_kv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row LayerNorm (eps 1e-5, fp32 statistics), one warp per row.
// ---------------------------------------------------------------------------
constexpr int LN_WARPS = 8;

template <typename TI>
__device__ __forceinline__ void row_moments(const TI* x, int D, int lane, float& mean, float& rstd) {
  float s = 0.0f;
  for (int i = lane; i < D; i += 32) s += to_f<TI>(x[i]);
  mean = warp_sum(s) / D;
  float q = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const float c = to_f<TI>(x[i]) - mean;
    q = fmaf(c, c, q);
  }
  rstd = rsqrtf(warp_sum(q) / D + 1e-5f);
}

template <typename T>
__global__ void row_stats_kernel(const T* __restrict__ x, long long ldx, int rows, int D,
                                 float* __restrict__ mean, float* __restrict__ rstd) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mu, rs;
  row_moments<T>(x + (long long)row * ldx, D, lane, mu, rs);
  if (lane == 0) { mean[row] = mu; rstd[row] = rs; }
}

// out row r = LayerNorm(in row r) with parameter set r % nsets written to
// outs[r % nsets] row r / nsets: nsets = 2 splits rows that alternate
// between two streams (video, audio) into two outputs.
template <typename TI, typename T>
__global__ void layer_norm_kernel(const TI* __restrict__ in, int rows, int D, int nsets,
                                  const T* w0, const T* b0, T* out0,
                                  const T* w1, const T* b1, T* out1) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const TI* x = in + (long long)row * D;
  float mu, rs;
  row_moments<TI>(x, D, lane, mu, rs);
  const int set = row % nsets;
  const T* w = set ? w1 : w0;
  const T* b = set ? b1 : b0;
  T* o = (set ? out1 : out0) + (long long)(row / nsets) * D;
  for (int i = lane; i < D; i += 32)
    o[i] = from_f<T>((to_f<TI>(x[i]) - mu) * rs * to_f<T>(w[i]) + to_f<T>(b[i]));
}

inline unsigned ln_blocks(int rows) { return (unsigned)((rows + LN_WARPS - 1) / LN_WARPS); }

// The epilogue of a row-parallel product under tensor parallelism, after its
// fp32 partial sums [rows, D] were summed over the model ranks: the value the
// single-rank GEMM's epilogue writes, with the reduced sum in place of its
// accumulator, so the value is rounded once, where the single-rank kernel
// rounds it:
//   res given:          out = res + round_T(sum + bias)   (EpiResidual)
//   res null, TO = T:   out = round_T(sum + bias)         (EpiBias, no act)
//   res null, TO float: out = sum + bias                  (EpiF32)
// bias may be null; out may alias sum. With ln_w given, also h =
// LayerNorm(out row) * ln_w + ln_b, layer_norm_kernel's arithmetic on the
// stored row (each lane reads back only the elements it wrote). One warp
// per row.
template <typename T, typename TO>
__global__ void reduce_epilogue_kernel(const float* sum, int rows, int D, const T* bias,
                                       const T* res, TO* out, const T* ln_w, const T* ln_b,
                                       T* h) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long off = (long long)row * D;
  for (int i = lane; i < D; i += 32) {
    const float s = sum[off + i];
    const float v = bias ? s + to_f<T>(bias[i]) : s;
    out[off + i] = res ? from_f<TO>(to_f<T>(res[off + i]) + round_t<T>(v)) : from_f<TO>(v);
  }
  if (!ln_w) return;
  __syncwarp();
  float mu, rs;
  row_moments<TO>(out + off, D, lane, mu, rs);
  for (int i = lane; i < D; i += 32)
    h[off + i] =
        from_f<T>((to_f<TO>(out[off + i]) - mu) * rs * to_f<T>(ln_w[i]) + to_f<T>(ln_b[i]));
}

// Backward of LayerNorm(x) * w + b over rows of width D, one warp per row,
// given the upstream g (the Pallas kernels' _ln_bwd):
//   gx = rstd (g w - mean(g w) - xhat mean(g w xhat))      (fp32)
// It also writes the row's mean and 1/std (for the w and b gradients, which
// col_sum forms) and, for each non-null (mask_i, out_i), out_i =
// round_T(gx * mask_i): the dropout sites that feed the normalised sum.
// gx may alias g.
template <typename T, typename TX, typename TG>
__global__ void layer_norm_bwd_kernel(const TX* __restrict__ x, const T* __restrict__ w,
                                      const TG* g, int rows, int D, float* gx,
                                      float* __restrict__ mean, float* __restrict__ rstd,
                                      const T* m0, T* o0, const T* m1, T* o1, const T* m2, T* o2) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = (long long)row * D;
  float mu, rs;
  row_moments<TX>(x + base, D, lane, mu, rs);
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const float gxh = to_f<TG>(g[base + i]) * to_f<T>(w[i]);
    s1 += gxh;
    s2 = fmaf(gxh, (to_f<TX>(x[base + i]) - mu) * rs, s2);
  }
  s1 = warp_sum(s1) / D;
  s2 = warp_sum(s2) / D;
  for (int i = lane; i < D; i += 32) {
    const float xh = (to_f<TX>(x[base + i]) - mu) * rs;
    const float v = rs * (to_f<TG>(g[base + i]) * to_f<T>(w[i]) - s1 - xh * s2);
    gx[base + i] = v;
    if (o0) o0[base + i] = from_f<T>(v * to_f<T>(m0[base + i]));
    if (o1) o1[base + i] = from_f<T>(v * to_f<T>(m1[base + i]));
    if (o2) o2[base + i] = from_f<T>(v * to_f<T>(m2[base + i]));
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// ---------------------------------------------------------------------------
// Column sums out[n] (= or +=) sum_m f(m, n) over M rows: bias and
// LayerNorm-parameter gradients. A block owns 32 columns; its 32 x 32
// threads stride the rows, then one row of threads adds the 32 partial sums
// in a fixed order. Deterministic, no atomics.
// ---------------------------------------------------------------------------
template <class F>
__global__ void col_sum_kernel(F f, int M, int N, float* out, bool accumulate) {
  __shared__ float part[32][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (n < N)
    for (int m = threadIdx.y; m < M; m += 32) s += f(m, n);
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float t = 0.0f;
    for (int r = 0; r < 32; ++r) t += part[r][threadIdx.x];
    out[n] = accumulate ? out[n] + t : t;
  }
}

template <class F>
inline void col_sum(const F& f, int M, int N, float* out, bool accumulate, cudaStream_t stream) {
  col_sum_kernel<F><<<(unsigned)((N + 31) / 32), dim3(32, 32), 0, stream>>>(f, M, N, out,
                                                                            accumulate);
}

template <typename TA> struct Val {  // f(m, n) = a[m * ld + n]
  const TA* a;
  long long ld;
  __device__ float operator()(int m, int n) const { return to_f<TA>(a[(long long)m * ld + n]); }
};

template <typename TX, typename TG> struct LnWeightTerm {  // f(m, n) = g * xhat
  const TX* x;
  const TG* g;
  const float* mean;
  const float* rstd;
  long long ld;
  __device__ float operator()(int m, int n) const {
    const long long i = (long long)m * ld + n;
    return to_f<TG>(g[i]) * ((to_f<TX>(x[i]) - mean[m]) * rstd[m]);
  }
};

}  // namespace
}  // namespace qt
