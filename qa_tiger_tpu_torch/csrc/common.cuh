// Device code shared by the kernels of this package: type conversion, warp
// reductions, a block-level tiled GEMM with a pluggable A loader, the
// multi-head attention kernel and the row LayerNorm kernels.
//
// Conventions: activations and parameters arrive in one type T (float or
// __nv_bfloat16); every sum is taken in fp32; a value is rounded to T where
// the JAX package rounds it (round_t), so the bf16 kernels and their plain
// PyTorch versions agree to bf16 rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

// Everything has internal linkage (an unnamed namespace), so each source that
// includes this header owns its instantiations and no two objects share a
// kernel symbol at link time.
namespace qt {
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
        const int m = i / BK, k = i % BK;
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
        const int m = i / BK, k = i % BK;
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

// Epilogues ---------------------------------------------------------------
template <typename T> struct EpiBias {  // out = round_T(act(acc + bias))
  T* out;
  long long ldo;
  const T* bias;
  bool relu;
  __device__ void operator()(int m, int n, float acc) const {
    float v = acc + to_f<T>(bias[n]);
    if (relu) v = fmaxf(v, 0.0f);
    out[(long long)m * ldo + n] = from_f<T>(v);
  }
};

template <typename T> struct EpiResidual {  // out = res + round_T(acc + bias)
  T* out;
  long long ldo;
  const T* bias;
  const T* res;
  long long ldr;
  __device__ void operator()(int m, int n, float acc) const {
    const float v = round_t<T>(acc + to_f<T>(bias[n]));
    out[(long long)m * ldo + n] = from_f<T>(to_f<T>(res[(long long)m * ldr + n]) + v);
  }
};

template <typename T> struct EpiF32 {  // out (fp32) = acc + bias
  float* out;
  long long ldo;
  const T* bias;
  __device__ void operator()(int m, int n, float acc) const {
    out[(long long)m * ldo + n] = acc + to_f<T>(bias[n]);
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
// out [B, Sq, H*hd] likewise. One block per (batch element, head, tile of
// ATT_QROWS queries): K_h and V_h are staged in shared memory as fp32, one
// warp per query row computes the scores, an fp32 softmax with max
// subtraction, the probabilities rounded to T (as the JAX kernels cast p to
// v's dtype), and the context. mask is an optional additive fp32 [Sq, Sk].
// ---------------------------------------------------------------------------
constexpr int ATT_WARPS = 4, ATT_QROWS = 32;

inline size_t attention_smem_bytes(int Sk, int hd) {
  return sizeof(float) * ((size_t)Sk * (hd + 1) + (size_t)Sk * hd + ATT_WARPS * (size_t)(hd + Sk));
}

template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const T* __restrict__ q, long long q_bs, long long q_ss,
                 const T* __restrict__ k, long long k_bs, long long k_ss,
                 const T* __restrict__ v, long long v_bs, long long v_ss,
                 T* __restrict__ out, long long o_bs, long long o_ss,
                 const float* __restrict__ mask, int Sq, int Sk, int hd, float scale) {
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
    for (int j = lane; j < Sk; j += 32) ps[j] = round_t<T>(ps[j] * inv);
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < Sk; ++j) acc = fmaf(ps[j], Vs[j * hd + d], acc);
      out[b * o_bs + qi * o_ss + col + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
inline cudaError_t attention(const T* q, long long q_bs, long long q_ss, const T* k,
                             long long k_bs, long long k_ss, const T* v, long long v_bs,
                             long long v_ss, T* out, long long o_bs, long long o_ss,
                             const float* mask, int B, int Sq, int Sk, int heads, int hd,
                             float scale, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(Sk, hd);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + ATT_QROWS - 1) / ATT_QROWS;
  const dim3 grid((unsigned)(B * ntiles), heads);
  attention_kernel<T><<<grid, ATT_WARPS * 32, smem, stream>>>(
      q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, Sq, Sk, hd, scale);
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

}  // namespace
}  // namespace qt
