// The fp32 tensor-core GEMM under every planned fp32 product
// (gemm_tf32x3.cuh: 3xTF32 on TMA + wgmma) by itself, for its checks and
// timing (ops/gemm.py gemm_tf32x3). No model path calls qt_gemm_tf32x3.
#include "gemm_tf32x3.cuh"

namespace {

template <bool A_COL>
int run(const float* a, long long lda, const float* b, long long ldb, int b_nk,
        const qt::EpiStoreF32& epi, int M, int N, int K, int chunk, float* ws,
        long long ws_floats, cudaStream_t st) {
  if (b_nk)
    return qt::gemm_tf32x3<A_COL, true>(a, lda, b, ldb, M, N, K, epi, chunk, ws, ws_floats, st);
  return qt::gemm_tf32x3<A_COL, false>(a, lda, b, ldb, M, N, K, epi, chunk, ws, ws_floats, st);
}

}  // namespace

// out [M, N] fp32 (row stride ldo) = A B: A(m, k) at a[m * lda + k], or at
// a[k * lda + m] with a_col; B(k, n) at b[n * ldb + k] with b_nk, else at
// b[k * ldb + n]; K cut into chunks of `chunk` rows, whose partials go to
// ws (room for ws_floats floats)
extern "C" int qt_gemm_tf32x3(const void* a, long long lda, int a_col, const void* b,
                              long long ldb, int b_nk, void* out, long long ldo, int M, int N,
                              int K, int chunk, void* ws, long long ws_floats, void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const qt::EpiStoreF32 epi{static_cast<float*>(out), ldo, false};
  float* W = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_col) return run<true>(A, lda, B, ldb, b_nk, epi, M, N, K, chunk, W, ws_floats, st);
  return run<false>(A, lda, B, ldb, b_nk, epi, M, N, K, chunk, W, ws_floats, st);
}
