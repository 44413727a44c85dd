// fused_attn_ln2: y = x + out_proj(causal_attn(ln_1(x))) and h = ln_2(y) for
// one CLIP pre-LN block.
//
// Replaces qa_tiger_tpu/ops/pallas/resblock.py:_attn_ln2_impl
// (_attn_ln2_kernel -> _attn_core).
//
// Bound on the H100: operations. Per text-tower layer at B=256, S=77,
// W=768 the qkv and output projections are 8*B*S*W^2 = 93 GFLOP against
// ~100 MB of x, y, h and weights. Five launches, all written here:
//   1. row statistics of x (fp32 mean and 1/std);
//   2. GEMM against in_proj [3W, W] on bf16 tensor cores whose A load applies
//      ln_1 and rounds to the activation type, plus bias -> qkv;
//   3. the causal attention of attention.cu's device code, reading q, k and
//      v as column slices of qkv -> ctx;
//   4. GEMM against out_proj plus bias plus the residual -> y;
//   5. ln_2 over y -> h.
// The Pallas kernel kept qkv and ctx in VMEM; here they make one round trip
// through HBM each (2 x 3W + 2 x W values per row, ~240 MB per layer at
// B=256 in bf16). At the card's peak rates that traffic would take about as
// long as the projections themselves, so keeping them on chip is the first
// thing a faster version needs; against this version's GEMM time it is small.
#include "common.cuh"

namespace {

template <typename T>
cudaError_t run(const T* x, const T* ln1w, const T* ln1b, const T* wqkv, const T* bqkv,
                const T* wout, const T* bout, const T* ln2w, const T* ln2b, const float* mask,
                T* y, T* h, T* qkv, T* ctx, float* stats, int B, int S, int W, int heads,
                cudaStream_t stream) {
  const int M = B * S, hd = W / heads;
  float* mean = stats;
  float* rstd = stats + M;
  qt::row_stats_kernel<T><<<qt::ln_blocks(M), qt::LN_WARPS * 32, 0, stream>>>(x, W, M, W, mean,
                                                                               rstd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qt::gemm<T, true>(qt::LnRowLoad<T>{x, W, mean, rstd, ln1w, ln1b}, wqkv, W, M, 3 * W, W,
                    qt::EpiBias<T>{qkv, 3LL * W, bqkv, false}, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long bs = 3LL * S * W;
  err = qt::attention<T>(qkv, bs, 3LL * W, qkv + W, bs, 3LL * W, qkv + 2 * W, bs, 3LL * W, ctx,
                         (long long)S * W, W, mask, B, S, S, heads, hd,
                         1.0f / sqrtf((float)hd), stream);
  if (err != cudaSuccess) return err;
  qt::gemm<T, true>(qt::RowLoad<T>{ctx, W}, wout, W, M, W, W,
                    qt::EpiResidual<T>{y, W, bout, x, W}, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qt::layer_norm_kernel<T, T><<<qt::ln_blocks(M), qt::LN_WARPS * 32, 0, stream>>>(
      y, M, W, 1, ln2w, ln2b, h, nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qt_attn_ln2(int dtype, const void* x, const void* ln1w, const void* ln1b,
                           const void* wqkv, const void* bqkv, const void* wout,
                           const void* bout, const void* ln2w, const void* ln2b,
                           const void* mask, void* y, void* h, void* qkv, void* ctx,
                           void* stats, int B, int S, int W, int heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* sp = static_cast<float*>(stats);
#define QT_ARGS(T)                                                                          \
  static_cast<const T*>(x), static_cast<const T*>(ln1w), static_cast<const T*>(ln1b),      \
      static_cast<const T*>(wqkv), static_cast<const T*>(bqkv), static_cast<const T*>(wout), \
      static_cast<const T*>(bout), static_cast<const T*>(ln2w), static_cast<const T*>(ln2b), \
      m, static_cast<T*>(y), static_cast<T*>(h), static_cast<T*>(qkv), static_cast<T*>(ctx), \
      sp, B, S, W, heads, st
  if (dtype == 0) return run<float>(QT_ARGS(float));
  return run<__nv_bfloat16>(QT_ARGS(__nv_bfloat16));
#undef QT_ARGS
}
