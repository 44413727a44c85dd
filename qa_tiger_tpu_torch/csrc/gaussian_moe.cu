// fused_gaussian_moe: out[b] = sum_e sum_t w[b,e,t] * MLP_e(x[b,t]) with
// MLP_e = Linear(D->H) -> ReLU -> Linear(H->D), T contracted before the
// second Linear.
//
// Replaces qa_tiger_tpu/ops/pallas/gaussian_moe.py:_pallas_impl (_kernel).
//
// Bound on the H100: operations. The first Linear over every (b, t, e) is
// 2*B*T*D*H*E flops (56 GFLOP at B=512, T=60, D=512, H=256, E=7) against a
// few MB of x and weights. Two launches, no atomics, no [B, T, E, D] tensor:
//   1. grid (H tile, b, e): the GEMM relu(x[b] W1_e + b1_e) over the T rows
//      of sample b on bf16 tensor cores (fp32 FMAs for fp32), reduced over t
//      in the epilogue with the weights w[b,e,:] into s[b,e,:] (fp32), plus
//      wsum[b,e] = sum_t w[b,e,t]. Blocks of all experts run in parallel,
//      which replaces the TPU's sequential expert grid axis.
//   2. one GEMM over K = E*H: out[b] = sum_e s[b,e,:] W2_e + sum_e wsum[b,e] b2_e,
//      fp32 A (s) on fp32 FMAs, 1/60 of the first launch's work.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(qt::GEMM_THREADS)
moe_hidden_kernel(const T* __restrict__ x, const T* __restrict__ w1t, const T* __restrict__ b1,
                  const T* __restrict__ w, float* __restrict__ s, float* __restrict__ wsum,
                  int T_, int D, int H, int E) {
  __shared__ qt::GemmSmem sm;
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  const int n0 = blockIdx.x * qt::BN, b = blockIdx.y, e = blockIdx.z;
  const T* wr = w + ((long long)b * E + e) * T_;
  const qt::RowLoad<T> aload{x + (long long)b * T_ * D, D};
  const int n = n0 + threadIdx.x;
  float acc = 0.0f;
  for (int m0 = 0; m0 < T_; m0 += qt::BM) {
    qt::gemm_tile<T, TC, false>(sm, aload, w1t + (long long)e * D * H, H, T_, H, D, m0, n0);
    if (threadIdx.x < qt::BN && n < H) {
      const float bias = qt::to_f<T>(b1[(long long)e * H + n]);
      const int rows = min(qt::BM, T_ - m0);
      for (int r = 0; r < rows; ++r)
        acc = fmaf(qt::to_f<T>(wr[m0 + r]), fmaxf(sm.c[r * qt::CS_LD + threadIdx.x] + bias, 0.0f),
                   acc);
    }
    __syncthreads();
  }
  if (threadIdx.x < qt::BN && n < H) s[((long long)b * E + e) * H + n] = acc;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float t = 0.0f;
    for (int i = threadIdx.x; i < T_; i += 32) t += qt::to_f<T>(wr[i]);
    t = qt::warp_sum(t);
    if (threadIdx.x == 0) wsum[b * E + e] = t;
  }
}

template <typename T> struct EpiMoeOut {  // out = acc + sum_e wsum[b,e] b2[e,:]
  T* out;
  const float* wsum;
  const T* b2;
  int D, E;
  __device__ void operator()(int m, int n, float acc) const {
    for (int e = 0; e < E; ++e) acc = fmaf(wsum[m * E + e], qt::to_f<T>(b2[e * D + n]), acc);
    out[(long long)m * D + n] = qt::from_f<T>(acc);
  }
};

template <typename T>
cudaError_t run(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
                const void* w, float* s, float* wsum, void* out, int B, int T_, int D, int H,
                int E, cudaStream_t stream) {
  const dim3 grid1((H + qt::BN - 1) / qt::BN, B, E);
  moe_hidden_kernel<T><<<grid1, qt::GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1t), static_cast<const T*>(b1),
      static_cast<const T*>(w), s, wsum, T_, D, H, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // second Linear of every expert as one K = E*H product; A is fp32, so the
  // FMA main loop runs it whatever T is
  const dim3 grid2((D + qt::BN - 1) / qt::BN, (B + qt::BM - 1) / qt::BM);
  qt::gemm_kernel<T, false, false><<<grid2, qt::GEMM_THREADS, 0, stream>>>(
      qt::RowLoad<float>{s, (long long)E * H}, static_cast<const T*>(w2t), D, B, D, E * H,
      EpiMoeOut<T>{static_cast<T*>(out), wsum, static_cast<const T*>(b2), D, E});
  return cudaGetLastError();
}

}  // namespace

extern "C" int qt_gaussian_moe(int dtype, const void* x, const void* w1t, const void* b1,
                               const void* w2t, const void* b2, const void* w, void* s,
                               void* wsum, void* out, int B, int T, int D, int H, int E,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(s);
  float* wp = static_cast<float*>(wsum);
  if (dtype == 0) return run<float>(x, w1t, b1, w2t, b2, w, sp, wp, out, B, T, D, H, E, st);
  return run<__nv_bfloat16>(x, w1t, b1, w2t, b2, w, sp, wp, out, B, T, D, H, E, st);
}
