// fused_avq_train: the AVQ sub-forward of one direction over the 2B batch
// rows under eight explicit dropout masks, and its hand-derived backward.
//
//   qst = out(attn(x0 Wq, wrd Wk, wrd Wv) . keep_qst)      question-guided
//   slf = out(attn(x0 Wq, x0 Wk, x0 Wv) . keep_slf)        self
//   crs = out(attn(x0 Wq, val Wk, val Wv) . keep_crs)      cross
//   x1  = x0 + d_slf*slf + d_crs*crs + d_qst*qst;  h1 = LN1(x1)
//   x2  = h1 + ffn2 * W2(ffn1 * relu(W1 h1));     out = LN2(x2)
//
// Replaces qa_tiger_tpu/ops/pallas/avq.py:_kernel_fwd (pallas_call :532,
// body _fwd_body :270) and _kernel_bwd (pallas_call :558, body :356).
//
// Bound on the H100: operations. At N=64 rows of T=60, S=77, D=512 the
// forward's ten projections are 29.3 GFLOP of its ~31 and the attentions
// ~1.5; the backward is about twice that. In fp32 the 3xTF32 rate (494.7 / 3
// TFLOP/s) puts the forward at >= 0.19 ms, the FMA peak (67) at >= 0.46.
// The Pallas kernels keep every intermediate in VMEM and recompute the
// forward in the backward; here each step is one launch and the
// intermediates the backward needs (the projections, the three contexts,
// x1, h1, relu(.), its dropped copy, x2) are written once by the forward
// and kept by the autograd Function, so the backward recomputes only the
// attention probabilities (inside attention_bwd_kernel).
//
// Parameter gradients: Pallas sums them over a sequential grid into
// constant-index blocks. Here the backward writes each per-row gradient
// (g_ffn, g_pre, g_out, g_qkv, ...) to device memory once, and each weight
// gradient is one GEMM whose K dimension is the rows (bwd_weight_grad), each
// bias or LayerNorm gradient one column sum. Deterministic, no atomics. All
// parameter gradients are fp32; activation gradients are in T.
//
// Every product, the forward's ten and the backward's 20, goes through
// qt::planned_gemm (gemm_tf32x3.cuh) against the plan its wrapper built. In
// fp32 all of them take the 3xTF32 tensor-core routine; the forward's have
// K = D = 512 (16 slabs), so none splits and the forward needs no
// workspace, while the backward's weight gradients split along their K
// (the rows) into a workspace (WS) summed in a fixed order. In bf16 the
// forward's products (row-major A, [N, K] weights) take gemm_sm90 (TMA +
// wgmma), the backward's gemm_tile's WMMA loop. The forward's epilogues
// give gemm_sm90's paired stores the values they round (EpiMaskAdd::value)
// or store their own pair (EpiReluDrop::store2, two tensors). The three
// keep-masked attentions stay on qt::attention's FMA kernels.
//
// Rounding: every value the Pallas bodies cast to the activation type is
// rounded to T at the same place (round_t), so the bf16 kernels agree with
// their plain PyTorch versions to bf16 rounding; at fp32 it is the identity.
#include "gemm_tf32x3.cuh"

namespace {

// Indices into the pointer table the wrapper passes (ops/avq.py BUFFERS
// lists the same names in the same order).
enum Buf {
  SRC, VAL, WRD,
  M_QST, M_SLF, M_CRS, M_DSLF, M_DCRS, M_DQST, M_FFN1, M_FFN2,
  // 20 weights, torch layout: in_proj [3D, D] / [3D], out_proj [D, D] / [D]
  QST_W, QST_B, QST_OW, QST_OB, SLF_W, SLF_B, SLF_OW, SLF_OB, CRS_W, CRS_B, CRS_OW, CRS_OB,
  L1_W, L1_B, L2_W, L2_B, N1_W, N1_B, N2_W, N2_B,
  OUT,
  // forward intermediates kept for the backward
  QQ, KVQ, QKV, QC, KVC, QCTX, SCTX, CCTX, X1, H1, HR, HDP, X2,
  // backward: upstream gradient, input gradients, 20 parameter gradients
  G, GSRC, GVAL, GWRD,
  G_QST_W, G_QST_B, G_QST_OW, G_QST_OB, G_SLF_W, G_SLF_B, G_SLF_OW, G_SLF_OB,
  G_CRS_W, G_CRS_B, G_CRS_OW, G_CRS_OB, G_L1_W, G_L1_B, G_L2_W, G_L2_B,
  G_N1_W, G_N1_B, G_N2_W, G_N2_B,
  // backward scratch
  GF, GSRC32, STATS, G_FFN, G_PRE, G_OUT_S, G_OUT_C, G_OUT_Q, G_CTX, G_QQ, G_KVQ, G_QKV, G_QC,
  G_KVC,
  // the split-K partials of the fp32 products (ws_floats floats)
  WS,
  NBUF
};

// out = round(base + round(mask * round(acc + b))); out may alias base (the
// x1 chain: each element is read and written by one thread, once). value()
// is the fp32 value operator() rounds, for gemm_sm90's paired stores.
template <typename T> struct EpiMaskAdd {
  T* out;
  const T* base;
  const T* mask;
  const T* bias;
  long long ldo;
  __device__ float value(int m, int n, float acc) const {
    const long long i = (long long)m * ldo + n;
    const float y = qt::round_t<T>(acc + qt::to_f<T>(bias[n]));
    const float d = qt::round_t<T>(qt::to_f<T>(mask[i]) * y);
    return qt::to_f<T>(base[i]) + d;
  }
  __device__ void operator()(int m, int n, float acc) const {
    out[(long long)m * ldo + n] = qt::from_f<T>(value(m, n, acc));
  }
};

// out (hr) = round(relu(acc + b)); out2 (hdp) = round(hr * mask). Two
// tensors, so gemm_sm90 stores its column pairs through store2.
template <typename T> struct EpiReluDrop {
  static constexpr bool kStore2 = true;
  T* out;
  T* out2;
  const T* mask;
  const T* bias;
  long long ldo;
  __device__ float relu(int n, float acc) const {
    return qt::round_t<T>(fmaxf(acc + qt::to_f<T>(bias[n]), 0.0f));
  }
  __device__ void operator()(int m, int n, float acc) const {
    const long long i = (long long)m * ldo + n;
    const float r = relu(n, acc);
    out[i] = qt::from_f<T>(r);
    out2[i] = qt::from_f<T>(r * qt::to_f<T>(mask[i]));
  }
  __device__ void store2(int m, int n, float a0, float a1) const {
    const long long i = (long long)m * ldo + n;
    const float r0 = relu(n, a0), r1 = relu(n + 1, a1);
    qt::store_pair(out + i, r0, r1);
    qt::store_pair(out2 + i, r0 * qt::to_f<T>(mask[i]), r1 * qt::to_f<T>(mask[i + 1]));
  }
};

template <typename T> struct EpiReluGradDrop {  // g_pre = hr > 0 ? round(round(acc) * mask) : 0
  T* out;
  const T* hr;
  const T* mask;
  long long ld;
  __device__ void operator()(int m, int n, float acc) const {
    const long long i = (long long)m * ld + n;
    const float g = qt::round_t<T>(acc) * qt::to_f<T>(mask[i]);
    out[i] = qt::from_f<T>(qt::to_f<T>(hr[i]) > 0.0f ? g : 0.0f);
  }
};

inline int pad128(int n) { return (n + 127) / 128 * 128; }

#define QT_CHECK()                                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return err
#define QT_TRY(call)                                 \
  if ((err = (call)) != cudaSuccess) return err

template <typename T>
cudaError_t forward(void* const* b, int N, int T_, int S, int D, int heads, qt::GemmPlan plan,
                    cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  const int R = N * T_, RS = N * S, hd = D / heads;
  const float scale = 1.0f / sqrtf((float)hd);
  const long long ldq = pad128(heads * S), lds = pad128(heads * T_);
  const long long D2 = 2LL * D, D3 = 3LL * D, DD = (long long)D * D;
  plan.ws = static_cast<float*>(b[WS]);
  cudaError_t err;
  using qt::EpiBias;
  using qt::planned_gemm;
  using qt::RowLoad;

  // question-guided attention: q from x0, k|v from the words
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(QST_W), D, R, D, D,
                                EpiBias<T>{w(QQ), D, c(QST_B), false}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(WRD), D}, c(QST_W) + DD, D, RS, 2 * D, D,
                                EpiBias<T>{w(KVQ), D2, c(QST_B) + D, false}, plan, st)));
  err = qt::attention<T>(c(QQ), (long long)T_ * D, D, c(KVQ), S * D2, D2, c(KVQ) + D, S * D2, D2,
                         w(QCTX), (long long)T_ * D, D, nullptr, N, T_, S, heads, hd, scale, st,
                         c(M_QST), ldq, false);
  if (err != cudaSuccess) return err;
  // self attention: packed q|k|v from x0
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(SLF_W), D, R, 3 * D, D,
                                EpiBias<T>{w(QKV), D3, c(SLF_B), false}, plan, st)));
  err = qt::attention<T>(c(QKV), T_ * D3, D3, c(QKV) + D, T_ * D3, D3, c(QKV) + 2 * D, T_ * D3,
                         D3, w(SCTX), (long long)T_ * D, D, nullptr, N, T_, T_, heads, hd, scale,
                         st, c(M_SLF), lds, false);
  if (err != cudaSuccess) return err;
  // cross attention: q from x0, k|v from the other stream
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(CRS_W), D, R, D, D,
                                EpiBias<T>{w(QC), D, c(CRS_B), false}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(VAL), D}, c(CRS_W) + DD, D, R, 2 * D, D,
                                EpiBias<T>{w(KVC), D2, c(CRS_B) + D, false}, plan, st)));
  err = qt::attention<T>(c(QC), (long long)T_ * D, D, c(KVC), T_ * D2, D2, c(KVC) + D, T_ * D2,
                         D2, w(CCTX), (long long)T_ * D, D, nullptr, N, T_, T_, heads, hd, scale,
                         st, c(M_CRS), lds, false);
  if (err != cudaSuccess) return err;
  // x1 = x0 + d_slf*slf + d_crs*crs + d_qst*qst, summed in that order
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SCTX), D}, c(SLF_OW), D, R, D, D,
                                EpiMaskAdd<T>{w(X1), c(SRC), c(M_DSLF), c(SLF_OB), D}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(CCTX), D}, c(CRS_OW), D, R, D, D,
                                EpiMaskAdd<T>{w(X1), c(X1), c(M_DCRS), c(CRS_OB), D}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(QCTX), D}, c(QST_OW), D, R, D, D,
                                EpiMaskAdd<T>{w(X1), c(X1), c(M_DQST), c(QST_OB), D}, plan, st)));
  // LN1, FFN with its two dropouts, LN2
  qt::layer_norm_kernel<T, T><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X1), R, D, 1, c(N1_W), c(N1_B), w(H1), nullptr, nullptr, nullptr);
  QT_CHECK();
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(H1), D}, c(L1_W), D, R, D, D,
                                EpiReluDrop<T>{w(HR), w(HDP), c(M_FFN1), c(L1_B), D}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(HDP), D}, c(L2_W), D, R, D, D,
                                EpiMaskAdd<T>{w(X2), c(H1), c(M_FFN2), c(L2_B), D}, plan, st)));
  qt::layer_norm_kernel<T, T><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X2), R, D, 1, c(N2_W), c(N2_B), w(OUT), nullptr, nullptr, nullptr);
  QT_CHECK();
  return plan.done();
}

// The backward of one attention block: g_out = round(g_x1 * d) is given;
// out_proj's gradients, dL/dctx, then the attention backward into
// (gq, gk, gv).
template <typename T>
cudaError_t attn_block_bwd(const T* g_out, const T* ctx, const T* ow, float* g_ow, float* g_ob,
                           T* g_ctx, qt::Strided<const T> q, qt::Strided<const T> k,
                           qt::Strided<const T> v, qt::Strided<T> gq, qt::Strided<T> gk,
                           qt::Strided<T> gv, const T* keep, long long keep_ld, int N, int T_,
                           int Sk, int D, int heads, qt::GemmPlan& plan, cudaStream_t st) {
  const int R = N * T_, hd = D / heads;
  cudaError_t err;
  QT_TRY((qt::planned_gemm<T, false>(qt::RowLoad<T>{g_out, D}, ow, D, R, D, D,
                                     qt::EpiBias<T>{g_ctx, D, nullptr, false}, plan, st)));
  QT_TRY(qt::bwd_weight_grad<T>(qt::ColLoad<T>{g_out, D}, ctx, D, g_ow, D, D, R, plan, st));
  qt::col_sum(qt::Val<T>{g_out, D}, R, D, g_ob, false, st);
  QT_CHECK();
  return qt::attention_bwd<T>(q, k, v, {g_ctx, (long long)T_ * D, D}, gq, gk, gv, keep, keep_ld,
                              N, T_, Sk, heads, hd, 1.0f / sqrtf((float)hd), false, false, st);
}

template <typename T>
cudaError_t backward(void* const* b, int N, int T_, int S, int D, int heads, qt::GemmPlan plan,
                     cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  auto f = [&](Buf i) { return static_cast<float*>(b[i]); };
  const int R = N * T_, RS = N * S;
  const long long ldq = pad128(heads * S), lds = pad128(heads * T_);
  const long long D2 = 2LL * D, D3 = 3LL * D, DD = (long long)D * D;
  float* mean = f(STATS);
  float* rstd = f(STATS) + R;
  plan.ws = f(WS);
  cudaError_t err;
  using qt::planned_gemm;
  using qt::bwd_weight_grad;
  using qt::ColLoad;
  using qt::RowLoad;
  using qt::Val;

  // LN2: g_x2 (fp32, in GF) and g_ffn = round(g_x2 * ffn2)
  qt::layer_norm_bwd_kernel<T, T, T><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X2), c(N2_W), c(G), R, D, f(GF), mean, rstd, c(M_FFN2), w(G_FFN), nullptr, nullptr,
      nullptr, nullptr);
  QT_CHECK();
  qt::col_sum(qt::LnWeightTerm<T, T>{c(X2), c(G), mean, rstd, D}, R, D, f(G_N2_W), false, st);
  qt::col_sum(Val<T>{c(G), D}, R, D, f(G_N2_B), false, st);
  // FFN: linear2, the dropped relu, linear1; g_h1 = g_x2 + g_pre W1 (in GF)
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_FFN), D}, c(L2_W), D, R, D, D,
                                 EpiReluGradDrop<T>{w(G_PRE), c(HR), c(M_FFN1), D}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_FFN), D}, c(HDP), D, f(G_L2_W), D, D, R, plan, st));
  qt::col_sum(Val<T>{c(G_FFN), D}, R, D, f(G_L2_B), false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_PRE), D}, c(L1_W), D, R, D, D,
                                 qt::EpiAddF32{f(GF), f(GF), D}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_PRE), D}, c(H1), D, f(G_L1_W), D, D, R, plan, st));
  qt::col_sum(Val<T>{c(G_PRE), D}, R, D, f(G_L1_B), false, st);
  // LN1: g_x1 (fp32, GSRC32: the residual path into x0) and the three
  // dropped residual gradients; the LN1 parameter grads read g_h1 (GF)
  qt::layer_norm_bwd_kernel<T, T, float><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X1), c(N1_W), f(GF), R, D, f(GSRC32), mean, rstd, c(M_DSLF), w(G_OUT_S), c(M_DCRS),
      w(G_OUT_C), c(M_DQST), w(G_OUT_Q));
  QT_CHECK();
  qt::col_sum(qt::LnWeightTerm<T, float>{c(X1), f(GF), mean, rstd, D}, R, D, f(G_N1_W), false,
              st);
  qt::col_sum(Val<float>{f(GF), D}, R, D, f(G_N1_B), false, st);
  QT_CHECK();

  const long long TD = (long long)T_ * D;
  // question-guided attention
  err = attn_block_bwd<T>(c(G_OUT_Q), c(QCTX), c(QST_OW), f(G_QST_OW), f(G_QST_OB), w(G_CTX),
                          {c(QQ), TD, D}, {c(KVQ), S * D2, D2}, {c(KVQ) + D, S * D2, D2},
                          {w(G_QQ), TD, D}, {w(G_KVQ), S * D2, D2}, {w(G_KVQ) + D, S * D2, D2},
                          c(M_QST), ldq, N, T_, S, D, heads, plan, st);
  if (err != cudaSuccess) return err;
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QQ), D}, c(SRC), D, f(G_QST_W), D, D, R, plan, st));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_KVQ), D2}, c(WRD), D, f(G_QST_W) + DD, 2 * D, D, RS,
                            plan, st));
  qt::col_sum(Val<T>{c(G_QQ), D}, R, D, f(G_QST_B), false, st);
  qt::col_sum(Val<T>{c(G_KVQ), D2}, RS, 2 * D, f(G_QST_B) + D, false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QQ), D}, c(QST_W), D, R, D, D,
                                 qt::EpiAddF32{f(GSRC32), f(GSRC32), D}, plan, st)));
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_KVQ), D2}, c(QST_W) + DD, D, RS, D, 2 * D,
                                 qt::EpiBias<T>{w(GWRD), D, nullptr, false}, plan, st)));
  // self attention
  err = attn_block_bwd<T>(c(G_OUT_S), c(SCTX), c(SLF_OW), f(G_SLF_OW), f(G_SLF_OB), w(G_CTX),
                          {c(QKV), T_ * D3, D3}, {c(QKV) + D, T_ * D3, D3},
                          {c(QKV) + 2 * D, T_ * D3, D3}, {w(G_QKV), T_ * D3, D3},
                          {w(G_QKV) + D, T_ * D3, D3}, {w(G_QKV) + 2 * D, T_ * D3, D3},
                          c(M_SLF), lds, N, T_, T_, D, heads, plan, st);
  if (err != cudaSuccess) return err;
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QKV), D3}, c(SRC), D, f(G_SLF_W), 3 * D, D, R,
                            plan, st));
  qt::col_sum(Val<T>{c(G_QKV), D3}, R, 3 * D, f(G_SLF_B), false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QKV), D3}, c(SLF_W), D, R, D, 3 * D,
                                 qt::EpiAddF32{f(GSRC32), f(GSRC32), D}, plan, st)));
  // cross attention; its q part ends the residual sum and rounds gsrc
  err = attn_block_bwd<T>(c(G_OUT_C), c(CCTX), c(CRS_OW), f(G_CRS_OW), f(G_CRS_OB), w(G_CTX),
                          {c(QC), TD, D}, {c(KVC), T_ * D2, D2}, {c(KVC) + D, T_ * D2, D2},
                          {w(G_QC), TD, D}, {w(G_KVC), T_ * D2, D2}, {w(G_KVC) + D, T_ * D2, D2},
                          c(M_CRS), lds, N, T_, T_, D, heads, plan, st);
  if (err != cudaSuccess) return err;
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QC), D}, c(SRC), D, f(G_CRS_W), D, D, R, plan, st));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_KVC), D2}, c(VAL), D, f(G_CRS_W) + DD, 2 * D, D, R,
                            plan, st));
  qt::col_sum(Val<T>{c(G_QC), D}, R, D, f(G_CRS_B), false, st);
  qt::col_sum(Val<T>{c(G_KVC), D2}, R, 2 * D, f(G_CRS_B) + D, false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QC), D}, c(CRS_W), D, R, D, D,
                                 qt::EpiAddRound<T>{w(GSRC), f(GSRC32), D}, plan, st)));
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_KVC), D2}, c(CRS_W) + DD, D, R, D, 2 * D,
                                 qt::EpiBias<T>{w(GVAL), D, nullptr, false}, plan, st)));
  QT_CHECK();
  return plan.done();
}

#undef QT_CHECK
#undef QT_TRY

}  // namespace

// plan: `products` rows of (M, N, K, chunk, route), the launch's products
// in launch order (ops/gemm.py gemm_plan), route written here; ws_floats:
// the room of the WS buffer (fp32 only)
extern "C" int qt_avq_train_fwd(int dtype, void* const* bufs, int N, int T, int S, int D,
                                int heads, int* plan, int products, long long ws_floats,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qt::GemmPlan fp{plan, products, 0, nullptr, ws_floats};
  if (dtype == 0) return forward<float>(bufs, N, T, S, D, heads, fp, st);
  return forward<__nv_bfloat16>(bufs, N, T, S, D, heads, fp, st);
}

extern "C" int qt_avq_train_bwd(int dtype, void* const* bufs, int N, int T, int S, int D,
                                int heads, int* plan, int products, long long ws_floats,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qt::GemmPlan bp{plan, products, 0, nullptr, ws_floats};
  if (dtype == 0) return backward<float>(bufs, N, T, S, D, heads, bp, st);
  return backward<__nv_bfloat16>(bufs, N, T, S, D, heads, bp, st);
}

extern "C" int qt_avq_num_buffers() { return NBUF; }
