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
// attention probabilities (inside the attention backward kernel).
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
// keep-masked attentions, forward and backward, take qt::attention's and
// qt::attention_bwd's keep-masked tensor-core kernel (attention_keep.cu:
// bf16 mma.sync, fp32 3xTF32), and each writes the kernel it launched into
// the plan's attention rows (GemmPlan::attention).
//
// Rounding: every value the Pallas bodies cast to the activation type is
// rounded to T at the same place (round_t), so the bf16 kernels agree with
// their plain PyTorch versions to bf16 rounding; at fp32 it is the identity.
//
// Under tensor parallelism (parallel/tensor.py) each model rank holds Wl =
// D / tp columns: its heads' q, k and v rows of the three in_proj, the
// matching columns of the out_projs, linear1's rows and linear2's columns.
// The forward and the backward split where their all-reduces fall (JAX's
// GSPMD partitions the step around the Pallas calls instead, so the split
// has no Pallas counterpart); between two stages the caller sums the fp32
// partials over the model ranks, and the next stage rounds the sum where
// the single-rank kernel rounds its accumulator:
//   forward  qt_avq_train_tp_attn: the rank's heads of the three attentions
//              (keep masks cut to its heads' lanes), the three out_proj
//              partials [3, R, D] (self, cross, question: each is rounded
//              and masked apart before the residual sum);
//            qt_avq_train_tp_mid: the residual chain x1 in the single
//              kernel's order and rounding (mask_chain_kernel), LN1,
//              linear1's column shard with ReLU and ffn1's columns,
//              linear2's partial [R, D];
//            qt_avq_train_tp_out: x2 = h1 + ffn2 * round(sum + b2), LN2;
//   backward qt_avq_train_bwd_tp_ffn: LN2, linear2's row backward, the
//              masked ReLU, linear1's column backward; its dgrad is the
//              fp32 partial of g_h1 (model rank 0 adds the residual g_x2);
//            qt_avq_train_bwd_tp_attn: LN1 on the summed g_h1, the three
//              blocks' backward on the rank's heads; the fp32 partials of
//              gsrc (rank 0 adds the residual g_x1), gval and gwrd in one
//              [2R + RS, D] buffer, which the caller sums and rounds once.
// The gradients of the sharded weights stay on their rank; those of the
// replicated ones (the norms, the out_proj and linear2 biases) come from
// replicated upstream gradients and are the same on every rank.
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
  // tensor-parallel stages: the reduced fp32 sum a stage starts from, the
  // fp32 partial it ends in
  TOTAL, PART,
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

// The residual chain of the tensor-parallel forward after the reduce: for
// each term i in order, out = round(out + round(mask_i * round(sum_i +
// bias_i))), out starting at base: EpiMaskAdd's arithmetic with the
// reduced sum in place of the accumulator. One thread per element.
template <typename T> struct MaskTerms {
  const float* sum[3];
  const T* bias[3];
  const T* mask[3];
};

template <typename T>
__global__ void mask_chain_kernel(MaskTerms<T> terms, int count, const T* base, T* out,
                                  long long n, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int col = (int)(i % D);
  float x = qt::to_f<T>(base[i]);
  for (int t = 0; t < count; ++t) {
    const float y = qt::round_t<T>(terms.sum[t][i] + qt::to_f<T>(terms.bias[t][col]));
    x = qt::round_t<T>(x + qt::round_t<T>(qt::to_f<T>(terms.mask[t][i]) * y));
  }
  out[i] = qt::from_f<T>(x);
}

template <typename T>
cudaError_t mask_chain(const MaskTerms<T>& terms, int count, const T* base, T* out, long long n,
                       int D, cudaStream_t st) {
  mask_chain_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(terms, count, base, out, n,
                                                                    D);
  return cudaGetLastError();
}

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
                         c(M_QST), ldq, false, nullptr, plan.attention(T_, S));
  if (err != cudaSuccess) return err;
  // self attention: packed q|k|v from x0
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(SLF_W), D, R, 3 * D, D,
                                EpiBias<T>{w(QKV), D3, c(SLF_B), false}, plan, st)));
  err = qt::attention<T>(c(QKV), T_ * D3, D3, c(QKV) + D, T_ * D3, D3, c(QKV) + 2 * D, T_ * D3,
                         D3, w(SCTX), (long long)T_ * D, D, nullptr, N, T_, T_, heads, hd, scale,
                         st, c(M_SLF), lds, false, nullptr, plan.attention(T_, T_));
  if (err != cudaSuccess) return err;
  // cross attention: q from x0, k|v from the other stream
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(CRS_W), D, R, D, D,
                                EpiBias<T>{w(QC), D, c(CRS_B), false}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(VAL), D}, c(CRS_W) + DD, D, R, 2 * D, D,
                                EpiBias<T>{w(KVC), D2, c(CRS_B) + D, false}, plan, st)));
  err = qt::attention<T>(c(QC), (long long)T_ * D, D, c(KVC), T_ * D2, D2, c(KVC) + D, T_ * D2,
                         D2, w(CCTX), (long long)T_ * D, D, nullptr, N, T_, T_, heads, hd, scale,
                         st, c(M_CRS), lds, false, nullptr, plan.attention(T_, T_));
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
                              N, T_, Sk, heads, hd, 1.0f / sqrtf((float)hd), false, false, st,
                              plan.attention(T_, Sk));
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

// ---------------------------------------------------------------------------
// tensor-parallel stages (Wl = D / tp columns, heads = H / tp heads)
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t tp_attn(void* const* b, int N, int T_, int S, int D, int Wl, int heads,
                    qt::GemmPlan plan, cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  const int R = N * T_, RS = N * S, hd = Wl / heads;
  const float scale = 1.0f / sqrtf((float)hd);
  const long long ldq = pad128(heads * S), lds = pad128(heads * T_);
  const long long W2 = 2LL * Wl, W3 = 3LL * Wl, WD = (long long)Wl * D, RD = (long long)R * D;
  float* part = static_cast<float*>(b[PART]);
  plan.ws = static_cast<float*>(b[WS]);
  cudaError_t err;
  using qt::EpiBias;
  using qt::planned_gemm;
  using qt::RowLoad;

  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(QST_W), D, R, Wl, D,
                                EpiBias<T>{w(QQ), Wl, c(QST_B), false}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(WRD), D}, c(QST_W) + WD, D, RS, 2 * Wl, D,
                                EpiBias<T>{w(KVQ), W2, c(QST_B) + Wl, false}, plan, st)));
  QT_TRY(qt::attention<T>(c(QQ), (long long)T_ * Wl, Wl, c(KVQ), S * W2, W2, c(KVQ) + Wl, S * W2,
                          W2, w(QCTX), (long long)T_ * Wl, Wl, nullptr, N, T_, S, heads, hd,
                          scale, st, c(M_QST), ldq, false, nullptr, plan.attention(T_, S)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(SLF_W), D, R, 3 * Wl, D,
                                EpiBias<T>{w(QKV), W3, c(SLF_B), false}, plan, st)));
  QT_TRY(qt::attention<T>(c(QKV), T_ * W3, W3, c(QKV) + Wl, T_ * W3, W3, c(QKV) + 2 * Wl,
                          T_ * W3, W3, w(SCTX), (long long)T_ * Wl, Wl, nullptr, N, T_, T_,
                          heads, hd, scale, st, c(M_SLF), lds, false, nullptr,
                          plan.attention(T_, T_)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC), D}, c(CRS_W), D, R, Wl, D,
                                EpiBias<T>{w(QC), Wl, c(CRS_B), false}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(VAL), D}, c(CRS_W) + WD, D, R, 2 * Wl, D,
                                EpiBias<T>{w(KVC), W2, c(CRS_B) + Wl, false}, plan, st)));
  QT_TRY(qt::attention<T>(c(QC), (long long)T_ * Wl, Wl, c(KVC), T_ * W2, W2, c(KVC) + Wl,
                          T_ * W2, W2, w(CCTX), (long long)T_ * Wl, Wl, nullptr, N, T_, T_,
                          heads, hd, scale, st, c(M_CRS), lds, false, nullptr,
                          plan.attention(T_, T_)));
  // the three out_proj partials, fp32 [3, R, D]: self, cross, question
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SCTX), Wl}, c(SLF_OW), Wl, R, D, Wl,
                                qt::EpiF32<T>{part, D, nullptr}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(CCTX), Wl}, c(CRS_OW), Wl, R, D, Wl,
                                qt::EpiF32<T>{part + RD, D, nullptr}, plan, st)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(QCTX), Wl}, c(QST_OW), Wl, R, D, Wl,
                                qt::EpiF32<T>{part + 2 * RD, D, nullptr}, plan, st)));
  return plan.done();
}

template <typename T>
cudaError_t tp_mid(void* const* b, int N, int T_, int D, int Wl, qt::GemmPlan plan,
                   cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  const int R = N * T_;
  const long long RD = (long long)R * D;
  const float* total = static_cast<const float*>(b[TOTAL]);
  plan.ws = static_cast<float*>(b[WS]);
  cudaError_t err;
  // x1 = x0 + d_slf*slf + d_crs*crs + d_qst*qst, summed in that order
  const MaskTerms<T> terms{{total, total + RD, total + 2 * RD},
                           {c(SLF_OB), c(CRS_OB), c(QST_OB)},
                           {c(M_DSLF), c(M_DCRS), c(M_DQST)}};
  QT_TRY(mask_chain<T>(terms, 3, c(SRC), w(X1), RD, D, st));
  qt::layer_norm_kernel<T, T><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X1), R, D, 1, c(N1_W), c(N1_B), w(H1), nullptr, nullptr, nullptr);
  QT_CHECK();
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(H1), D}, c(L1_W), D, R, Wl, D,
                                    EpiReluDrop<T>{w(HR), w(HDP), c(M_FFN1), c(L1_B), Wl}, plan,
                                    st)));
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(HDP), Wl}, c(L2_W), Wl, R, D, Wl,
                                    qt::EpiF32<T>{static_cast<float*>(b[PART]), D, nullptr},
                                    plan, st)));
  return plan.done();
}

template <typename T>
cudaError_t tp_out(void* const* b, int N, int T_, int D, cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  const int R = N * T_;
  cudaError_t err;
  const MaskTerms<T> terms{{static_cast<const float*>(b[TOTAL])}, {c(L2_B)}, {c(M_FFN2)}};
  QT_TRY(mask_chain<T>(terms, 1, c(H1), w(X2), (long long)R * D, D, st));
  qt::layer_norm_kernel<T, T><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X2), R, D, 1, c(N2_W), c(N2_B), w(OUT), nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_tp_ffn(void* const* b, int N, int T_, int D, int Wl, bool residual,
                       qt::GemmPlan plan, cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  auto f = [&](Buf i) { return static_cast<float*>(b[i]); };
  const int R = N * T_;
  float* mean = f(STATS);
  float* rstd = f(STATS) + R;
  plan.ws = f(WS);
  cudaError_t err;
  using qt::planned_gemm;
  using qt::bwd_weight_grad;
  using qt::ColLoad;
  using qt::RowLoad;
  using qt::Val;

  qt::layer_norm_bwd_kernel<T, T, T><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X2), c(N2_W), c(G), R, D, f(GF), mean, rstd, c(M_FFN2), w(G_FFN), nullptr, nullptr,
      nullptr, nullptr);
  QT_CHECK();
  qt::col_sum(qt::LnWeightTerm<T, T>{c(X2), c(G), mean, rstd, D}, R, D, f(G_N2_W), false, st);
  qt::col_sum(Val<T>{c(G), D}, R, D, f(G_N2_B), false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_FFN), D}, c(L2_W), Wl, R, Wl, D,
                                 EpiReluGradDrop<T>{w(G_PRE), c(HR), c(M_FFN1), Wl}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_FFN), D}, c(HDP), Wl, f(G_L2_W), D, Wl, R, plan, st));
  qt::col_sum(Val<T>{c(G_FFN), D}, R, D, f(G_L2_B), false, st);
  // the partial of g_h1 = g_x2 + g_pre W1 over the rank's columns; g_x2 on
  // model rank 0 only
  if (residual) {
    QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_PRE), Wl}, c(L1_W), D, R, D, Wl,
                                   qt::EpiAddF32{f(PART), f(GF), D}, plan, st)));
  } else {
    QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_PRE), Wl}, c(L1_W), D, R, D, Wl,
                                   qt::EpiStoreF32{f(PART), D, false}, plan, st)));
  }
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_PRE), Wl}, c(H1), D, f(G_L1_W), Wl, D, R, plan, st));
  qt::col_sum(Val<T>{c(G_PRE), Wl}, R, Wl, f(G_L1_B), false, st);
  QT_CHECK();
  return plan.done();
}

// attn_block_bwd over the rank's heads: out_proj's columns [D, Wl]
template <typename T>
cudaError_t attn_block_bwd_tp(const T* g_out, const T* ctx, const T* ow, float* g_ow, float* g_ob,
                              T* g_ctx, qt::Strided<const T> q, qt::Strided<const T> k,
                              qt::Strided<const T> v, qt::Strided<T> gq, qt::Strided<T> gk,
                              qt::Strided<T> gv, const T* keep, long long keep_ld, int N, int T_,
                              int Sk, int D, int Wl, int heads, qt::GemmPlan& plan,
                              cudaStream_t st) {
  const int R = N * T_, hd = Wl / heads;
  cudaError_t err;
  QT_TRY((qt::planned_gemm<T, false>(qt::RowLoad<T>{g_out, D}, ow, Wl, R, Wl, D,
                                     qt::EpiBias<T>{g_ctx, Wl, nullptr, false}, plan, st)));
  QT_TRY(qt::bwd_weight_grad<T>(qt::ColLoad<T>{g_out, D}, ctx, Wl, g_ow, D, Wl, R, plan, st));
  qt::col_sum(qt::Val<T>{g_out, D}, R, D, g_ob, false, st);
  QT_CHECK();
  return qt::attention_bwd<T>(q, k, v, {g_ctx, (long long)T_ * Wl, Wl}, gq, gk, gv, keep,
                              keep_ld, N, T_, Sk, heads, hd, 1.0f / sqrtf((float)hd), false, false,
                              st, plan.attention(T_, Sk));
}

template <typename T>
cudaError_t bwd_tp_attn(void* const* b, int N, int T_, int S, int D, int Wl, int heads,
                        bool residual, qt::GemmPlan plan, cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  auto f = [&](Buf i) { return static_cast<float*>(b[i]); };
  const int R = N * T_, RS = N * S;
  const long long ldq = pad128(heads * S), lds = pad128(heads * T_);
  const long long W2 = 2LL * Wl, W3 = 3LL * Wl, WD = (long long)Wl * D, RD = (long long)R * D;
  const long long TW = (long long)T_ * Wl;
  const float* gh1 = f(TOTAL);
  float* gsrc = f(PART);  // [2R + RS, D]: gsrc, gval, gwrd partials
  float* gval = gsrc + RD;
  float* gwrd = gsrc + 2 * RD;
  float* mean = f(STATS);
  float* rstd = f(STATS) + R;
  plan.ws = f(WS);
  cudaError_t err;
  using qt::planned_gemm;
  using qt::bwd_weight_grad;
  using qt::ColLoad;
  using qt::RowLoad;
  using qt::Val;

  // LN1: g_x1 (the residual into x0, rank 0's share of gsrc) and the three
  // dropped residual gradients
  qt::layer_norm_bwd_kernel<T, T, float><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      c(X1), c(N1_W), gh1, R, D, gsrc, mean, rstd, c(M_DSLF), w(G_OUT_S), c(M_DCRS), w(G_OUT_C),
      c(M_DQST), w(G_OUT_Q));
  QT_CHECK();
  qt::col_sum(qt::LnWeightTerm<T, float>{c(X1), gh1, mean, rstd, D}, R, D, f(G_N1_W), false, st);
  qt::col_sum(Val<float>{gh1, D}, R, D, f(G_N1_B), false, st);
  QT_CHECK();
  if (!residual) QT_TRY(cudaMemsetAsync(gsrc, 0, RD * sizeof(float), st));

  QT_TRY(attn_block_bwd_tp<T>(c(G_OUT_Q), c(QCTX), c(QST_OW), f(G_QST_OW), f(G_QST_OB), w(G_CTX),
                              {c(QQ), TW, Wl}, {c(KVQ), S * W2, W2}, {c(KVQ) + Wl, S * W2, W2},
                              {w(G_QQ), TW, Wl}, {w(G_KVQ), S * W2, W2},
                              {w(G_KVQ) + Wl, S * W2, W2}, c(M_QST), ldq, N, T_, S, D, Wl, heads,
                              plan, st));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QQ), Wl}, c(SRC), D, f(G_QST_W), Wl, D, R, plan, st));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_KVQ), W2}, c(WRD), D, f(G_QST_W) + WD, 2 * Wl, D, RS,
                            plan, st));
  qt::col_sum(Val<T>{c(G_QQ), Wl}, R, Wl, f(G_QST_B), false, st);
  qt::col_sum(Val<T>{c(G_KVQ), W2}, RS, 2 * Wl, f(G_QST_B) + Wl, false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QQ), Wl}, c(QST_W), D, R, D, Wl,
                                 qt::EpiAddF32{gsrc, gsrc, D}, plan, st)));
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_KVQ), W2}, c(QST_W) + WD, D, RS, D, 2 * Wl,
                                 qt::EpiStoreF32{gwrd, D, false}, plan, st)));

  QT_TRY(attn_block_bwd_tp<T>(c(G_OUT_S), c(SCTX), c(SLF_OW), f(G_SLF_OW), f(G_SLF_OB), w(G_CTX),
                              {c(QKV), T_ * W3, W3}, {c(QKV) + Wl, T_ * W3, W3},
                              {c(QKV) + 2 * Wl, T_ * W3, W3}, {w(G_QKV), T_ * W3, W3},
                              {w(G_QKV) + Wl, T_ * W3, W3}, {w(G_QKV) + 2 * Wl, T_ * W3, W3},
                              c(M_SLF), lds, N, T_, T_, D, Wl, heads, plan, st));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QKV), W3}, c(SRC), D, f(G_SLF_W), 3 * Wl, D, R, plan,
                            st));
  qt::col_sum(Val<T>{c(G_QKV), W3}, R, 3 * Wl, f(G_SLF_B), false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QKV), W3}, c(SLF_W), D, R, D, 3 * Wl,
                                 qt::EpiAddF32{gsrc, gsrc, D}, plan, st)));

  QT_TRY(attn_block_bwd_tp<T>(c(G_OUT_C), c(CCTX), c(CRS_OW), f(G_CRS_OW), f(G_CRS_OB), w(G_CTX),
                              {c(QC), TW, Wl}, {c(KVC), T_ * W2, W2}, {c(KVC) + Wl, T_ * W2, W2},
                              {w(G_QC), TW, Wl}, {w(G_KVC), T_ * W2, W2},
                              {w(G_KVC) + Wl, T_ * W2, W2}, c(M_CRS), lds, N, T_, T_, D, Wl,
                              heads, plan, st));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QC), Wl}, c(SRC), D, f(G_CRS_W), Wl, D, R, plan, st));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_KVC), W2}, c(VAL), D, f(G_CRS_W) + WD, 2 * Wl, D, R,
                            plan, st));
  qt::col_sum(Val<T>{c(G_QC), Wl}, R, Wl, f(G_CRS_B), false, st);
  qt::col_sum(Val<T>{c(G_KVC), W2}, R, 2 * Wl, f(G_CRS_B) + Wl, false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QC), Wl}, c(CRS_W), D, R, D, Wl,
                                 qt::EpiAddF32{gsrc, gsrc, D}, plan, st)));
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_KVC), W2}, c(CRS_W) + WD, D, R, D, 2 * Wl,
                                 qt::EpiStoreF32{gval, D, false}, plan, st)));
  QT_CHECK();
  return plan.done();
}

#undef QT_CHECK
#undef QT_TRY

}  // namespace

// plan: `products` rows of (M, N, K, chunk, route), the launch's products
// in launch order (ops/gemm.py gemm_plan), route written here; attn:
// `attns` rows of (Sq, Sk, kernel), its keep-masked attentions in launch
// order (ops/attention.py keep_rows), kernel written here; ws_floats: the
// room of the WS buffer (fp32 only)
extern "C" int qt_avq_train_fwd(int dtype, void* const* bufs, int N, int T, int S, int D,
                                int heads, int* plan, int products, int* attn, int attns,
                                long long ws_floats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qt::GemmPlan fp{plan, products, 0, nullptr, ws_floats, attn, attns};
  if (dtype == 0) return forward<float>(bufs, N, T, S, D, heads, fp, st);
  return forward<__nv_bfloat16>(bufs, N, T, S, D, heads, fp, st);
}

extern "C" int qt_avq_train_bwd(int dtype, void* const* bufs, int N, int T, int S, int D,
                                int heads, int* plan, int products, int* attn, int attns,
                                long long ws_floats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qt::GemmPlan bp{plan, products, 0, nullptr, ws_floats, attn, attns};
  if (dtype == 0) return backward<float>(bufs, N, T, S, D, heads, bp, st);
  return backward<__nv_bfloat16>(bufs, N, T, S, D, heads, bp, st);
}

// the tensor-parallel stages: the same pointer table; Wl = D / tp, heads
// the rank's; residual: this rank adds the residual gradient (model rank 0)
#define QT_AVQ_TP(NAME, CALL)                                                         \
  extern "C" int NAME(int dtype, void* const* bufs, int N, int T, int S, int D, int Wl, \
                      int heads, int residual, int* plan, int products, int* attn,      \
                      int attns, long long ws_floats, void* stream) {                   \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                \
    const qt::GemmPlan gp{plan, products, 0, nullptr, ws_floats, attn, attns};          \
    (void)S;                                                                            \
    (void)heads;                                                                        \
    (void)residual;                                                                     \
    (void)gp;                                                                           \
    if (dtype == 0) {                                                                   \
      using T_ = float;                                                                 \
      return CALL;                                                                      \
    }                                                                                   \
    using T_ = __nv_bfloat16;                                                           \
    return CALL;                                                                        \
  }

QT_AVQ_TP(qt_avq_train_tp_attn, (tp_attn<T_>(bufs, N, T, S, D, Wl, heads, gp, st)))
QT_AVQ_TP(qt_avq_train_tp_mid, (tp_mid<T_>(bufs, N, T, D, Wl, gp, st)))
QT_AVQ_TP(qt_avq_train_tp_out, (tp_out<T_>(bufs, N, T, D, st)))
QT_AVQ_TP(qt_avq_train_bwd_tp_ffn, (bwd_tp_ffn<T_>(bufs, N, T, D, Wl, residual != 0, gp, st)))
QT_AVQ_TP(qt_avq_train_bwd_tp_attn,
          (bwd_tp_attn<T_>(bufs, N, T, S, D, Wl, heads, residual != 0, gp, st)))
#undef QT_AVQ_TP

extern "C" int qt_avq_num_buffers() { return NBUF; }
