// fused_patch_select_train: the PatchSelecter forward under its three
// explicit dropout masks, and its hand-derived backward.
//
//   x1  = patch + out(attn(patch Wq, patch Wk, patch Wv) . keep_slf)
//   per query stream s in (video, audio), each one row per frame:
//     ctx_s = attn(s Wq, x1 Wk, x1 Wv) . keep_crs_s
//     rel_s = W2 relu(W1 (out_s * crs_out(ctx_s)))
//   v = vnorm(rel_video),  a = anorm(rel_audio)
//
// Replaces qa_tiger_tpu/ops/pallas/patch_select.py:_kernel_train
// (pallas_call :827) and _kernel_bwd (pallas_call :880).
//
// Bound on the H100: operations. At B=32, T=60, P=14, D=512 (BT=1920
// frames, 26,880 patch rows) the forward's seven products are ~85.5 GFLOP
// of its ~91 (the patch-row projections qkv, out_proj, k|v ~82.6); the
// backward is about twice that. In fp32 the card's FMA peak (67 TFLOP/s)
// puts the forward at >= 1.37 ms, the 3xTF32 tensor-core rate (494.7 / 3
// TFLOP/s) at >= 0.55 ms. The TPU kernel packs 16 frames block-diagonally
// into 224-row tiles and recomputes the forward in VMEM in its backward.
// Here a block of the attention kernels owns one frame and head, so no
// score crosses frames; each step is one launch, and the forward writes the
// intermediates the backward needs (qkv, the self context, x1, k|v, the
// stacked queries, the cross context, the dropped out_proj output, the MLP
// hidden and fp32 output) once, for the autograd Function to keep. The
// backward recomputes only the attention probabilities.
//
// The two query streams run as one stacked [2BT, D] batch (video rows
// first) through every GEMM, which sums the streams' shared weight
// gradients in the GEMM's K loop; the cross attention and its backward
// run once per stream with that stream's mask, the audio stream's key and
// value gradients added to the video stream's after rounding each, as the
// Pallas kernel does. Parameter gradients are one GEMM (K = rows) or one
// column sum each: deterministic, no atomics, fp32.
//
// Every product, the forward's seven and the backward's 14, goes through
// qt::planned_gemm (gemm_tf32x3.cuh) against the plan its wrapper built: in
// fp32 the 3xTF32 tensor-core routine (the backward's weight gradients
// split along their K, the rows, into a workspace WS and summed in a fixed
// order); in bf16 the forward's products on gemm_sm90 (TMA + wgmma), the
// backward's on gemm_tile's WMMA loop. The attention over 14 patches and
// the cross attention, forward and backward, take the keep-masked
// tensor-core kernel (attention_keep.cu), a warp per frame and head, and
// each writes the kernel it launched into the plan's attention rows
// (GemmPlan::attention).
//
// Under tensor parallelism (parallel/tensor.py) each model rank holds Wl =
// D / tp columns (its heads' q, k and v rows of both in_proj, the matching
// out_proj columns) and Hl = D / 2 / tp of the MLP's hidden columns. The
// forward and the backward split where their all-reduces fall, as the eval
// kernel splits (csrc/patch_select.cu); between two stages the
// caller sums the fp32 partial over the model ranks, and the next stage
// rounds the sum where the single-rank kernel rounds its accumulator (GSPMD
// partitions around the Pallas calls instead, so the split has no Pallas
// counterpart):
//   forward  tp_self:  qkv of the rank's heads, the self-attention under
//                      its heads' keep lanes, the out_proj partial [R, D];
//            tp_cross: x1 = patch + round(sum + slf_ob), k|v and the two
//                      query streams' q on its heads, the cross attention,
//                      the out_proj partial [2 BT, D];
//            tp_mlp:   crs_d = round(round(sum + crs_ob) * out_s), mlp.0's
//                      column shard with ReLU, mlp.2's partial [2 BT, D];
//            tp_out:   outf = sum + mlp_b2 (fp32), the two LayerNorms;
//   backward bwd_tp_mlp:   the LayerNorms, mlp.2's row backward, the ReLU,
//                          mlp.0's column backward: the partial of the
//                          cross output's gradient [2 BT, D];
//            bwd_tp_cross: g_crs = round(sum * out_s), the cross out_proj
//                          and attention on its heads, the partials of
//                          g_x1 (from the k|v columns) and of the two
//                          streams' gradients, [R + 2 BT, D];
//            bwd_tp_self:  g_x1, g_video and g_audio rounded from the sum,
//                          the self out_proj and attention on its heads,
//                          the partial of gpatch's attention term [R, D]
//                          (the caller adds g_x1 after the sum: EpiResidual).
// The gradients of the sharded weights stay on their rank; those of the
// replicated ones (the norms, the out_proj and mlp.2 biases) come from
// replicated upstream gradients and are the same on every rank.
#include "gemm_tf32x3.cuh"

namespace {

// Indices into the pointer table the wrapper passes (ops/patch_select.py
// TRAIN_BUFFERS lists the same names in the same order).
enum Buf {
  PATCH, VIDEO, AUDIO,
  M_SLF, M_CRS_V, M_CRS_A, M_OUT_V, M_OUT_A,
  SLF_W, SLF_B, SLF_OW, SLF_OB, CRS_W, CRS_B, CRS_OW, CRS_OB,
  MLP_W1, MLP_B1, MLP_W2, MLP_B2, AN_W, AN_B, VN_W, VN_B,
  A_OUT, V_OUT,
  // forward intermediates kept for the backward
  QKV, SCTX, X1, KV, SRC2, Q, CTX, CRS_D, HID, OUTF,
  // backward: upstream gradients, input gradients, 16 parameter gradients
  GA, GV, GPATCH, GVIDEO, GAUDIO,
  G_SLF_W, G_SLF_B, G_SLF_OW, G_SLF_OB, G_CRS_W, G_CRS_B, G_CRS_OW, G_CRS_OB,
  G_MLP_W1, G_MLP_B1, G_MLP_W2, G_MLP_B2, G_AN_W, G_AN_B, G_VN_W, G_VN_B,
  // backward scratch
  G_REL, STATS, G_PRE1, G_CRS_O, G_CTX, G_QC, G_KV, G_X1, G_SLF, G_QKV,
  // the split-K partials of the fp32 products (ws_floats floats)
  WS,
  // tensor-parallel stages: the reduced fp32 sum a stage starts from, the
  // fp32 partial it ends in
  TOTAL, PART,
  NBUF
};

// out = round(round(acc + b) * mask) (mask null: round(acc)), mask rows
// [0, split) from m0 and [split, 2 split) from m1: the per-stream dropout.
// value() is the fp32 value operator() rounds, for gemm_sm90's paired stores.
template <typename T> struct EpiMaskSplit {
  T* out;
  const T* bias;
  const T* m0;
  const T* m1;
  int split;
  long long ldo;
  __device__ float value(int m, int n, float acc) const {
    const float y = bias ? qt::round_t<T>(acc + qt::to_f<T>(bias[n])) : acc;
    const T* mk = m < split ? m0 + (long long)m * ldo : m1 + (long long)(m - split) * ldo;
    return y * qt::to_f<T>(mk[n]);
  }
  __device__ void operator()(int m, int n, float acc) const {
    out[(long long)m * ldo + n] = qt::from_f<T>(value(m, n, acc));
  }
};

template <typename T> struct EpiSplitRows {  // rows [0, split) -> out0, the rest -> out1
  T* out0;
  T* out1;
  int split;
  long long ld;
  __device__ void operator()(int m, int n, float acc) const {
    T* o = m < split ? out0 + (long long)m * ld : out1 + (long long)(m - split) * ld;
    o[n] = qt::from_f<T>(acc);
  }
};

template <typename T> struct EpiReluGradF32 {  // out (fp32) = hid > 0 ? acc : 0
  float* out;
  const T* hid;
  long long ld;
  __device__ void operator()(int m, int n, float acc) const {
    const long long i = (long long)m * ld + n;
    out[i] = qt::to_f<T>(hid[i]) > 0.0f ? acc : 0.0f;
  }
};

inline int pad128(int n) { return (n + 127) / 128 * 128; }

// EpiMaskSplit's value with a reduced fp32 sum in place of the accumulator:
// out = round((bias ? round(sum + bias) : sum) * mask), rows [0, split)
// masked by m0, the rest by m1. One thread per element.
template <typename T>
__global__ void mask_split_kernel(const float* sum, const T* bias, const T* m0, const T* m1,
                                  int split, T* out, long long n, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long m = i / D;
  const int col = (int)(i % D);
  const float y = bias ? qt::round_t<T>(sum[i] + qt::to_f<T>(bias[col])) : sum[i];
  const T* mk = m < split ? m0 + i : m1 + (i - (long long)split * D);
  out[i] = qt::from_f<T>(y * qt::to_f<T>(*mk));
}

template <typename T>
cudaError_t mask_split(const float* sum, const T* bias, const T* m0, const T* m1, int split,
                       T* out, long long n, int D, cudaStream_t st) {
  mask_split_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(sum, bias, m0, m1, split, out,
                                                                    n, D);
  return cudaGetLastError();
}

// out = round(sum) over rows of D (reduce_epilogue_kernel without bias or
// residual)
template <typename T>
cudaError_t round_rows(const float* sum, T* out, int rows, int D, cudaStream_t st) {
  qt::reduce_epilogue_kernel<T, T><<<qt::ln_blocks(rows), qt::LN_WARPS * 32, 0, st>>>(
      sum, rows, D, nullptr, nullptr, out, nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

#define QT_CHECK()                                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return err
#define QT_TRY(call)                                 \
  if ((err = (call)) != cudaSuccess) return err

template <typename T>
cudaError_t forward(void* const* b, int BT, int P, int D, int heads, qt::GemmPlan plan,
                    cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  const int R = BT * P, Q2 = 2 * BT, Dh = D / 2, hd = D / heads;
  const float scale = 1.0f / sqrtf((float)hd);
  const long long lk = pad128(heads * P), D2 = 2LL * D, D3 = 3LL * D, DD = (long long)D * D;
  const long long BD = (long long)BT * D;
  plan.ws = static_cast<float*>(b[WS]);
  cudaError_t err;
  using qt::EpiBias;
  using qt::planned_gemm;
  using qt::RowLoad;

  // self-attention over each frame's patches, out_proj + residual
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(PATCH), D}, c(SLF_W), D, R, 3 * D, D,
                                EpiBias<T>{w(QKV), D3, c(SLF_B), false}, plan, st)));
  err = qt::attention<T>(c(QKV), P * D3, D3, c(QKV) + D, P * D3, D3, c(QKV) + 2 * D, P * D3, D3,
                         w(SCTX), (long long)P * D, D, nullptr, BT, P, P, heads, hd, scale, st,
                         c(M_SLF), lk, true, nullptr, plan.attention(P, P));
  if (err != cudaSuccess) return err;
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SCTX), D}, c(SLF_OW), D, R, D, D,
                                qt::EpiResidual<T>{w(X1), D, c(SLF_OB), c(PATCH), D}, plan, st)));
  // cross attention: k|v from the patches, one query row per frame and stream
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(X1), D}, c(CRS_W) + DD, D, R, 2 * D, D,
                                EpiBias<T>{w(KV), D2, c(CRS_B) + D, false}, plan, st)));
  if ((err = cudaMemcpyAsync(w(SRC2), c(VIDEO), BD * sizeof(T), cudaMemcpyDeviceToDevice, st)))
    return err;
  if ((err = cudaMemcpyAsync(w(SRC2) + BD, c(AUDIO), BD * sizeof(T), cudaMemcpyDeviceToDevice,
                             st)))
    return err;
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(SRC2), D}, c(CRS_W), D, Q2, D, D,
                                EpiBias<T>{w(Q), D, c(CRS_B), false}, plan, st)));
  for (int s = 0; s < 2; ++s) {
    err = qt::attention<T>(c(Q) + s * BD, D, D, c(KV), P * D2, D2, c(KV) + D, P * D2, D2,
                           w(CTX) + s * BD, D, D, nullptr, BT, 1, P, heads, hd, scale, st,
                           c(s ? M_CRS_A : M_CRS_V), lk, true, nullptr, plan.attention(1, P));
    if (err != cudaSuccess) return err;
  }
  QT_TRY((planned_gemm<T, true>(
      RowLoad<T>{c(CTX), D}, c(CRS_OW), D, Q2, D, D,
      EpiMaskSplit<T>{w(CRS_D), c(CRS_OB), c(M_OUT_V), c(M_OUT_A), BT, D}, plan, st)));
  // MLP; its output stays fp32 into the per-stream LayerNorm
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(CRS_D), D}, c(MLP_W1), D, Q2, Dh, D,
                                EpiBias<T>{w(HID), Dh, c(MLP_B1), true}, plan, st)));
  float* outf = static_cast<float*>(b[OUTF]);
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{c(HID), Dh}, c(MLP_W2), Dh, Q2, D, Dh,
                                qt::EpiF32<T>{outf, D, c(MLP_B2)}, plan, st)));
  qt::layer_norm_kernel<float, T><<<qt::ln_blocks(BT), qt::LN_WARPS * 32, 0, st>>>(
      outf, BT, D, 1, c(VN_W), c(VN_B), w(V_OUT), nullptr, nullptr, nullptr);
  qt::layer_norm_kernel<float, T><<<qt::ln_blocks(BT), qt::LN_WARPS * 32, 0, st>>>(
      outf + BD, BT, D, 1, c(AN_W), c(AN_B), w(A_OUT), nullptr, nullptr, nullptr);
  QT_CHECK();
  return plan.done();
}

template <typename T>
cudaError_t backward(void* const* b, int BT, int P, int D, int heads, qt::GemmPlan plan,
                     cudaStream_t st) {
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };
  auto f = [&](Buf i) { return static_cast<float*>(b[i]); };
  const int R = BT * P, Q2 = 2 * BT, Dh = D / 2, hd = D / heads;
  const float scale = 1.0f / sqrtf((float)hd);
  const long long lk = pad128(heads * P), D2 = 2LL * D, D3 = 3LL * D, DD = (long long)D * D;
  const long long BD = (long long)BT * D;
  float* mean = f(STATS);
  float* rstd = f(STATS) + Q2;
  plan.ws = f(WS);
  cudaError_t err;
  using qt::planned_gemm;
  using qt::bwd_weight_grad;
  using qt::ColLoad;
  using qt::RowLoad;
  using qt::Val;

  // per-stream LayerNorms: video rows first, then audio
  const T* g_up[2] = {c(GV), c(GA)};
  const T* norm_w[2] = {c(VN_W), c(AN_W)};
  float* g_nw[2] = {f(G_VN_W), f(G_AN_W)};
  float* g_nb[2] = {f(G_VN_B), f(G_AN_B)};
  for (int s = 0; s < 2; ++s) {
    const float* x = f(OUTF) + s * BD;
    qt::layer_norm_bwd_kernel<T, float, T><<<qt::ln_blocks(BT), qt::LN_WARPS * 32, 0, st>>>(
        x, norm_w[s], g_up[s], BT, D, f(G_REL) + s * BD, mean + s * BT, rstd + s * BT, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr);
    qt::col_sum(qt::LnWeightTerm<float, T>{x, g_up[s], mean + s * BT, rstd + s * BT, D}, BT, D,
                g_nw[s], false, st);
    qt::col_sum(Val<T>{g_up[s], D}, BT, D, g_nb[s], false, st);
  }
  QT_CHECK();
  // MLP backward over both streams
  QT_TRY((planned_gemm<T, false>(qt::RoundRowLoad<T>{f(G_REL), D}, c(MLP_W2), Dh, Q2, Dh, D,
                                 EpiReluGradF32<T>{f(G_PRE1), c(HID), Dh}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(qt::RoundColLoad<T>{f(G_REL), D}, c(HID), Dh, f(G_MLP_W2), D, Dh,
                            Q2, plan, st));
  qt::col_sum(Val<float>{f(G_REL), D}, Q2, D, f(G_MLP_B2), false, st);
  QT_TRY((planned_gemm<T, false>(
      qt::RoundRowLoad<T>{f(G_PRE1), Dh}, c(MLP_W1), D, Q2, D, Dh,
      EpiMaskSplit<T>{w(G_CRS_O), nullptr, c(M_OUT_V), c(M_OUT_A), BT, D}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(qt::RoundColLoad<T>{f(G_PRE1), Dh}, c(CRS_D), D, f(G_MLP_W1), Dh,
                            D, Q2, plan, st));
  qt::col_sum(Val<float>{f(G_PRE1), Dh}, Q2, Dh, f(G_MLP_B1), false, st);
  // cross out_proj and attention, one stream at a time
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_CRS_O), D}, c(CRS_OW), D, Q2, D, D,
                                 qt::EpiBias<T>{w(G_CTX), D, nullptr, false}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_CRS_O), D}, c(CTX), D, f(G_CRS_OW), D, D, Q2,
                            plan, st));
  qt::col_sum(Val<T>{c(G_CRS_O), D}, Q2, D, f(G_CRS_OB), false, st);
  for (int s = 0; s < 2; ++s) {
    err = qt::attention_bwd<T>({c(Q) + s * BD, D, D}, {c(KV), P * D2, D2},
                               {c(KV) + D, P * D2, D2}, {c(G_CTX) + s * BD, D, D},
                               {w(G_QC) + s * BD, D, D}, {w(G_KV), P * D2, D2},
                               {w(G_KV) + D, P * D2, D2}, c(s ? M_CRS_A : M_CRS_V), lk, BT, 1, P,
                               heads, hd, scale, true, s == 1, st, plan.attention(1, P));
    if (err != cudaSuccess) return err;
  }
  // cross in_proj: the query half over both streams, the k|v half over patches
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QC), D}, c(SRC2), D, f(G_CRS_W), D, D, Q2, plan, st));
  qt::col_sum(Val<T>{c(G_QC), D}, Q2, D, f(G_CRS_B), false, st);
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QC), D}, c(CRS_W), D, Q2, D, D,
                                 EpiSplitRows<T>{w(GVIDEO), w(GAUDIO), BT, D}, plan, st)));
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_KV), D2}, c(CRS_W) + DD, D, R, D, 2 * D,
                                 qt::EpiBias<T>{w(G_X1), D, nullptr, false}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_KV), D2}, c(X1), D, f(G_CRS_W) + DD, 2 * D, D, R,
                            plan, st));
  qt::col_sum(Val<T>{c(G_KV), D2}, R, 2 * D, f(G_CRS_B) + D, false, st);
  // self out_proj and attention
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_X1), D}, c(SLF_OW), D, R, D, D,
                                 qt::EpiBias<T>{w(G_SLF), D, nullptr, false}, plan, st)));
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_X1), D}, c(SCTX), D, f(G_SLF_OW), D, D, R, plan, st));
  qt::col_sum(Val<T>{c(G_X1), D}, R, D, f(G_SLF_OB), false, st);
  err = qt::attention_bwd<T>({c(QKV), P * D3, D3}, {c(QKV) + D, P * D3, D3},
                             {c(QKV) + 2 * D, P * D3, D3}, {c(G_SLF), (long long)P * D, D},
                             {w(G_QKV), P * D3, D3}, {w(G_QKV) + D, P * D3, D3},
                             {w(G_QKV) + 2 * D, P * D3, D3}, c(M_SLF), lk, BT, P, P, heads, hd,
                             scale, true, false, st, plan.attention(P, P));
  if (err != cudaSuccess) return err;
  QT_TRY(bwd_weight_grad<T>(ColLoad<T>{c(G_QKV), D3}, c(PATCH), D, f(G_SLF_W), 3 * D, D, R,
                            plan, st));
  qt::col_sum(Val<T>{c(G_QKV), D3}, R, 3 * D, f(G_SLF_B), false, st);
  // gpatch = g_x1 + round(g_qkv W_slf)
  QT_TRY((planned_gemm<T, false>(RowLoad<T>{c(G_QKV), D3}, c(SLF_W), D, R, D, 3 * D,
                                 qt::EpiResidual<T>{w(GPATCH), D, nullptr, c(G_X1), D}, plan, st)));
  QT_CHECK();
  return plan.done();
}

// ---------------------------------------------------------------------------
// tensor-parallel stages (Wl = D / tp columns, Hl = Wl / 2, heads = H / tp)
// ---------------------------------------------------------------------------

#define QT_TP_PROLOGUE                                                                \
  auto c = [&](Buf i) { return static_cast<const T*>(b[i]); };                        \
  auto w = [&](Buf i) { return static_cast<T*>(b[i]); };                              \
  auto f = [&](Buf i) { return static_cast<float*>(b[i]); };                          \
  const int R = BT * P, Q2 = 2 * BT, Hl = Wl / 2, hd = Wl / heads;                    \
  const float scale = 1.0f / sqrtf((float)hd);                                        \
  const long long lk = pad128(heads * P), W2 = 2LL * Wl, W3 = 3LL * Wl;               \
  const long long WD = (long long)Wl * D, BD = (long long)BT * D, BW = (long long)BT * Wl; \
  plan.ws = f(WS);                                                                    \
  cudaError_t err;                                                                    \
  (void)c; (void)w; (void)f; (void)R; (void)Q2; (void)Hl; (void)scale; (void)lk;      \
  (void)W2; (void)W3; (void)WD; (void)BD; (void)BW

template <typename T>
cudaError_t tp_self(void* const* b, int BT, int P, int D, int Wl, int heads, qt::GemmPlan plan,
                    cudaStream_t st) {
  QT_TP_PROLOGUE;
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(PATCH), D}, c(SLF_W), D, R, 3 * Wl, D,
                                    qt::EpiBias<T>{w(QKV), W3, c(SLF_B), false}, plan, st)));
  QT_TRY(qt::attention<T>(c(QKV), P * W3, W3, c(QKV) + Wl, P * W3, W3, c(QKV) + 2 * Wl, P * W3,
                          W3, w(SCTX), (long long)P * Wl, Wl, nullptr, BT, P, P, heads, hd,
                          scale, st, c(M_SLF), lk, true, nullptr, plan.attention(P, P)));
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(SCTX), Wl}, c(SLF_OW), Wl, R, D, Wl,
                                    qt::EpiF32<T>{f(PART), D, nullptr}, plan, st)));
  return plan.done();
}

template <typename T>
cudaError_t tp_cross(void* const* b, int BT, int P, int D, int Wl, int heads, qt::GemmPlan plan,
                     cudaStream_t st) {
  QT_TP_PROLOGUE;
  // x1 = patch + round(sum + slf_ob)
  qt::reduce_epilogue_kernel<T, T><<<qt::ln_blocks(R), qt::LN_WARPS * 32, 0, st>>>(
      f(TOTAL), R, D, c(SLF_OB), c(PATCH), w(X1), nullptr, nullptr, nullptr);
  QT_CHECK();
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(X1), D}, c(CRS_W) + WD, D, R, 2 * Wl, D,
                                    qt::EpiBias<T>{w(KV), W2, c(CRS_B) + Wl, false}, plan, st)));
  QT_TRY(cudaMemcpyAsync(w(SRC2), c(VIDEO), BD * sizeof(T), cudaMemcpyDeviceToDevice, st));
  QT_TRY(cudaMemcpyAsync(w(SRC2) + BD, c(AUDIO), BD * sizeof(T), cudaMemcpyDeviceToDevice, st));
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(SRC2), D}, c(CRS_W), D, Q2, Wl, D,
                                    qt::EpiBias<T>{w(Q), Wl, c(CRS_B), false}, plan, st)));
  for (int s = 0; s < 2; ++s)
    QT_TRY(qt::attention<T>(c(Q) + s * BW, Wl, Wl, c(KV), P * W2, W2, c(KV) + Wl, P * W2, W2,
                            w(CTX) + s * BW, Wl, Wl, nullptr, BT, 1, P, heads, hd, scale, st,
                            c(s ? M_CRS_A : M_CRS_V), lk, true, nullptr, plan.attention(1, P)));
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(CTX), Wl}, c(CRS_OW), Wl, Q2, D, Wl,
                                    qt::EpiF32<T>{f(PART), D, nullptr}, plan, st)));
  return plan.done();
}

template <typename T>
cudaError_t tp_mlp(void* const* b, int BT, int P, int D, int Wl, int heads, qt::GemmPlan plan,
                   cudaStream_t st) {
  QT_TP_PROLOGUE;
  QT_TRY(mask_split<T>(f(TOTAL), c(CRS_OB), c(M_OUT_V), c(M_OUT_A), BT, w(CRS_D), 2 * BD, D,
                       st));
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(CRS_D), D}, c(MLP_W1), D, Q2, Hl, D,
                                    qt::EpiBias<T>{w(HID), Hl, c(MLP_B1), true}, plan, st)));
  QT_TRY((qt::planned_gemm<T, true>(qt::RowLoad<T>{c(HID), Hl}, c(MLP_W2), Hl, Q2, D, Hl,
                                    qt::EpiF32<T>{f(PART), D, nullptr}, plan, st)));
  return plan.done();
}

template <typename T>
cudaError_t tp_out(void* const* b, int BT, int P, int D, int Wl, int heads, qt::GemmPlan plan,
                   cudaStream_t st) {
  QT_TP_PROLOGUE;
  // outf = sum + mlp_b2 in fp32, then the per-stream LayerNorms
  qt::reduce_epilogue_kernel<T, float><<<qt::ln_blocks(Q2), qt::LN_WARPS * 32, 0, st>>>(
      f(TOTAL), Q2, D, c(MLP_B2), nullptr, f(OUTF), nullptr, nullptr, nullptr);
  qt::layer_norm_kernel<float, T><<<qt::ln_blocks(BT), qt::LN_WARPS * 32, 0, st>>>(
      f(OUTF), BT, D, 1, c(VN_W), c(VN_B), w(V_OUT), nullptr, nullptr, nullptr);
  qt::layer_norm_kernel<float, T><<<qt::ln_blocks(BT), qt::LN_WARPS * 32, 0, st>>>(
      f(OUTF) + BD, BT, D, 1, c(AN_W), c(AN_B), w(A_OUT), nullptr, nullptr, nullptr);
  QT_CHECK();
  return plan.done();
}

template <typename T>
cudaError_t bwd_tp_mlp(void* const* b, int BT, int P, int D, int Wl, int heads, qt::GemmPlan plan,
                       cudaStream_t st) {
  QT_TP_PROLOGUE;
  float* mean = f(STATS);
  float* rstd = f(STATS) + Q2;
  const T* g_up[2] = {c(GV), c(GA)};
  const T* norm_w[2] = {c(VN_W), c(AN_W)};
  float* g_nw[2] = {f(G_VN_W), f(G_AN_W)};
  float* g_nb[2] = {f(G_VN_B), f(G_AN_B)};
  for (int s = 0; s < 2; ++s) {
    const float* x = f(OUTF) + s * BD;
    qt::layer_norm_bwd_kernel<T, float, T><<<qt::ln_blocks(BT), qt::LN_WARPS * 32, 0, st>>>(
        x, norm_w[s], g_up[s], BT, D, f(G_REL) + s * BD, mean + s * BT, rstd + s * BT, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr);
    qt::col_sum(qt::LnWeightTerm<float, T>{x, g_up[s], mean + s * BT, rstd + s * BT, D}, BT, D,
                g_nw[s], false, st);
    qt::col_sum(qt::Val<T>{g_up[s], D}, BT, D, g_nb[s], false, st);
  }
  QT_CHECK();
  QT_TRY((qt::planned_gemm<T, false>(qt::RoundRowLoad<T>{f(G_REL), D}, c(MLP_W2), Hl, Q2, Hl, D,
                                     EpiReluGradF32<T>{f(G_PRE1), c(HID), Hl}, plan, st)));
  QT_TRY(qt::bwd_weight_grad<T>(qt::RoundColLoad<T>{f(G_REL), D}, c(HID), Hl, f(G_MLP_W2), D,
                                Hl, Q2, plan, st));
  qt::col_sum(qt::Val<float>{f(G_REL), D}, Q2, D, f(G_MLP_B2), false, st);
  QT_TRY((qt::planned_gemm<T, false>(qt::RoundRowLoad<T>{f(G_PRE1), Hl}, c(MLP_W1), D, Q2, D, Hl,
                                     qt::EpiStoreF32{f(PART), D, false}, plan, st)));
  QT_TRY(qt::bwd_weight_grad<T>(qt::RoundColLoad<T>{f(G_PRE1), Hl}, c(CRS_D), D, f(G_MLP_W1), Hl,
                                D, Q2, plan, st));
  qt::col_sum(qt::Val<float>{f(G_PRE1), Hl}, Q2, Hl, f(G_MLP_B1), false, st);
  QT_CHECK();
  return plan.done();
}

template <typename T>
cudaError_t bwd_tp_cross(void* const* b, int BT, int P, int D, int Wl, int heads,
                         qt::GemmPlan plan, cudaStream_t st) {
  QT_TP_PROLOGUE;
  using qt::ColLoad;
  using qt::RowLoad;
  using qt::Val;
  // the cross output's gradient: round(sum * out_s), EpiMaskSplit's rounding
  QT_TRY(mask_split<T>(f(TOTAL), nullptr, c(M_OUT_V), c(M_OUT_A), BT, w(G_CRS_O), 2 * BD, D,
                       st));
  QT_TRY((qt::planned_gemm<T, false>(RowLoad<T>{c(G_CRS_O), D}, c(CRS_OW), Wl, Q2, Wl, D,
                                     qt::EpiBias<T>{w(G_CTX), Wl, nullptr, false}, plan, st)));
  QT_TRY(qt::bwd_weight_grad<T>(ColLoad<T>{c(G_CRS_O), D}, c(CTX), Wl, f(G_CRS_OW), D, Wl, Q2,
                                plan, st));
  qt::col_sum(Val<T>{c(G_CRS_O), D}, Q2, D, f(G_CRS_OB), false, st);
  for (int s = 0; s < 2; ++s)
    QT_TRY(qt::attention_bwd<T>({c(Q) + s * BW, Wl, Wl}, {c(KV), P * W2, W2},
                                {c(KV) + Wl, P * W2, W2}, {c(G_CTX) + s * BW, Wl, Wl},
                                {w(G_QC) + s * BW, Wl, Wl}, {w(G_KV), P * W2, W2},
                                {w(G_KV) + Wl, P * W2, W2}, c(s ? M_CRS_A : M_CRS_V), lk, BT, 1,
                                P, heads, hd, scale, true, s == 1, st, plan.attention(1, P)));
  QT_TRY(qt::bwd_weight_grad<T>(ColLoad<T>{c(G_QC), Wl}, c(SRC2), D, f(G_CRS_W), Wl, D, Q2, plan,
                                st));
  qt::col_sum(Val<T>{c(G_QC), Wl}, Q2, Wl, f(G_CRS_B), false, st);
  // partials: g_x1 rows [0, R), the two streams' rows [R, R + 2 BT)
  QT_TRY((qt::planned_gemm<T, false>(RowLoad<T>{c(G_QC), Wl}, c(CRS_W), D, Q2, D, Wl,
                                     qt::EpiStoreF32{f(PART) + (long long)R * D, D, false}, plan,
                                     st)));
  QT_TRY((qt::planned_gemm<T, false>(RowLoad<T>{c(G_KV), W2}, c(CRS_W) + WD, D, R, D, 2 * Wl,
                                     qt::EpiStoreF32{f(PART), D, false}, plan, st)));
  QT_TRY(qt::bwd_weight_grad<T>(ColLoad<T>{c(G_KV), W2}, c(X1), D, f(G_CRS_W) + WD, 2 * Wl, D, R,
                                plan, st));
  qt::col_sum(Val<T>{c(G_KV), W2}, R, 2 * Wl, f(G_CRS_B) + Wl, false, st);
  QT_CHECK();
  return plan.done();
}

template <typename T>
cudaError_t bwd_tp_self(void* const* b, int BT, int P, int D, int Wl, int heads,
                        qt::GemmPlan plan, cudaStream_t st) {
  QT_TP_PROLOGUE;
  using qt::ColLoad;
  using qt::RowLoad;
  using qt::Val;
  // g_x1 and the two streams' gradients, each rounded once from the sum
  const float* total = f(TOTAL);
  QT_TRY(round_rows<T>(total, w(G_X1), R, D, st));
  QT_TRY(round_rows<T>(total + (long long)R * D, w(GVIDEO), BT, D, st));
  QT_TRY(round_rows<T>(total + (long long)R * D + BD, w(GAUDIO), BT, D, st));
  QT_TRY((qt::planned_gemm<T, false>(RowLoad<T>{c(G_X1), D}, c(SLF_OW), Wl, R, Wl, D,
                                     qt::EpiBias<T>{w(G_SLF), Wl, nullptr, false}, plan, st)));
  QT_TRY(qt::bwd_weight_grad<T>(ColLoad<T>{c(G_X1), D}, c(SCTX), Wl, f(G_SLF_OW), D, Wl, R, plan,
                                st));
  qt::col_sum(Val<T>{c(G_X1), D}, R, D, f(G_SLF_OB), false, st);
  QT_TRY(qt::attention_bwd<T>({c(QKV), P * W3, W3}, {c(QKV) + Wl, P * W3, W3},
                              {c(QKV) + 2 * Wl, P * W3, W3}, {c(G_SLF), (long long)P * Wl, Wl},
                              {w(G_QKV), P * W3, W3}, {w(G_QKV) + Wl, P * W3, W3},
                              {w(G_QKV) + 2 * Wl, P * W3, W3}, c(M_SLF), lk, BT, P, P, heads, hd,
                              scale, true, false, st, plan.attention(P, P)));
  QT_TRY(qt::bwd_weight_grad<T>(ColLoad<T>{c(G_QKV), W3}, c(PATCH), D, f(G_SLF_W), 3 * Wl, D, R,
                                plan, st));
  qt::col_sum(Val<T>{c(G_QKV), W3}, R, 3 * Wl, f(G_SLF_B), false, st);
  // the partial of gpatch's attention term
  QT_TRY((qt::planned_gemm<T, false>(RowLoad<T>{c(G_QKV), W3}, c(SLF_W), D, R, D, 3 * Wl,
                                     qt::EpiStoreF32{f(PART), D, false}, plan, st)));
  QT_CHECK();
  return plan.done();
}

#undef QT_TP_PROLOGUE
#undef QT_CHECK
#undef QT_TRY

}  // namespace

// plan: `products` rows of (M, N, K, chunk, route), the launch's products
// in launch order (ops/gemm.py gemm_plan), route written here; attn:
// `attns` rows of (Sq, Sk, kernel), its keep-masked attentions in launch
// order (ops/attention.py keep_rows), kernel written here; ws_floats: the
// room of the WS buffer (fp32 only)
extern "C" int qt_patch_select_train_fwd(int dtype, void* const* bufs, int BT, int P, int D,
                                         int heads, int* plan, int products, int* attn,
                                         int attns, long long ws_floats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qt::GemmPlan fp{plan, products, 0, nullptr, ws_floats, attn, attns};
  if (dtype == 0) return forward<float>(bufs, BT, P, D, heads, fp, st);
  return forward<__nv_bfloat16>(bufs, BT, P, D, heads, fp, st);
}

extern "C" int qt_patch_select_train_bwd(int dtype, void* const* bufs, int BT, int P, int D,
                                         int heads, int* plan, int products, int* attn,
                                         int attns, long long ws_floats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qt::GemmPlan bp{plan, products, 0, nullptr, ws_floats, attn, attns};
  if (dtype == 0) return backward<float>(bufs, BT, P, D, heads, bp, st);
  return backward<__nv_bfloat16>(bufs, BT, P, D, heads, bp, st);
}

// the tensor-parallel stages: the same pointer table; Wl = D / tp, heads
// the rank's
#define QT_PS_TP(NAME, FN)                                                                 \
  extern "C" int NAME(int dtype, void* const* bufs, int BT, int P, int D, int Wl, int heads, \
                      int residual, int* plan, int products, int* attn, int attns,           \
                      long long ws_floats, void* stream) {                                   \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                     \
    const qt::GemmPlan gp{plan, products, 0, nullptr, ws_floats, attn, attns};               \
    (void)residual;                                                                          \
    if (dtype == 0) return FN<float>(bufs, BT, P, D, Wl, heads, gp, st);                     \
    return FN<__nv_bfloat16>(bufs, BT, P, D, Wl, heads, gp, st);                             \
  }

QT_PS_TP(qt_patch_select_train_tp_self, tp_self)
QT_PS_TP(qt_patch_select_train_tp_cross, tp_cross)
QT_PS_TP(qt_patch_select_train_tp_mlp, tp_mlp)
QT_PS_TP(qt_patch_select_train_tp_out, tp_out)
QT_PS_TP(qt_patch_select_train_bwd_tp_mlp, bwd_tp_mlp)
QT_PS_TP(qt_patch_select_train_bwd_tp_cross, bwd_tp_cross)
QT_PS_TP(qt_patch_select_train_bwd_tp_self, bwd_tp_self)
#undef QT_PS_TP

extern "C" int qt_patch_select_train_num_buffers() { return NBUF; }
