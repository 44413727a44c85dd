// fused_patch_select: the whole eval PatchSelecter over a [B*T, P, D] batch
// of frames: per-frame self-attention over the P patches with residual, then
// the frame's video and audio vectors as two queries attending its patches,
// out_proj, MLP (ReLU) and one LayerNorm per stream.
//
// Replaces qa_tiger_tpu/ops/pallas/patch_select.py:_pallas_impl (_kernel).
//
// Bound on the H100: operations. At B=256, T=60, P=14, D=512 the patch-row
// projections (qkv, out_proj, kv) are 12*BT*P*D^2 = 677 GFLOP of the
// module's ~731; attention over 14 keys is under 1% of it. Eleven
// launches, all written here: seven GEMMs over the BT*P patch rows and 2*BT
// query rows, one copy that interleaves the (video, audio) query rows into
// the ctx2 scratch for the query GEMM's 16-byte loads, two launches of
// attention.cu's device code (self: 14 queries x 14 keys per frame and
// head; cross: 2 queries x 14 keys, which overwrites ctx2 only after the
// query GEMM has read it), and one LayerNorm launch that splits the
// interleaved (video, audio) rows into the two outputs.
//
// Every product goes through qt::planned_gemm (gemm_tf32x3.cuh) against the
// plan its wrapper built (ops/gemm.py gemm_plan, the seven rows of
// patch_select_gemm_shapes), as the train forward's do: in bf16 on
// gemm_sm90 (TMA + wgmma) where gemm_route gives it; in fp32 on the 3xTF32
// routine gemm_tf32x3 (TMA + wgmma; the fp32 evaluation forward that `test`
// and every epoch's validation run; gemm_tile's FMA loop took ~18x the
// products' 3xTF32 bound there). A product the plan does not name, or that
// gemm_tf32x3 refuses, returns an error: nothing falls back to gemm_tile.
// Each of the two attentions writes the kernel it launched into the plan's
// attention rows (GemmPlan::attention). The TPU kernel's block-diagonal
// frame packing is not needed: in bf16 both attentions take the short
// tensor-core kernel (a warp owns one frame and head, a 16 x 16 score
// tile), in fp32 the keep-masked kernel without a keep mask
// (attention_keep.cu "mma_nokeep": 3xTF32, a warp per frame and head), so
// no score is computed across frames. Intermediates make one HBM round
// trip each, which the Pallas kernel avoided; fusing them is later work.
//
// Under tensor parallelism (parallel/tensor.py) the module splits at its
// three row products' all-reduces into three partial stages per rank, each
// followed by the caller's sum over the model ranks and a post-reduce
// launch (qt_reduce_epilogue, resblock.cu); Wl = D / tp, heads / tp heads.
// The stages plan their products as the whole kernel does (ops/gemm.py
// patch_select_train_tp_gemm_shapes: tp_self, tp_cross, tp_mlp), so a rank
// rounds as tp = 1 does:
//   1. qt_patch_select_tp_self: qkv over the rank's head rows [3 Wl, D], the
//      self-attention (bf16: still the short tensor-core kernel, 14 x 14
//      at head size 64), the out_proj partial over K = Wl into fp32
//      [BT*P, D];  -> x1 = patch + round(sum + slf_ob)
//   2. qt_patch_select_tp_cross: k|v from x1 and q from the interleaved
//      (video, audio) rows on the rank's head rows, the cross-attention,
//      the out_proj partial into fp32 [2 BT, D];  -> crs = round(sum + crs_ob)
//   3. qt_patch_select_tp_mlp: mlp.0 over the rank's D/2/tp hidden columns
//      with ReLU, the mlp.2 partial into fp32 [2 BT, D];
//      -> qt_patch_select_tp_out: outf = sum + mlp_b2, the two LayerNorms.
// Every value is rounded once, where the single-rank kernel rounds it.
#include "gemm_tf32x3.cuh"

namespace {

using qt::EpiBias;
using qt::GemmPlan;
using qt::planned_gemm;
using qt::RowLoad;

#define QT_TRY(call)                                 \
  if ((err = (call)) != cudaSuccess) return err
#define QT_CHECK()                                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return err

// ctx2 [2 BT, D] = the (video, audio) rows interleaved: row 2f is video[f],
// row 2f + 1 audio[f], for the query product's row-major loads
template <typename T>
cudaError_t interleave(const T* video, const T* audio, T* ctx2, int BT, int D,
                       cudaStream_t stream) {
  const long long n = 2LL * BT * D;
  qt::interleave_rows_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(video, audio,
                                                                                 ctx2, BT, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* patch, const T* video, const T* audio, const T* slf_w,
                const T* slf_b, const T* slf_ow, const T* slf_ob, const T* crs_w,
                const T* crs_b, const T* crs_ow, const T* crs_ob, const T* mlp_w1,
                const T* mlp_b1, const T* mlp_w2, const T* mlp_b2, const T* anorm_w,
                const T* anorm_b, const T* vnorm_w, const T* vnorm_b, T* a_out, T* v_out,
                T* qkv, T* ctx, T* x1, T* kv, T* q, T* ctx2, T* crs, T* hid, float* outf,
                int BT, int P, int D, int heads, GemmPlan plan, cudaStream_t stream) {
  const int M = BT * P, Q = 2 * BT, Dh = D / 2, hd = D / heads;
  const float scale = 1.0f / sqrtf((float)hd);
  cudaError_t err;
  // self-attention over each frame's P patches, out_proj + residual
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{patch, D}, slf_w, D, M, 3 * D, D,
                                EpiBias<T>{qkv, 3LL * D, slf_b, false}, plan, stream)));
  const long long fs = 3LL * P * D;
  QT_TRY(qt::attention<T>(qkv, fs, 3LL * D, qkv + D, fs, 3LL * D, qkv + 2 * D, fs, 3LL * D, ctx,
                          (long long)P * D, D, nullptr, BT, P, P, heads, hd, scale, stream,
                          nullptr, 0, false, nullptr, plan.attention(P, P)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{ctx, D}, slf_ow, D, M, D, D,
                                qt::EpiResidual<T>{x1, D, slf_ob, patch, D}, plan, stream)));
  // cross-attention: keys/values from the patches, 2 queries per frame
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{x1, D}, crs_w + (long long)D * D, D, M, 2 * D, D,
                                EpiBias<T>{kv, 2LL * D, crs_b + D, false}, plan, stream)));
  QT_TRY(interleave<T>(video, audio, ctx2, BT, D, stream));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{ctx2, D}, crs_w, D, Q, D, D,
                                EpiBias<T>{q, D, crs_b, false}, plan, stream)));
  const long long ks = 2LL * P * D;
  QT_TRY(qt::attention<T>(q, 2LL * D, D, kv, ks, 2LL * D, kv + D, ks, 2LL * D, ctx2, 2LL * D, D,
                          nullptr, BT, 2, P, heads, hd, scale, stream, nullptr, 0, false,
                          nullptr, plan.attention(2, P)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{ctx2, D}, crs_ow, D, Q, D, D,
                                EpiBias<T>{crs, D, crs_ob, false}, plan, stream)));
  // MLP; its output stays fp32 into the per-stream LayerNorm
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{crs, D}, mlp_w1, D, Q, Dh, D,
                                EpiBias<T>{hid, Dh, mlp_b1, true}, plan, stream)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{hid, Dh}, mlp_w2, Dh, Q, D, Dh,
                                qt::EpiF32<T>{outf, D, mlp_b2}, plan, stream)));
  qt::layer_norm_kernel<float, T><<<qt::ln_blocks(Q), qt::LN_WARPS * 32, 0, stream>>>(
      outf, Q, D, 2, vnorm_w, vnorm_b, v_out, anorm_w, anorm_b, a_out);
  QT_CHECK();
  return plan.done();
}

// q, k and v of the rank's heads (slf_w [3 Wl, D]), the self-attention,
// part [BT*P, D] fp32 = ctx slf_ow^T (slf_ow [D, Wl]); qkv [BT*P, 3 Wl] and
// ctx [BT*P, Wl] scratch
template <typename T>
cudaError_t tp_self(const T* patch, const T* slf_w, const T* slf_b, const T* slf_ow, float* part,
                    T* qkv, T* ctx, int BT, int P, int D, int Wl, int heads, GemmPlan plan,
                    cudaStream_t stream) {
  const int M = BT * P, hd = Wl / heads;
  cudaError_t err;
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{patch, D}, slf_w, D, M, 3 * Wl, D,
                                EpiBias<T>{qkv, 3LL * Wl, slf_b, false}, plan, stream)));
  const long long fs = 3LL * P * Wl;
  QT_TRY(qt::attention<T>(qkv, fs, 3LL * Wl, qkv + Wl, fs, 3LL * Wl, qkv + 2 * Wl, fs, 3LL * Wl,
                          ctx, (long long)P * Wl, Wl, nullptr, BT, P, P, heads, hd,
                          1.0f / sqrtf((float)hd), stream, nullptr, 0, false, nullptr,
                          plan.attention(P, P)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{ctx, Wl}, slf_ow, Wl, M, D, Wl,
                                qt::EpiF32<T>{part, D, nullptr}, plan, stream)));
  return plan.done();
}

// k|v from x1 and q from the interleaved (video, audio) rows on the rank's
// heads (crs_w [3 Wl, D]: q rows, then k, then v), the cross-attention,
// part [2 BT, D] fp32 = ctx2 crs_ow^T; kv [BT*P, 2 Wl], q [2 BT, Wl] and
// ctx2 [2 BT, D] scratch (the interleaved query rows first)
template <typename T>
cudaError_t tp_cross(const T* x1, const T* video, const T* audio, const T* crs_w, const T* crs_b,
                     const T* crs_ow, float* part, T* kv, T* q, T* ctx2, int BT, int P, int D,
                     int Wl, int heads, GemmPlan plan, cudaStream_t stream) {
  const int M = BT * P, Q = 2 * BT, hd = Wl / heads;
  cudaError_t err;
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{x1, D}, crs_w + (long long)Wl * D, D, M, 2 * Wl, D,
                                EpiBias<T>{kv, 2LL * Wl, crs_b + Wl, false}, plan, stream)));
  QT_TRY(interleave<T>(video, audio, ctx2, BT, D, stream));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{ctx2, D}, crs_w, D, Q, Wl, D,
                                EpiBias<T>{q, Wl, crs_b, false}, plan, stream)));
  const long long ks = 2LL * P * Wl;
  QT_TRY(qt::attention<T>(q, 2LL * Wl, Wl, kv, ks, 2LL * Wl, kv + Wl, ks, 2LL * Wl, ctx2,
                          2LL * Wl, Wl, nullptr, BT, 2, P, heads, hd, 1.0f / sqrtf((float)hd),
                          stream, nullptr, 0, false, nullptr, plan.attention(2, P)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{ctx2, Wl}, crs_ow, Wl, Q, D, Wl,
                                qt::EpiF32<T>{part, D, nullptr}, plan, stream)));
  return plan.done();
}

// hid [2 BT, Hl] = relu(crs mlp_w1^T + mlp_b1) over the rank's hidden
// columns, part [2 BT, D] fp32 = hid mlp_w2^T (mlp_w2 [D, Hl])
template <typename T>
cudaError_t tp_mlp(const T* crs, const T* mlp_w1, const T* mlp_b1, const T* mlp_w2, float* part,
                   T* hid, int Q, int D, int Hl, GemmPlan plan, cudaStream_t stream) {
  cudaError_t err;
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{crs, D}, mlp_w1, D, Q, Hl, D,
                                EpiBias<T>{hid, Hl, mlp_b1, true}, plan, stream)));
  QT_TRY((planned_gemm<T, true>(RowLoad<T>{hid, Hl}, mlp_w2, Hl, Q, D, Hl,
                                qt::EpiF32<T>{part, D, nullptr}, plan, stream)));
  return plan.done();
}

#undef QT_CHECK
#undef QT_TRY

// outf [2 BT, D] fp32, the reduced MLP output: += mlp_b2 in place, then the
// per-stream LayerNorms as the single-rank kernel's last launch
template <typename T>
cudaError_t tp_out(float* outf, const T* mlp_b2, const T* anorm_w, const T* anorm_b,
                   const T* vnorm_w, const T* vnorm_b, T* a_out, T* v_out, int Q, int D,
                   cudaStream_t stream) {
  qt::reduce_epilogue_kernel<T, float><<<qt::ln_blocks(Q), qt::LN_WARPS * 32, 0, stream>>>(
      outf, Q, D, mlp_b2, nullptr, outf, nullptr, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qt::layer_norm_kernel<float, T><<<qt::ln_blocks(Q), qt::LN_WARPS * 32, 0, stream>>>(
      outf, Q, D, 2, vnorm_w, vnorm_b, v_out, anorm_w, anorm_b, a_out);
  return cudaGetLastError();
}

}  // namespace

#define QT_C(T, p) static_cast<const T*>(p)
// plan: `products` rows of (M, N, K, chunk, route), the launch's products in
// launch order (ops/gemm.py gemm_plan), route written here; attn: `attns`
// rows of (Sq, Sk, kernel), its attentions in launch order (ops/attention.py
// keep_rows), kernel written here; ws / ws_floats: the split-K workspace of
// the fp32 products (null / 0 where the plan splits none)
#define QT_PLAN \
  GemmPlan { plan, products, 0, static_cast<float*>(ws), ws_floats, attn, attns }
#define QT_DISPATCH(CALL)    \
  if (dtype == 0) {          \
    using T = float;         \
    return CALL;             \
  } else {                   \
    using T = __nv_bfloat16; \
    return CALL;             \
  }

extern "C" int qt_patch_select_tp_self(int dtype, const void* patch, const void* slf_w,
                                       const void* slf_b, const void* slf_ow, void* part,
                                       void* qkv, void* ctx, int BT, int P, int D, int Wl,
                                       int heads, int* plan, int products, int* attn, int attns,
                                       void* ws, long long ws_floats, void* stream) {
  QT_DISPATCH(tp_self<T>(QT_C(T, patch), QT_C(T, slf_w), QT_C(T, slf_b), QT_C(T, slf_ow),
                         static_cast<float*>(part), static_cast<T*>(qkv), static_cast<T*>(ctx),
                         BT, P, D, Wl, heads, QT_PLAN, static_cast<cudaStream_t>(stream)))
}

extern "C" int qt_patch_select_tp_cross(int dtype, const void* x1, const void* video,
                                        const void* audio, const void* crs_w, const void* crs_b,
                                        const void* crs_ow, void* part, void* kv, void* q,
                                        void* ctx2, int BT, int P, int D, int Wl, int heads,
                                        int* plan, int products, int* attn, int attns, void* ws,
                                        long long ws_floats, void* stream) {
  QT_DISPATCH(tp_cross<T>(QT_C(T, x1), QT_C(T, video), QT_C(T, audio), QT_C(T, crs_w),
                          QT_C(T, crs_b), QT_C(T, crs_ow), static_cast<float*>(part),
                          static_cast<T*>(kv), static_cast<T*>(q), static_cast<T*>(ctx2), BT, P,
                          D, Wl, heads, QT_PLAN, static_cast<cudaStream_t>(stream)))
}

extern "C" int qt_patch_select_tp_mlp(int dtype, const void* crs, const void* mlp_w1,
                                      const void* mlp_b1, const void* mlp_w2, void* part,
                                      void* hid, int Q, int D, int Hl, int* plan, int products,
                                      int* attn, int attns, void* ws, long long ws_floats,
                                      void* stream) {
  QT_DISPATCH(tp_mlp<T>(QT_C(T, crs), QT_C(T, mlp_w1), QT_C(T, mlp_b1), QT_C(T, mlp_w2),
                        static_cast<float*>(part), static_cast<T*>(hid), Q, D, Hl, QT_PLAN,
                        static_cast<cudaStream_t>(stream)))
}

extern "C" int qt_patch_select_tp_out(int dtype, void* outf, const void* mlp_b2,
                                      const void* anorm_w, const void* anorm_b,
                                      const void* vnorm_w, const void* vnorm_b, void* a_out,
                                      void* v_out, int Q, int D, void* stream) {
  QT_DISPATCH(tp_out<T>(static_cast<float*>(outf), QT_C(T, mlp_b2), QT_C(T, anorm_w),
                        QT_C(T, anorm_b), QT_C(T, vnorm_w), QT_C(T, vnorm_b),
                        static_cast<T*>(a_out), static_cast<T*>(v_out), Q, D,
                        static_cast<cudaStream_t>(stream)))
}

extern "C" int qt_patch_select(int dtype, const void* patch, const void* video,
                               const void* audio, const void* slf_w, const void* slf_b,
                               const void* slf_ow, const void* slf_ob, const void* crs_w,
                               const void* crs_b, const void* crs_ow, const void* crs_ob,
                               const void* mlp_w1, const void* mlp_b1, const void* mlp_w2,
                               const void* mlp_b2, const void* anorm_w, const void* anorm_b,
                               const void* vnorm_w, const void* vnorm_b, void* a_out,
                               void* v_out, void* qkv, void* ctx, void* x1, void* kv, void* q,
                               void* ctx2, void* crs, void* hid, void* outf, int BT, int P,
                               int D, int heads, int* plan, int products, int* attn, int attns,
                               void* ws, long long ws_floats, void* stream) {
#define QT_ARGS(T)                                                                            \
  static_cast<const T*>(patch), static_cast<const T*>(video), static_cast<const T*>(audio),    \
      static_cast<const T*>(slf_w), static_cast<const T*>(slf_b),                               \
      static_cast<const T*>(slf_ow), static_cast<const T*>(slf_ob),                             \
      static_cast<const T*>(crs_w), static_cast<const T*>(crs_b),                               \
      static_cast<const T*>(crs_ow), static_cast<const T*>(crs_ob),                             \
      static_cast<const T*>(mlp_w1), static_cast<const T*>(mlp_b1),                             \
      static_cast<const T*>(mlp_w2), static_cast<const T*>(mlp_b2),                             \
      static_cast<const T*>(anorm_w), static_cast<const T*>(anorm_b),                           \
      static_cast<const T*>(vnorm_w), static_cast<const T*>(vnorm_b), static_cast<T*>(a_out),   \
      static_cast<T*>(v_out), static_cast<T*>(qkv), static_cast<T*>(ctx), static_cast<T*>(x1),  \
      static_cast<T*>(kv), static_cast<T*>(q), static_cast<T*>(ctx2), static_cast<T*>(crs),     \
      static_cast<T*>(hid), static_cast<float*>(outf), BT, P, D, heads, QT_PLAN,                \
      static_cast<cudaStream_t>(stream)
  if (dtype == 0) return run<float>(QT_ARGS(float));
  return run<__nv_bfloat16>(QT_ARGS(__nv_bfloat16));
#undef QT_ARGS
}
