// The two residual halves of one CLIP pre-LN block:
//
//   attention half  y = x + out_proj(attn(ln_1(x)))      (h = ln_2(y))
//   MLP half        y = x + c_proj(QuickGELU(c_fc(ln_2(x))))
//
// qt_attn_ln2 (fused_attn_ln2) replaces qa_tiger_tpu/ops/pallas/resblock.py:
// _attn_ln2_impl (_attn_ln2_kernel -> _attn_core); qt_attn_half
// (fused_attn_half, and the first half of fused_resblock) replaces
// _attn_impl (_attn_kernel -> _attn_core), the same body without h;
// qt_mlp_half (the second half of fused_resblock) replaces _mlp_impl
// (_mlp_kernel).
//
// Bound on the H100: operations. Per text-tower layer at B=256, S=77,
// W=768 the qkv and output projections are 8*B*S*W^2 = 93 GFLOP against
// ~100 MB of x, y, h and weights; the MLP half's two GEMMs 16*B*S*W^2 =
// 186 GFLOP against ~70 MB of x, y and weights. The attention half is four
// launches (five with h), all written here:
//   1. ln_1: round_T(ln_1(x)) written to the ctx scratch, which the
//      attention overwrites only after step 2 has read it (bf16 on gemm_tile,
//      where gemm_route does not give wgmma: the row statistics of x, mean
//      and 1/std, which gemm_tile's A load applies, LnRowLoad);
//   2. GEMM against in_proj [3W, W], plus bias -> qkv: in bf16 gemm_sm90
//      (gemm_sm90.cuh: TMA + wgmma) on the staged rows; in fp32 gemm_tf32x3
//      (gemm_tf32x3.cuh: 3xTF32 on TMA + wgmma) on the staged rows,
//      which hold what LnRowLoad computes ((x - mean) * rstd * w + b from
//      the same row_moments: round_T is the identity in fp32);
//   3. the attention of qt::attention (common.cuh; the text towers' causal
//      mask, the image tower's none), reading q, k and v as column slices
//      of qkv -> ctx; in fp32 on 3xTF32 ("mma_nokeep" up to 128 keys,
//      "mma_nokeep_tiled" past that);
//   4. GEMM against out_proj plus bias plus the residual -> y (gemm_sm90 in
//      bf16, gemm_tf32x3 in fp32);
//   5. (qt_attn_ln2 only) ln_2 over y -> h.
// In fp32 both products go through qt::planned_gemm against the plan the
// wrapper built (ops/gemm.py gemm_plan of attn_gemm_shapes), which reads
// back each product's route; a product the plan does not name, or that
// gemm_tf32x3 refuses, returns an error: nothing falls back to gemm_tile
// (whose FMA loop ran the CLIP image tower's fp32 block at 48 ms, 4.3x its
// FMA-peak bound, PERF.md), and the attention writes the kernel it launched
// into the plan's attention row (GemmPlan::attention). A bf16 launch gets
// an empty plan: no product rows, no attention row.
// The MLP half (fused_resblock, on no model path) is three launches, all
// written here; its fp32 products stay on gemm_tile's FMA loop:
//   1. ln_2: in bf16 (the wgmma route) round_T(ln_2(x)) written to y, which
//      step 3 overwrites only after step 2 has read it; in fp32 the row
//      statistics of x;
//   2. GEMM against c_fc [4W, W] plus bias, QuickGELU on the fp32 value,
//      rounded once -> hidden: in bf16 gemm_sm90 on the staged rows; in
//      fp32 gemm_tile's FMA loop, whose A load applies ln_2 (the same
//      expression, rounded);
//   3. GEMM against c_proj [W, 4W] plus bias plus the residual -> y
//      (gemm_sm90 in bf16, gemm_tile in fp32).
// Under tensor parallelism (parallel/tensor.py) the attention half splits at
// its all-reduce into two launches per rank (qt_attn_ln2_partial and the
// post-reduce qt_reduce_epilogue; JAX's GSPMD gathers around the Pallas
// call instead, so this split has no Pallas counterpart):
//   partial: steps 1-4 above on the rank's heads: ln_1 on the whole row,
//     the qkv GEMM against the rank's [3 Wl, W] head rows (Wl = W / tp:
//     q, k and v rows of its heads), the attention over heads / tp heads
//     with q/k/v row strides 3 Wl, and the out-projection over K = Wl into
//     an fp32 [M, W] partial (EpiF32 with no bias, no residual), planned as
//     the single-rank launch is;
//   post-reduce (after the caller summed the partials over the model
//     ranks): y = x + round_T(sum + b_out), EpiResidual's rounding, and
//     h = ln_2(y), one warp per row (common.cuh reduce_epilogue_kernel).
// The partial moves the same x and writes an fp32 [M, W] instead of y and
// h; its products are 1/tp of the single-rank ones.
// The Pallas kernels kept qkv, ctx and the MLP hidden [rows, 4W] in VMEM;
// here each makes one round trip through HBM (2 x 3W + 2 x W values per row
// in the attention half, ~240 MB per layer at B=256 in bf16; 2 x 4W in the
// MLP half, ~240 MB). At the card's peak rates that traffic would take about
// as long as the GEMMs themselves, so keeping it on chip is the first thing
// a faster version needs.
#include "gemm_tf32x3.cuh"

namespace {

using qt::GemmPlan;

#define QT_TRY(call)                                 \
  if ((err = (call)) != cudaSuccess) return err

// qkv [M, N] (N = 3 Wl: the q, k and v rows of wqkv [N, W]) = ln_1(x)
// wqkv^T + bqkv: in fp32 ln_1 staged into ctx and the product planned on
// gemm_tf32x3; in bf16 ln_1 staged and gemm_sm90 where gemm_route gives
// wgmma, else gemm_tile with ln_1 in its A load (the row stats in stats)
template <typename T>
cudaError_t ln_qkv(const T* x, const T* ln1w, const T* ln1b, const T* wqkv, const T* bqkv,
                   T* qkv, T* ctx, float* stats, int M, int N, int W, GemmPlan& plan,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const qt::EpiBias<T> to_qkv{qkv, (long long)N, bqkv, false};
  if (!kBf16 || qt::gemm_route(kBf16, M, N, W) == qt::GEMM_ROUTE_WGMMA) {
    qt::layer_norm_kernel<T, T><<<qt::ln_blocks(M), qt::LN_WARPS * 32, 0, stream>>>(
        x, M, W, 1, ln1w, ln1b, ctx, nullptr, nullptr, nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if constexpr (kBf16)
      return qt::gemm_rows<T>(ctx, W, wqkv, W, M, N, W, to_qkv, stream);
    else
      return qt::planned_gemm<T, true>(qt::RowLoad<T>{ctx, W}, wqkv, W, M, N, W, to_qkv, plan,
                                       stream);
  }
  float* mean = stats;
  float* rstd = stats + M;
  qt::row_stats_kernel<T><<<qt::ln_blocks(M), qt::LN_WARPS * 32, 0, stream>>>(x, W, M, W, mean,
                                                                               rstd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qt::gemm<T, true>(qt::LnRowLoad<T>{x, W, mean, rstd, ln1w, ln1b}, wqkv, W, M, N, W, to_qkv,
                    stream);
  return cudaGetLastError();
}

// C = ctx [M, K] wout [N, K]^T through epi: planned on gemm_tf32x3 in fp32,
// gemm_rows (gemm_sm90 or gemm_tile) in bf16
template <typename T, class Epi>
cudaError_t out_proj(const T* ctx, int K, const T* wout, int M, int N, const Epi& epi,
                     GemmPlan& plan, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return qt::gemm_rows<T>(ctx, K, wout, K, M, N, K, epi, stream);
  else
    return qt::planned_gemm<T, true>(qt::RowLoad<T>{ctx, K}, wout, K, M, N, K, epi, plan, stream);
}

// h, ln2w and ln2b null: the attention half alone (no fifth launch)
template <typename T>
cudaError_t attn(const T* x, const T* ln1w, const T* ln1b, const T* wqkv, const T* bqkv,
                 const T* wout, const T* bout, const T* ln2w, const T* ln2b, const float* mask,
                 T* y, T* h, T* qkv, T* ctx, float* stats, int B, int S, int W, int heads,
                 GemmPlan plan, cudaStream_t stream) {
  const int M = B * S, hd = W / heads;
  cudaError_t err;
  QT_TRY(ln_qkv<T>(x, ln1w, ln1b, wqkv, bqkv, qkv, ctx, stats, M, 3 * W, W, plan, stream));
  const long long bs = 3LL * S * W;
  QT_TRY(qt::attention<T>(qkv, bs, 3LL * W, qkv + W, bs, 3LL * W, qkv + 2 * W, bs, 3LL * W, ctx,
                          (long long)S * W, W, mask, B, S, S, heads, hd,
                          1.0f / sqrtf((float)hd), stream, nullptr, 0, false, nullptr,
                          plan.attn_count ? plan.attention(S, S) : nullptr));
  QT_TRY(out_proj<T>(ctx, W, wout, M, W, qt::EpiResidual<T>{y, W, bout, x, W}, plan, stream));
  if (h) {
    qt::layer_norm_kernel<T, T><<<qt::ln_blocks(M), qt::LN_WARPS * 32, 0, stream>>>(
        y, M, W, 1, ln2w, ln2b, h, nullptr, nullptr, nullptr);
    QT_TRY(cudaGetLastError());
  }
  return plan.done();
}

// The tensor-parallel partial of the attention half: wqkv [3 Wl, W] and bqkv
// [3 Wl] the rank's head rows (q, k, v), wout [W, Wl] its columns of
// out_proj; part [M, W] fp32 = ctx_rank out_proj_rank^T. qkv [M, 3 Wl] and
// ctx [M, W] scratch (ctx holds the staged ln_1 rows first).
template <typename T>
cudaError_t attn_partial(const T* x, const T* ln1w, const T* ln1b, const T* wqkv,
                         const T* bqkv, const T* wout, const float* mask, float* part, T* qkv,
                         T* ctx, float* stats, int B, int S, int W, int Wl, int heads,
                         GemmPlan plan, cudaStream_t stream) {
  const int M = B * S, hd = Wl / heads;
  cudaError_t err;
  QT_TRY(ln_qkv<T>(x, ln1w, ln1b, wqkv, bqkv, qkv, ctx, stats, M, 3 * Wl, W, plan, stream));
  const long long bs = 3LL * S * Wl;
  QT_TRY(qt::attention<T>(qkv, bs, 3LL * Wl, qkv + Wl, bs, 3LL * Wl, qkv + 2 * Wl, bs, 3LL * Wl,
                          ctx, (long long)S * Wl, Wl, mask, B, S, S, heads, hd,
                          1.0f / sqrtf((float)hd), stream, nullptr, 0, false, nullptr,
                          plan.attn_count ? plan.attention(S, S) : nullptr));
  QT_TRY(out_proj<T>(ctx, Wl, wout, M, W, qt::EpiF32<T>{part, W, nullptr}, plan, stream));
  return plan.done();
}

#undef QT_TRY

// y doubles as the bf16 route's ln_2 scratch; stats serves the fp32 route
template <typename T>
cudaError_t mlp(const T* x, const T* ln2w, const T* ln2b, const T* wfc, const T* bfc,
                const T* wpj, const T* bpj, T* y, T* hidden, float* stats, int M, int W,
                int Hd, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const qt::EpiBiasQuickGelu<T> to_hidden{hidden, Hd, bfc};
  cudaError_t err;
  if (qt::gemm_route(kBf16, M, Hd, W) == qt::GEMM_ROUTE_WGMMA) {
    qt::layer_norm_kernel<T, T><<<qt::ln_blocks(M), qt::LN_WARPS * 32, 0, stream>>>(
        x, M, W, 1, ln2w, ln2b, y, nullptr, nullptr, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = qt::gemm_rows<T>(y, W, wfc, W, M, Hd, W, to_hidden, stream);
  } else {
    float* mean = stats;
    float* rstd = stats + M;
    qt::row_stats_kernel<T><<<qt::ln_blocks(M), qt::LN_WARPS * 32, 0, stream>>>(x, W, M, W,
                                                                                 mean, rstd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    qt::gemm<T, true>(qt::LnRowLoad<T>{x, W, mean, rstd, ln2w, ln2b}, wfc, W, M, Hd, W,
                      to_hidden, stream);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return qt::gemm_rows<T>(hidden, Hd, wpj, Hd, M, W, Hd, qt::EpiResidual<T>{y, W, bpj, x, W},
                          stream);
}

}  // namespace

#define QT_P(T, p) static_cast<const T*>(p)
// plan: `products` rows of (M, N, K, chunk, route), the fp32 launch's two
// products (ops/gemm.py gemm_plan), route written here; attn_rows: `attns`
// rows of (Sq, Sk, kernel), its one attention (ops/attention.py keep_rows),
// kernel written here; ws / ws_floats: the split-K workspace (null / 0 where
// the plan splits none). A bf16 launch passes only its attention row.
#define QT_PLAN \
  GemmPlan { plan, products, 0, static_cast<float*>(ws), ws_floats, attn_rows, attns }
#define QT_DISPATCH(CALL)                   \
  if (dtype == 0) {                         \
    using T = float;                        \
    return CALL;                            \
  } else {                                  \
    using T = __nv_bfloat16;                \
    return CALL;                            \
  }

extern "C" int qt_attn_ln2(int dtype, const void* x, const void* ln1w, const void* ln1b,
                           const void* wqkv, const void* bqkv, const void* wout,
                           const void* bout, const void* ln2w, const void* ln2b,
                           const void* mask, void* y, void* h, void* qkv, void* ctx,
                           void* stats, int B, int S, int W, int heads, int* plan, int products,
                           int* attn_rows, int attns, void* ws, long long ws_floats, void* stream) {
  QT_DISPATCH(attn<T>(QT_P(T, x), QT_P(T, ln1w), QT_P(T, ln1b), QT_P(T, wqkv), QT_P(T, bqkv),
                      QT_P(T, wout), QT_P(T, bout), QT_P(T, ln2w), QT_P(T, ln2b),
                      static_cast<const float*>(mask), static_cast<T*>(y), static_cast<T*>(h),
                      static_cast<T*>(qkv), static_cast<T*>(ctx), static_cast<float*>(stats), B,
                      S, W, heads, QT_PLAN, static_cast<cudaStream_t>(stream)))
}

extern "C" int qt_attn_half(int dtype, const void* x, const void* ln1w, const void* ln1b,
                            const void* wqkv, const void* bqkv, const void* wout,
                            const void* bout, const void* mask, void* y, void* qkv, void* ctx,
                            void* stats, int B, int S, int W, int heads, int* plan, int products,
                            int* attn_rows, int attns, void* ws, long long ws_floats,
                            void* stream) {
  QT_DISPATCH(attn<T>(QT_P(T, x), QT_P(T, ln1w), QT_P(T, ln1b), QT_P(T, wqkv), QT_P(T, bqkv),
                      QT_P(T, wout), QT_P(T, bout), nullptr, nullptr,
                      static_cast<const float*>(mask), static_cast<T*>(y), nullptr,
                      static_cast<T*>(qkv), static_cast<T*>(ctx), static_cast<float*>(stats), B,
                      S, W, heads, QT_PLAN, static_cast<cudaStream_t>(stream)))
}

extern "C" int qt_attn_ln2_partial(int dtype, const void* x, const void* ln1w, const void* ln1b,
                                   const void* wqkv, const void* bqkv, const void* wout,
                                   const void* mask, void* part, void* qkv, void* ctx,
                                   void* stats, int B, int S, int W, int Wl, int heads, int* plan,
                                   int products, int* attn_rows, int attns, void* ws,
                                   long long ws_floats, void* stream) {
  QT_DISPATCH(attn_partial<T>(QT_P(T, x), QT_P(T, ln1w), QT_P(T, ln1b), QT_P(T, wqkv),
                              QT_P(T, bqkv), QT_P(T, wout), static_cast<const float*>(mask),
                              static_cast<float*>(part), static_cast<T*>(qkv),
                              static_cast<T*>(ctx), static_cast<float*>(stats), B, S, W, Wl,
                              heads, QT_PLAN, static_cast<cudaStream_t>(stream)))
}

// The post-reduce epilogue of a row-parallel product (common.cuh
// reduce_epilogue_kernel): sum [rows, D] fp32 reduced over the model ranks;
// bias [D], res [rows, D] (may be null), out [rows, D] of type T, or fp32
// when out_f32 (then it may alias sum); ln_w/ln_b [D] and h [rows, D] (null:
// no LayerNorm). dtype is T's.
extern "C" int qt_reduce_epilogue(int dtype, int out_f32, const void* sum, const void* bias,
                                  const void* res, void* out, const void* ln_w,
                                  const void* ln_b, void* h, int rows, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(sum);
#define QT_EPI(TO)                                                                         \
  qt::reduce_epilogue_kernel<T, TO><<<qt::ln_blocks(rows), qt::LN_WARPS * 32, 0, st>>>(    \
      s, rows, D, QT_P(T, bias), QT_P(T, res), static_cast<TO*>(out), QT_P(T, ln_w),       \
      QT_P(T, ln_b), static_cast<T*>(h))
  if (dtype == 0) {
    using T = float;
    QT_EPI(float);
  } else if (out_f32) {
    using T = __nv_bfloat16;
    QT_EPI(float);
  } else {
    using T = __nv_bfloat16;
    QT_EPI(T);
  }
#undef QT_EPI
  return cudaGetLastError();
}

// x and y [rows, W], hidden [rows, Hd] scratch, stats [2, rows] fp32 scratch;
// c_fc [Hd, W] and c_proj [W, Hd] in torch's Linear layout
extern "C" int qt_mlp_half(int dtype, const void* x, const void* ln2w, const void* ln2b,
                           const void* wfc, const void* bfc, const void* wpj, const void* bpj,
                           void* y, void* hidden, void* stats, int rows, int W, int Hd,
                           void* stream) {
  QT_DISPATCH(mlp<T>(QT_P(T, x), QT_P(T, ln2w), QT_P(T, ln2b), QT_P(T, wfc), QT_P(T, bfc),
                     QT_P(T, wpj), QT_P(T, bpj), static_cast<T*>(y), static_cast<T*>(hidden),
                     static_cast<float*>(stats), rows, W, Hd, static_cast<cudaStream_t>(stream)))
}

// which GEMM routine a fused kernel takes for one [M, K] x [N, K] product:
// 0 gemm_tile's fp32 FMA loop, 1 gemm_tile's WMMA loop, 2 gemm_sm90; dtype 0
// is float32, 1 bfloat16 (gemm_sm90.cuh, gemm_route)
extern "C" int qt_gemm_route(int dtype, int M, int N, int K) {
  return qt::gemm_route(dtype == 1, M, N, K);
}

// gemm_sm90 alone, bf16: C = A B^T, A [M, K] (row stride lda), B [N, K]
// (row stride ldb), through one epilogue: 0 EpiBias (out bf16 [M, N] row
// stride ldo, bias may be null, relu 0/1), 1 EpiResidual (out = res +
// round(acc + bias)), 2 EpiF32 (out fp32 = acc + bias)
extern "C" int qt_gemm_sm90(int epilogue, const void* a, long long lda, const void* b,
                            long long ldb, void* out, long long ldo, const void* bias,
                            const void* res, long long ldr, int relu, int M, int N, int K,
                            void* stream) {
  using bf16 = __nv_bfloat16;
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const bf16* bi = static_cast<const bf16*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0:
      return qt::gemm_sm90(A, lda, B, ldb, M, N, K,
                           qt::EpiBias<bf16>{static_cast<bf16*>(out), ldo, bi, relu != 0}, st);
    case 1:
      return qt::gemm_sm90(A, lda, B, ldb, M, N, K,
                           qt::EpiResidual<bf16>{static_cast<bf16*>(out), ldo, bi,
                                                 static_cast<const bf16*>(res), ldr},
                           st);
    case 2:
      return qt::gemm_sm90(A, lda, B, ldb, M, N, K,
                           qt::EpiF32<bf16>{static_cast<float*>(out), ldo, bi}, st);
    default:
      return cudaErrorInvalidValue;
  }
}
