// Softmax attention, softmax(q k^T * scale + mask + key_bias) v, through the
// shared device code qt::attention (common.cuh). Two entries:
//
// qt_attention: attention_wide, multi-head on dense heads-in-lanes
// [B, S, H*hd] tensors. Replaces qa_tiger_tpu/ops/pallas/attention.py:
// fused_attention_wide, all four bodies of its pl.pallas_call:
// _wide_nomask_kernel / _wide_kernel and the key_bias variants
// _wide_nomask_kb_kernel / _wide_kb_kernel (ToMe's proportional attention: a
// per-(batch element, key) fp32 bias, the log of the merged token sizes,
// added to every head's scores).
//
// qt_fused_attention: fused_attention, classic head-split [BH, S, dh]
// tensors. Replaces both pl.pallas_calls of _pallas_impl in the same file:
// _kernel / _no_mask_kernel and _packed_kernel. That layout is
// attention_wide's with one head of width dh, so it runs the same device
// code with heads = 1 and BH batch elements. The packed route grouped 16
// tiny problems into one block-diagonal score matrix to fill the TPU's
// 128 x 128 matrix unit; in bf16 its problems (at most 16 queries and keys)
// take the short tensor-core kernel, one warp per problem and a 16 x 16
// score tile, which computes the same function without the masked blocks.
//
// Bound on the H100: bytes at the short shapes, operations at the long ones.
// At the AVQ shapes (q [512, 60, 512], k/v [512, 77, 512], hd 64) one head
// does 2 x 60 x 77 x 64 MACs against 2 x 60 x 64 + 2 x 77 x 64 bf16 values,
// about 30 operations per byte; at the text tower's [3072, 77, 64] about 38,
// at the packed route's [122880, 14, 64] about 7; at the ToMe and CLIP
// image shapes (Sq = Sk up to 577) about 280. The design reads q, k and v
// once per query tile and writes the context once, and never writes scores
// or probabilities to device memory. qt_attention_route names the kernel a
// call takes:
// - bf16 without a keep mask, head size 32, 64 or 128, at most 16 queries
//   and 16 keys (PatchSelecter's 14-key self- and cross-attention, the
//   packed route's [BH, 14, 64], QstGrounding's one query over 2 keys, the
//   last ToMe layers): route 2, "mma_short", one warp per (batch element,
//   head) problem on mma.sync, q, k and v brought in by cp.async through a
//   two-stage ring per warp, the context stored 16 bytes a lane;
// - the same at least 16 queries and 16 keys otherwise (every bf16 call of
//   the text tower, AVQ and ToMe's layers of at most 128 tokens): route 1,
//   "mma", q·kᵀ and p·v on mma.sync with fp32 accumulation, K and V streamed
//   by cp.async through a two-stage shared-memory ring in 64-key tiles; one
//   pass up to 128 keys, two beyond (row max and sum, then the rounded
//   probabilities and the context) at head sizes 32 and 128;
// - the same past 128 keys at head size 64 where sm90_faster holds (the
//   CLIP image tower's 577 tokens, ToMe's layers of 327-577 and 202-252
//   tokens): route 6, "wgmma", kernel "mma_sm90" of attention_sm90.cuh,
//   built here: TMA and wgmma, a persistent block per SM of two consumer
//   warpgroups and a producer warpgroup, the same two passes;
// - bf16 without a keep mask at head sizes 256 and 512 (TSPM's one-head
//   attentions; heads between 128 and 512 lanes zero-padded to them), both
//   streaming the head in 64-lane slabs through a cp.async ring: at most 16
//   queries and keys (TokensAttn) route 2, kernel "mma_wide_short", a warp
//   per problem; any other length (AV_Attn, 577 keys) route 1, kernel
//   "mma_wide", 64 query rows per block, the rounded probabilities in
//   shared memory (one pass up to 128 keys, two beyond), the context by
//   64-lane chunks;
// - a keep mask (the train kernels' dropout attentions, from csrc/avq.cu
//   and csrc/patch_select_train.cu; no call of this file's entries) at
//   head sizes 32, 64 and 128 over at most 128 keys, bf16 and fp32: route
//   3, "mma_keep", the keep-masked tensor-core kernel of
//   csrc/attention_keep.cu (its own entries qt_attention_keep and
//   qt_attention_keep_bwd run it alone);
// - fp32 without a keep mask at head sizes 32, 64 and 128, with or
//   without an additive mask or a key bias (the fp32 evaluation forward's
//   AVQ, TempMoE and QstGrounding calls, PatchSelecter's two; the fp32 text
//   towers' causal calls; ToMe's key-bias layers and the CLIP image tower),
//   and bf16 without a mask or key bias for fewer than 16 queries over more
//   than 16 keys (TempMoE's 1 x 60): route 4, "mma_nokeep", the same kernel
//   with its keep multiply compiled out (3xTF32 in fp32, a warp per problem
//   for one query), over at most 128 keys; past 128 keys (fp32 only) its
//   key-tiled form "mma_nokeep_tiled", 128 query rows a block, 64-key tiles
//   in two passes (the row max and sum, then p and p·v);
// - fp32 at head sizes 256 and 512 without a mask or key bias (TSPM's
//   one-head AV_Attn and TokensAttn in fp32): route 5, "tf32x3", kernel
//   "lane_split", the lane split's two 3xTF32 stages below at one rank, a
//   head at a time, its fp32 scores through a scratch the wrapper gives;
// - every other call (fp32 wide heads with a mask or key bias, fp32 at
//   other head sizes; a keep mask at other head sizes or longer keys; bf16
//   with fewer than 16 queries over more keys under a mask or key bias;
//   a wide head past ~1,500 keys in bf16): route 0, "fma", fp32 FMAs out
//   of shared memory: keys up to 128 staged whole where they fit the
//   block's shared memory (one warp per query row); else, at head sizes up
//   to 128, 64-key tiles in the same two passes, register-tiled 64 x 64 per
//   block; at head sizes 256 and 512 the wide-head kernel, 16 or 32-key
//   tiles in the same two passes.
// PERF.md has each route's time beside the bound.
#include "attention_sm90.cuh"
#include "attention_tp.cuh"

namespace qt {

static_assert(ATT_LANES_SMEM == TpScoresGeo<false>::SMEM &&
                  ATT_LANES_SMEM == TpScoresGeo<true>::SMEM &&
                  ATT_LANES_SMEM >= TpPvGeo<false>::SMEM && ATT_LANES_SMEM >= TpPvGeo<true>::SMEM,
              "the plan's lane-split shared memory is the stages' ring");

// The fp32 lane split at one rank, a head at a time: the head's fp32 scores
// [B, Sq, Sk] into scratch (tp_scores over its hd lanes, unscaled), then
// tp_pv's scale, softmax and p·v into its context lanes. Each head's pair
// of launches runs on the stream in order, so one scratch serves them all.
cudaError_t attention_lanes(KeepIn q, KeepIn k, KeepIn v, KeepOut out, int B, int Sq, int Sk,
                            int heads, int hd, float scale, float* scratch,
                            cudaStream_t stream) {
  if (!scratch) return cudaErrorInvalidValue;
  for (int h = 0; h < heads; ++h) {
    const long long col = (long long)h * hd;
    cudaError_t err = attention_tp_scores<float>(static_cast<const float*>(q.p) + col, q.bs,
                                                 q.ss, static_cast<const float*>(k.p) + col,
                                                 k.bs, k.ss, scratch, B, Sq, Sk, hd, stream);
    if (err != cudaSuccess) return err;
    err = attention_tp_pv<float>(scratch, static_cast<const float*>(v.p) + col, v.bs, v.ss,
                                 nullptr, static_cast<float*>(out.p) + col, out.bs, out.ss, B, Sq,
                                 Sk, hd, scale, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace qt

namespace {

template <typename T>
int run(const void* q, long long q_bs, long long q_ss, const void* k, long long k_bs,
        long long k_ss, const void* v, long long v_bs, long long v_ss, void* out,
        long long o_bs, long long o_ss, const void* mask, const void* key_bias, int B, int Sq,
        int Sk, int heads, int hd, float scale, int* kernel, void* scratch, void* stream) {
  return qt::attention<T>(static_cast<const T*>(q), q_bs, q_ss, static_cast<const T*>(k), k_bs,
                          k_ss, static_cast<const T*>(v), v_bs, v_ss, static_cast<T*>(out), o_bs,
                          o_ss, static_cast<const float*>(mask), B, Sq, Sk, heads, hd, scale,
                          static_cast<cudaStream_t>(stream), nullptr, 0, false,
                          static_cast<const float*>(key_bias), kernel,
                          static_cast<float*>(scratch));
}

}  // namespace

extern "C" const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// the kernel family qt::attention takes for such a call on the current
// device: 6 the Hopper kernel (wgmma: mma_sm90), 5 the lane split's 3xTF32
// stages (tf32x3), 4 the keep-masked
// kernel without a keep mask (mma_nokeep, mma_nokeep_tiled), 3 the
// keep-masked tensor-core kernel (mma_keep), 2 a tensor-core kernel with a
// warp per problem (mma_short, mma_wide_short), 1 one with 64 query rows
// per block (mma, mma_wide), 0 an FMA kernel; dtype 0 is float32, 1
// bfloat16; has_bias: an additive mask or a key bias
extern "C" int qt_attention_route(int dtype, int Sq, int Sk, int hd, int has_keep,
                                  int has_bias) {
  return qt::attention_kernel_route(qt::attention_plan(
      dtype == 1, Sq, Sk, hd, has_keep != 0, has_bias != 0, qt::smem_optin(), nullptr));
}

// the kernel of qt::attention_plan on the current device (-1 none, 0 staged,
// 1 tiled, 2 wide-head, 3 mma, 4 mma_short, 5 mma_wide, 6 mma_wide_short,
// 7 mma_keep, 8 mma_nokeep, 9 mma_nokeep_tiled, 10 lane_split, 11
// mma_sm90), its shared
// memory in *smem; ops/attention.py
// holds its own plan (attention_plan) against this one
extern "C" int qt_attention_plan(int dtype, int Sq, int Sk, int hd, int has_keep, int has_bias,
                                 long long* smem) {
  size_t bytes = 0;
  const int kernel = qt::attention_plan(dtype == 1, Sq, Sk, hd, has_keep != 0, has_bias != 0,
                                        qt::smem_optin(), &bytes);
  if (smem) *smem = (long long)bytes;
  return kernel;
}

// the kernel of qt::attention_bwd_plan on the current device (-1 none, 0
// staged: attention_bwd_kernel, 7 mma_keep), its shared memory in *smem;
// ops/attention.py holds attention_bwd_plan against it
extern "C" int qt_attention_bwd_plan(int dtype, int Sq, int Sk, int hd, int has_keep,
                                     long long* smem) {
  size_t bytes = 0;
  const int kernel =
      qt::attention_bwd_plan(dtype == 1, Sq, Sk, hd, has_keep != 0, qt::smem_optin(), &bytes);
  if (smem) *smem = (long long)bytes;
  return kernel;
}

// the current device's opt-in shared memory per block, in bytes
extern "C" int qt_smem_optin() { return (int)qt::smem_optin(); }

// the measurement switch of the Hopper kernel (qt::Sm90Mode): 0 the plan
// every call gets, 1 the plan leaves its calls on attention_mma_kernel, 2 it
// takes every head-64 length past 128 keys; returns the mode before
extern "C" int qt_attention_sm90_mode(int mode) {
  const int before = qt::attention_sm90_mode();
  qt::set_attention_sm90_mode(mode);
  return before;
}

// kernel (a host int, may be null): the AttentionKernel the call launched;
// scratch: fp32 [B, Sq, Sk] for the lane split's scores (null where the
// plan is another kernel)
extern "C" int qt_attention(int dtype, const void* q, long long q_bs, long long q_ss,
                            const void* k, long long k_bs, long long k_ss, const void* v,
                            long long v_bs, long long v_ss, void* out, long long o_bs,
                            long long o_ss, const void* mask, const void* key_bias, int B,
                            int Sq, int Sk, int heads, int hd, float scale, int* kernel,
                            void* scratch, void* stream) {
  auto fn = dtype == 0 ? &run<float> : &run<__nv_bfloat16>;
  return fn(q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, o_bs, o_ss, mask, key_bias, B, Sq,
            Sk, heads, hd, scale, kernel, scratch, stream);
}

// out is a contiguous [BH, Sq, dh]; q, k and v need unit stride along dh;
// scratch as qt_attention's
extern "C" int qt_fused_attention(int dtype, const void* q, long long q_bs, long long q_ss,
                                  const void* k, long long k_bs, long long k_ss, const void* v,
                                  long long v_bs, long long v_ss, void* out, const void* mask,
                                  int BH, int Sq, int Sk, int dh, float scale, void* scratch,
                                  void* stream) {
  auto fn = dtype == 0 ? &run<float> : &run<__nv_bfloat16>;
  return fn(q, q_bs, q_ss, k, k_bs, k_ss, v, v_bs, v_ss, out, (long long)Sq * dh, dh, mask,
            nullptr, BH, Sq, Sk, 1, dh, scale, nullptr, scratch, stream);
}

// attention_wide's tensor-parallel stages for one head split by lanes
// (qt::attention_tp_scores and qt::attention_tp_pv in attention_tp.cuh; the
// wrappers attention_wide_tp_scores and attention_wide_tp_pv in
// ops/attention.py). s is a contiguous fp32 [B, Sq, Sk]; q, k and v need
// unit stride along their W lanes.
extern "C" int qt_attention_tp_scores(int dtype, const void* q, long long q_bs, long long q_ss,
                                      const void* k, long long k_bs, long long k_ss, void* s,
                                      int B, int Sq, int Sk, int W, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(s);
  if (dtype == 0)
    return qt::attention_tp_scores<float>(static_cast<const float*>(q), q_bs, q_ss,
                                          static_cast<const float*>(k), k_bs, k_ss, out, B, Sq,
                                          Sk, W, st);
  return qt::attention_tp_scores<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(q), q_bs, q_ss,
                                                static_cast<const __nv_bfloat16*>(k), k_bs, k_ss,
                                                out, B, Sq, Sk, W, st);
}

extern "C" int qt_attention_tp_pv(int dtype, const void* s, const void* v, long long v_bs,
                                  long long v_ss, const void* mask, void* out, long long o_bs,
                                  long long o_ss, int B, int Sq, int Sk, int W, float scale,
                                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return qt::attention_tp_pv<float>(sc, static_cast<const float*>(v), v_bs, v_ss, m,
                                      static_cast<float*>(out), o_bs, o_ss, B, Sq, Sk, W, scale,
                                      st);
  return qt::attention_tp_pv<__nv_bfloat16>(sc, static_cast<const __nv_bfloat16*>(v), v_bs, v_ss,
                                            m, static_cast<__nv_bfloat16*>(out), o_bs, o_ss, B, Sq,
                                            Sk, W, scale, st);
}
