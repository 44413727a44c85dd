// attention_wide: multi-head softmax(q k^T * scale + mask + key_bias) v on
// dense heads-in-lanes [B, S, H*hd] tensors.
//
// Replaces qa_tiger_tpu/ops/pallas/attention.py:fused_attention_wide, all
// four bodies of its pl.pallas_call: _wide_nomask_kernel / _wide_kernel and
// the key_bias variants _wide_nomask_kb_kernel / _wide_kb_kernel (ToMe's
// proportional attention: a per-(batch element, key) fp32 bias, the log of
// the merged token sizes, added to every head's scores).
//
// Bound on the H100: bytes at the short shapes, operations at the long ones.
// At the AVQ shapes (q [512, 60, 512], k/v [512, 77, 512], hd 64) one head
// does 2 x 60 x 77 x 64 MACs against 2 x 60 x 64 + 2 x 77 x 64 bf16 values,
// about 30 operations per byte; at the ToMe and CLIP image shapes (Sq = Sk
// up to 577) it is about 280. The design reads q, k and v once per query
// tile and writes the context once, and never writes scores or
// probabilities to device memory. Keys up to 128 are staged whole in shared
// memory (one warp per query row); longer ones stream through shared memory
// in 64-key tiles in two passes over the keys (row max and sum, then the
// rounded probabilities and the context), register-tiled 64 x 64 per block.
// Both run on fp32 FMAs out of shared memory; that instruction stream, not
// HBM, is what limits this first version (PERF.md has its time beside the
// bound).
#include "common.cuh"

extern "C" const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int qt_attention(int dtype, const void* q, long long q_bs, long long q_ss,
                            const void* k, long long k_bs, long long k_ss, const void* v,
                            long long v_bs, long long v_ss, void* out, long long o_bs,
                            long long o_ss, const void* mask, const void* key_bias, int B,
                            int Sq, int Sk, int heads, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* kb = static_cast<const float*>(key_bias);
  if (dtype == 0)
    return qt::attention<float>(static_cast<const float*>(q), q_bs, q_ss,
                                static_cast<const float*>(k), k_bs, k_ss,
                                static_cast<const float*>(v), v_bs, v_ss,
                                static_cast<float*>(out), o_bs, o_ss, m, B, Sq, Sk, heads, hd,
                                scale, s, nullptr, 0, false, kb);
  using bf = __nv_bfloat16;
  return qt::attention<bf>(static_cast<const bf*>(q), q_bs, q_ss, static_cast<const bf*>(k),
                           k_bs, k_ss, static_cast<const bf*>(v), v_bs, v_ss,
                           static_cast<bf*>(out), o_bs, o_ss, m, B, Sq, Sk, heads, hd, scale, s,
                           nullptr, 0, false, kb);
}
