// attention_wide: multi-head softmax(q k^T * scale + mask) v on dense
// heads-in-lanes [B, S, H*hd] tensors.
//
// Replaces qa_tiger_tpu/ops/pallas/attention.py:fused_attention_wide
// (_wide_nomask_kernel / _wide_kernel, body _wide_body), without its
// key_bias variants.
//
// Bound on the H100: bytes. At the AVQ shapes (q [512, 60, 512],
// k/v [512, 77, 512], hd 64) one head does 2 x 60 x 77 x 64 MACs (q k^T and
// p v) against 2 x 60 x 64 + 2 x 77 x 64 bf16 values read and written, about
// 30 operations per byte, far below the ~295 the tensor cores need per byte
// of HBM. The design therefore reads q, k and v once each and writes the
// context once: a block owns one (batch element, head, query tile), stages
// K_h and V_h in shared memory, and never writes scores or probabilities to
// device memory. The products run on fp32 FMAs out of shared memory, one
// warp per query row; that instruction stream, not HBM, is what limits this
// first version (PERF.md has its time beside the bound).
#include "common.cuh"

extern "C" const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int qt_attention(int dtype, const void* q, long long q_bs, long long q_ss,
                            const void* k, long long k_bs, long long k_ss, const void* v,
                            long long v_bs, long long v_ss, void* out, long long o_bs,
                            long long o_ss, const void* mask, int B, int Sq, int Sk,
                            int heads, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return qt::attention<float>(static_cast<const float*>(q), q_bs, q_ss,
                                static_cast<const float*>(k), k_bs, k_ss,
                                static_cast<const float*>(v), v_bs, v_ss,
                                static_cast<float*>(out), o_bs, o_ss, m, B, Sq, Sk, heads, hd,
                                scale, s);
  using bf = __nv_bfloat16;
  return qt::attention<bf>(static_cast<const bf*>(q), q_bs, q_ss, static_cast<const bf*>(k),
                           k_bs, k_ss, static_cast<const bf*>(v), v_bs, v_ss,
                           static_cast<bf*>(out), o_bs, o_ss, m, B, Sq, Sk, heads, hd, scale, s);
}
