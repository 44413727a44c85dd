// ---------------------------------------------------------------------------
// The keep-masked (dropout) attention on tensor cores, forward and backward
// (kernel "mma_keep"): the attentions inside the two train kernels,
// fused_avq_train (csrc/avq.cu: question-guided, self and cross attention)
// and fused_patch_select_train (csrc/patch_select_train.cu: the 14-patch
// self-attention and the two one-query cross attentions), forward and
// backward, and their tensor-parallel stage forms. They replace, for this
// card, the attention bodies of those Pallas kernels:
// qa_tiger_tpu/ops/pallas/avq.py _attn_fwd (:123) and _attn_bwd (:182),
// and qa_tiger_tpu/ops/pallas/patch_select.py _packed_heads_attn(keep2d=)
// (:129, the body of _kernel_train :387) with the backward _kernel_bwd
// recomputes. The callers reach them through qt::attention and
// qt::attention_bwd (common.cuh), which launch them where attention_plan /
// attention_bwd_plan choose them: a keep mask, head size 32, 64 or 128, at
// most ATT_KEEP_MAX_SK keys, shared memory within the card's limit. Every
// other keep-masked call stays on the FMA kernels (attention_kernel,
// attention_bwd_kernel) by the plan; nothing falls back after a launch.
//
// The forward without a keep mask (kernel "mma_nokeep", the keep multiply
// compiled out) is attention_wide's body on the same tensor cores:
// qa_tiger_tpu/ops/pallas/attention.py _wide_body (:202, the pallas_call
// :351, with the key-bias bodies :247 and :253), which rounds as _attn_fwd
// does with keep = 1. qt::attention takes it for every fp32 call at these
// head sizes and keys, an additive mask and a key bias added to the scaled
// scores before the row max (the fp32 evaluation forward's AVQ, TempMoE and
// QstGrounding calls, fused_patch_select's two, and their tensor-parallel
// stages; the fp32 text towers' causal calls inside fused_attn_ln2; the
// ToMe layers of at most 128 tokens), and for the bf16 calls of fewer than
// 16 queries over more keys, without a mask or key bias, that no other
// tensor-core kernel takes (TempMoE's one query over 60). Past 128 keys
// its fp32 key-tiled form takes the call ("mma_nokeep_tiled": the CLIP
// image tower's 577 keys, the long ToMe layers): 128 query rows a block,
// the keys in 64-key tiles through a two-stage cp.async ring, two passes
// (the row max and sum, then p and p·v), as attention_mma_kernel orders
// them in bf16.
//
// The op, per (batch element, head) problem, as the Pallas bodies round it:
//   s = (q kᵀ) * scale, scaled after the product; max, exp, sum in fp32;
//   pd = round_T(p' keep), p' = p (AVQ) or round_T(p) (PatchSelecter:
//   round_p_first); ctx = round_T(pd v);
//   backward, the probabilities recomputed from q and k as above:
//   dPd = g vᵀ; dP = dPd keep; dS = round_T(p' (dP - rowsum(dP p')));
//   dq = round_T(scale dS k); dk = round_T(scale dSᵀ q); dv = round_T(pdᵀ g);
//   accumulate_kv: dk, dv = round_T(out + round_T(new)).
//
// Bound on the H100: bytes. At the recipe's shapes (8 heads of 64 lanes; AVQ
// 60 queries over 60 or 77 keys, PatchSelecter 14 x 14 and 1 x 14) a problem
// does 4 Sq Sk hd operations forward and 10 backward on (3-4) x S x hd
// values plus an Sq x Sk keep mask: 7-40 operations per byte in fp32
// against 3xTF32's ridge of ~50 (494.7 / 3 TFLOP/s over 3.35 TB/s). So the
// design reads each operand once, keeps scores, probabilities and their
// gradients on chip, and puts every product on the tensor cores:
// - a warp owns 16 query rows over all the problem's keys (up to 128, in
//   16-key steps): the scores and, backward, dPd stay in mma fragments in
//   registers; softmax, the keep multiply and its rounding run on the
//   fragments (the row max and sum are shuffles over the four lanes of a
//   row); pd (forward) and dS (backward, for dq) feed the next product from
//   registers, converted from C to A fragments in place;
// - at most 16 queries and keys (PatchSelecter's calls: 15,360 problems of
//   14 x 14 or 1 x 14) each warp owns a whole problem, four a block
//   ("short" form); without a keep mask, at most 16 queries over more keys
//   the forward gives a warp the whole problem too, one warp a block (the
//   "warp" form: TempMoE's one query over 60 keys, where a 64-row block
//   would leave three of its four warps idle); otherwise a block of four
//   warps owns 64
//   query rows of a problem forward, the whole problem backward ("long"
//   form, AVQ);
// - q, k, v (and g) come in by 16-byte cp.async copies into rows padded by
//   16 bytes, read with ldmatrix (bf16) or as scalar fragments (fp32)
//   without bank conflicts; the keep mask is read straight from device
//   memory into the fragments' registers (its rows sit at lane h * Sk of a
//   row padded to 128 lanes, so they are not 16-byte aligned at Sk = 77 and
//   could not feed cp.async unchanged);
// - backward, each warp writes its rows' dS and pd to shared memory; once
//   every row is in, dk = dSᵀ q and dv = pdᵀ g run by 16-key tiles, each
//   tile's sum over all query rows in one warp in a fixed order: no atomics,
//   and a launch repeats bitwise;
// - bf16 on mma.sync m16n8k16 (fp32 sums); fp32 as 3xTF32 on m16n8k8 (hi/lo
//   splits, lo·hi + hi·lo + hi·hi), never single-pass TF32. The split is a
//   truncation (ak_split: a mask and a subtraction; cvt.rna's conversions
//   made the first build's fp32 products conversion-bound, PERF.md §6),
//   and each pass runs over four tiles before the next, so that no mma
//   waits on the one before it. Where an A
//   operand comes from C fragments (pd, dS) or is read transposed (dSᵀ, pdᵀ),
//   the k slots of an 8-step are permuted (slot t is element 2t, slot t + 4
//   element 2t + 1) on both operands, as attention_tp.cuh's pv stage does.
// Blocks are not persistent: several fit an SM (attention_keep_smem_bytes
// and attention_keep_bwd_smem_bytes give each shape's shared memory), and
// the resident blocks overlap one another's copies with their products.
//
// Needs 16-byte aligned q, k, v, g and outputs whose batch and row strides
// are whole 16 bytes, and no additive mask or key bias beside a keep mask
// or in bf16; a call that breaks that returns cudaErrorInvalidValue (the
// train kernels' buffers always qualify; attention_wide's wrapper copies an
// operand that does not).
// ---------------------------------------------------------------------------
#include <initializer_list>

#include "common.cuh"

namespace qt {
namespace {

// rows [0, rows) of a head's slice (row stride ss) into dst [rows][LD], zero
// from row n on; nthr threads share the copy, this one being tid
template <typename T, int HD>
__device__ __forceinline__ void ak_load(T* dst, const T* __restrict__ src, long long ss, int rows,
                                        int n, int tid, int nthr) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(T)), PER = 16 / (int)sizeof(T), C = HD / PER;
  for (int i = tid; i < rows * C; i += nthr) {
    const int r = i / C, c = (i % C) * PER;
    const bool in = r < n;
    cp_async16(dst + r * LD + c, in ? src + (long long)r * ss + c : src, in);
  }
}

// s += the scores of a warp's 16 rows (Qw) against nks 16-key steps of K
// (Ks), both [*][LD]. A thread's fragment s[j][e] is row g + 8 (e / 2) and
// key 8 j + 2 t + e % 2 (g = lane / 4, t = lane % 4).
template <int HD, int KS>
__device__ __forceinline__ void ak_qk(float (&s)[2 * KS][4], const __nv_bfloat16* Qw,
                                      const __nv_bfloat16* Ks, int nks, int lane) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(__nv_bfloat16));
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, Qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks < nks) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * ks], a, b[0], b[1]);
        mma_bf16(s[2 * ks + 1], a, b[2], b[3]);
      }
    }
  }
}

// x = hi + lo exactly: hi the tf32 truncation of x (its low 13 mantissa
// bits cleared, one integer op), lo the fp32 rest, which the tensor core
// reads as tf32 (it ignores the low 13 bits). Two ALU ops where cvt.rna
// takes two conversions and a subtraction; per product the error stays
// about 2^-19 of |x y| (the dropped lo·lo and lo's truncation).
__device__ __forceinline__ void ak_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[j] += a b[j] for the first n of AK_GROUP tiles in 3xTF32 (lo·hi, hi·lo,
// hi·hi), each pass over the group's tiles, so that no two neighbouring
// mma.sync write one accumulator
constexpr int AK_GROUP = 4;

__device__ __forceinline__ void ak_mma3(float (*c)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const uint32_t (&bh)[AK_GROUP][2],
                                        const uint32_t (&bl)[AK_GROUP][2], int n) {
#pragma unroll
  for (int j = 0; j < AK_GROUP; ++j)
    if (j < n) mma_tf32(c[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < AK_GROUP; ++j)
    if (j < n) mma_tf32(c[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < AK_GROUP; ++j)
    if (j < n) mma_tf32(c[j], ah, bh[j]);
}

// the same in fp32, 3xTF32, AK_GROUP key tiles at a time
template <int HD, int KS>
__device__ __forceinline__ void ak_qk(float (&s)[2 * KS][4], const float* Qw, const float* Ks,
                                      int nks, int lane) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(float));
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ah[4], al[4];
    ak_split(Qw[g * LD + kk + t], ah[0], al[0]);
    ak_split(Qw[(g + 8) * LD + kk + t], ah[1], al[1]);
    ak_split(Qw[g * LD + kk + t + 4], ah[2], al[2]);
    ak_split(Qw[(g + 8) * LD + kk + t + 4], ah[3], al[3]);
#pragma unroll
    for (int j0 = 0; j0 < 2 * KS; j0 += AK_GROUP) {
      if (j0 >= 2 * nks) continue;
      const int n = min(AK_GROUP, 2 * nks - j0);
      uint32_t bh[AK_GROUP][2], bl[AK_GROUP][2];
#pragma unroll
      for (int j = 0; j < AK_GROUP; ++j) {
        if (j >= n) continue;
        ak_split(Ks[(8 * (j0 + j) + g) * LD + kk + t], bh[j][0], bl[j][0]);
        ak_split(Ks[(8 * (j0 + j) + g) * LD + kk + t + 4], bh[j][1], bl[j][1]);
      }
      ak_mma3(s + j0, ah, al, bh, bl, n);
    }
  }
}

// o += p X over nks 16-key steps: p a warp's 16 rows in ak_qk's fragment
// layout (A from registers), X [key][lane] ([*][LD]: V, or K for dq). A
// thread's o[n][e] is row g + 8 (e / 2) and lane 8 n + 2 t + e % 2.
template <int HD, int KS>
__device__ __forceinline__ void ak_pv(float (&o)[HD / 8][4], const float (&p)[2 * KS][4],
                                      const __nv_bfloat16* Xs, int nks, int lane) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(__nv_bfloat16));
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < nks) {
      // p holds values rounded to bf16 already, so the packing is exact
      const uint32_t pa[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                              pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                              pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                              pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Xs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }
}

// the same in fp32, 3xTF32: k slot t is key 2 t, slot t + 4 key 2 t + 1 of
// each 8, on both operands; AK_GROUP lane tiles at a time
template <int HD>
__device__ __forceinline__ void ak_lanes3(float (&o)[HD / 8][4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const float* x0, int LD) {
  // x0: row 2t of this 8-step, lane g; the B fragments (k slot t, t + 4)
  // of lane tile n at x0[8 n] and x0[LD + 8 n]
#pragma unroll
  for (int n0 = 0; n0 < HD / 8; n0 += AK_GROUP) {
    uint32_t bh[AK_GROUP][2], bl[AK_GROUP][2];
#pragma unroll
    for (int n = 0; n < AK_GROUP; ++n) {
      ak_split(x0[8 * (n0 + n)], bh[n][0], bl[n][0]);
      ak_split(x0[LD + 8 * (n0 + n)], bh[n][1], bl[n][1]);
    }
    ak_mma3(o + n0, ah, al, bh, bl, AK_GROUP);
  }
}

template <int HD, int KS>
__device__ __forceinline__ void ak_pv(float (&o)[HD / 8][4], const float (&p)[2 * KS][4],
                                      const float* Xs, int nks, int lane) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(float));
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    if (j >= 2 * nks) continue;
    uint32_t ah[4], al[4];
    ak_split(p[j][0], ah[0], al[0]);  // row g, key 2t
    ak_split(p[j][2], ah[1], al[1]);  // row g + 8, key 2t
    ak_split(p[j][1], ah[2], al[2]);  // row g, key 2t + 1
    ak_split(p[j][3], ah[3], al[3]);  // row g + 8, key 2t + 1
    ak_lanes3<HD>(o, ah, al, Xs + (8 * j + 2 * t) * LD + g, LD);
  }
}

// o += Xᵀ Y for keys m0 .. m0 + 15 over nq query steps (16 rows in bf16, 8
// in fp32): X [query][key] (dS or pd, row stride xld), Y [query][lane] (q or
// g, [*][LD]). A thread's o[n][e] is key m0 + g + 8 (e / 2) and lane
// 8 n + 2 t + e % 2.
template <int HD>
__device__ __forceinline__ void ak_tn(float (&o)[HD / 8][4], const __nv_bfloat16* X, int xld,
                                      const __nv_bfloat16* Y, int m0, int nq, int lane) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(__nv_bfloat16));
  for (int kq = 0; kq < nq; ++kq) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, X + (kq * 16 + (lane & 7) + ((lane >> 4) << 3)) * xld + m0 +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Y + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                               (lane >> 4) * 8);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void ak_tn(float (&o)[HD / 8][4], const float* X, int xld,
                                      const float* Y, int m0, int nq, int lane) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(float));
  const int g = lane >> 2, t = lane & 3;
  for (int kq = 0; kq < nq; ++kq) {
    const float* x0 = X + (kq * 8 + 2 * t) * xld + m0 + g;
    uint32_t ah[4], al[4];
    ak_split(x0[0], ah[0], al[0]);        // key m0 + g, query 2t
    ak_split(x0[8], ah[1], al[1]);        // key m0 + g + 8, query 2t
    ak_split(x0[xld], ah[2], al[2]);      // key m0 + g, query 2t + 1
    ak_split(x0[xld + 8], ah[3], al[3]);  // key m0 + g + 8, query 2t + 1
    ak_lanes3<HD>(o, ah, al, Y + (kq * 8 + 2 * t) * LD + g, LD);
  }
}

template <int KS> __device__ __forceinline__ void ak_zero(float (&f)[KS][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = 0.0f;
}

// the scores (fragments of ak_qk) to fp32 probabilities: * scale, -inf past
// Sk, the row max and sum over the four lanes of each row
template <int KS>
__device__ __forceinline__ void ak_softmax(float (&s)[2 * KS][4], int nks, int Sk, float scale,
                                           int t4) {
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    if (j >= 2 * nks) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = 8 * j + 2 * t4 + (e & 1) < Sk ? s[j][e] * scale : -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    if (j >= 2 * nks) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
  const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
}

// the keep mask's value at fragment (j, e): the thread's rows' keep rows
// (null past Sq), 0 past Sk
template <typename T>
__device__ __forceinline__ float ak_keep(const T* const (&krow)[2], int j, int e, int t4,
                                         int Sk) {
  const int key = 8 * j + 2 * t4 + (e & 1);
  const T* kr = krow[e >> 1];
  return kr && key < Sk ? to_f<T>(kr[key]) : 0.0f;
}

__device__ __forceinline__ void ak_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void ak_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows r0 + g + 8 r (< n) of a 16 x HD fragment tile to base + row * ss +
// lane: round_T(o * mul) (dq, where no staging area is free)
template <typename T, int HD>
__device__ __forceinline__ void ak_store(T* base, long long ss, const float (&o)[HD / 8][4],
                                         int r0, int n, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
    T* dst = base + (long long)row * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) ak_pair(dst + 8 * j, o[j][2 * r] * mul, o[j][2 * r + 1] * mul);
  }
}

// 16-byte chunks of T: a + b, rounded
template <typename T> __device__ __forceinline__ uint4 ak_add(uint4 a, uint4 b) {
  constexpr int PER = 16 / (int)sizeof(T);
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
  uint4 r;
  T* z = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < PER; ++i) z[i] = from_f<T>(to_f<T>(x[i]) + to_f<T>(y[i]));
  return r;
}

// A warp's 16 x HD fragment tile, round_T(o * mul), to device memory through
// the staging rows S ([16][LD], free for the warp): rows r0 .. r0 + 15 below
// n to base + row * ss in 16-byte chunks, whole 32-byte sectors; with
// accumulate out = round_T(out + round_T(o * mul)). Syncs the warp before
// (S may still be read) and after (S may be reused).
template <typename T, int HD>
__device__ __forceinline__ void ak_flush(T* base, long long ss, const float (&o)[HD / 8][4],
                                         T* S, int r0, int n, float mul, bool accumulate,
                                         int lane) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(T)), PER = 16 / (int)sizeof(T);
  constexpr int C = HD / PER;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      ak_pair(S + (g + 8 * r) * LD + 8 * j + 2 * t, o[j][2 * r] * mul, o[j][2 * r + 1] * mul);
  __syncwarp();
  // accumulate: every old chunk is loaded before the first store, so the
  // loads do not wait on one another behind the stores
  constexpr int IT = AK_ROWS * C / 32;
  uint4 old[IT];
  if (accumulate) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = lane + it * 32, r = i / C, c = (i % C) * PER;
      if (r0 + r < n)
        old[it] = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * ss + c);
    }
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = lane + it * 32, r = i / C, c = (i % C) * PER;
    if (r0 + r >= n) continue;
    uint4 x = *reinterpret_cast<const uint4*>(S + r * LD + c);
    if (accumulate) x = ak_add<T>(old[it], x);
    *reinterpret_cast<uint4*>(base + (long long)(r0 + r) * ss + c) = x;
  }
  __syncwarp();
}

// row qi of the mask [Sq, Sk]; null past Sq or without a mask
__device__ __forceinline__ const float* ak_mask_row(const float* mask, int qi, int Sq, int Sk) {
  return mask && qi < Sq ? mask + (long long)qi * Sk : nullptr;
}

// the fp32 logits of one key tile's scores (ak_qk's fragments, keys k0 +
// 8 j + 2 t + e % 2): s * scale, + the row's mask (m0: row g, m1: row g + 8;
// null past Sq or without a mask), + the key bias kb (may be null), in
// _wide_body's order; keys past Sk (BOUNDED: the tile may reach past Sk)
// are left to the caller, which sets them to -inf
template <int KS, bool BOUNDED = true>
__device__ __forceinline__ void ak_bias(float (&s)[2 * KS][4], int nks, int Sk, float scale,
                                        int t4, const float* m0, const float* m1,
                                        const float* kb, int k0) {
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    if (j >= 2 * nks) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t4 + (e & 1);
      if (BOUNDED && key >= Sk) continue;
      float x = s[j][e] * scale;
      const float* m = e >> 1 ? m1 : m0;
      if (m) x += m[key];
      if (kb) x += kb[key];
      s[j][e] = x;
    }
  }
}

// The forward, in the form keep_form gives the call. AK_SHORT (Sq, Sk <=
// AK_ROWS): a warp per problem, AK_WARPS a block, one 16-key step; AK_WARP
// (no keep mask, Sq <= AK_ROWS < Sk: one query, as TempMoE's, over up to
// ATT_KEEP_MAX_SK keys): a warp per problem, a block each, its own 16 Q rows
// and all the problem's K and V rows; AK_LONG: a block per (problem, 64-row
// query tile), K and V shared by its four warps. KEEP false (kernel
// "mma_nokeep": no keep mask, attention_wide's calls) compiles the keep
// multiply out: pd = round_T(p), as _wide_body rounds p; in fp32 it also
// adds the additive mask [Sq, Sk] and the key bias [B, Sk] (either may be
// null) to the scaled scores, before the row max, as _wide_body does.
template <typename T, int HD, int FORM, bool KEEP>
__global__ void __launch_bounds__(AK_THREADS)
attention_keep_kernel(const T* __restrict__ q, long long q_bs, long long q_ss,
                      const T* __restrict__ k, long long k_bs, long long k_ss,
                      const T* __restrict__ v, long long v_bs, long long v_ss,
                      T* __restrict__ out, long long o_bs, long long o_ss,
                      const T* __restrict__ keep, long long keep_ld, int problems, int heads,
                      int Sq, int Sk, float scale, bool round_p_first,
                      const float* __restrict__ mask, const float* __restrict__ key_bias) {
  constexpr bool BIAS = !KEEP && std::is_same<T, float>::value;  // mask and key bias read
  constexpr bool WARP = FORM != AK_LONG;  // a warp owns a whole problem
  constexpr int WPB = FORM == AK_SHORT ? AK_WARPS : 1;  // warps (problems) a block
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(T));
  constexpr int KS = FORM == AK_SHORT ? 1 : ATT_KEEP_MAX_SK / 16;
  constexpr int QR = WARP ? AK_ROWS : AK_Q;  // the staged query rows
  extern __shared__ __align__(16) unsigned char ak_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int skp = FORM == AK_SHORT ? AK_ROWS : keep_pad16(Sk), nks = skp / 16;
  T* const Qs = reinterpret_cast<T*>(ak_smem) + (WARP ? (size_t)warp * (QR + 2 * skp) * LD : 0);
  T* const Ks = Qs + QR * LD;
  T* const Vs = Ks + skp * LD;
  const int ntiles = WARP ? 1 : (Sq + AK_Q - 1) / AK_Q;
  const long long unit = WARP ? (long long)blockIdx.x * WPB + warp : blockIdx.x;
  if (WARP && unit >= problems) return;  // no block-wide barrier in these forms
  const long long pr = unit / ntiles, b = pr / heads;
  const int h = (int)(pr % heads), q0 = (int)(unit % ntiles) * AK_Q;
  const long long col = (long long)h * HD;
  const int tid = WARP ? lane : threadIdx.x, nthr = WARP ? 32 : AK_THREADS;
  ak_load<T, HD>(Qs, q + b * q_bs + (long long)q0 * q_ss + col, q_ss, QR, Sq - q0, tid, nthr);
  ak_load<T, HD>(Ks, k + b * k_bs + col, k_ss, skp, Sk, tid, nthr);
  ak_load<T, HD>(Vs, v + b * v_bs + col, v_ss, skp, Sk, tid, nthr);
  cp_async_commit();
  cp_async_wait<0>();
  if (WARP)
    __syncwarp();
  else
    __syncthreads();
  const int wr = WARP ? 0 : warp * AK_ROWS, r0 = q0 + wr;  // the warp's first row
  if (r0 >= Sq) return;  // rows past Sq: this warp only copied

  const T* krow[2] = {nullptr, nullptr};
  if (KEEP) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + g + 8 * r;
      krow[r] = qi < Sq ? keep + (b * Sq + qi) * keep_ld + (long long)h * Sk : nullptr;
    }
  }
  float s[2 * KS][4];
  ak_zero(s);
  ak_qk<HD, KS>(s, Qs + wr * LD, Ks, nks, lane);
  if constexpr (BIAS) {
    if (mask || key_bias) {
      ak_bias<KS>(s, nks, Sk, scale, t4, ak_mask_row(mask, r0 + g, Sq, Sk),
                  ak_mask_row(mask, r0 + g + 8, Sq, Sk), key_bias ? key_bias + b * Sk : nullptr,
                  0);
      scale = 1.0f;  // applied: ak_softmax's x * 1 is x
    }
  }
  ak_softmax<KS>(s, nks, Sk, scale, t4);
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    if (j >= 2 * nks) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (KEEP) {
        const float p = round_p_first ? round_t<T>(s[j][e]) : s[j][e];
        s[j][e] = round_t<T>(p * ak_keep<T>(krow, j, e, t4, Sk));
      } else {
        s[j][e] = round_t<T>(s[j][e]);
      }
    }
  }
  float o[HD / 8][4];
  ak_zero(o);
  ak_pv<HD, KS>(o, s, Vs, nks, lane);
  // the warp's Q rows are free once its scores are in
  ak_flush<T, HD>(out + b * o_bs + col, o_ss, o, Qs + wr * LD, r0, Sq, 1.0f, false, lane);
}

// The fp32 forward without a keep mask past ATT_KEEP_MAX_SK keys (kernel
// "mma_nokeep_tiled": the CLIP image tower's 577 keys, the long ToMe
// layers with their key bias), _wide_body's arithmetic in two passes over
// AKT_K-key tiles, as attention_mma_kernel's two-pass form orders them in
// bf16: a block of AKT_WARPS warps owns AKT_Q query rows of a problem (a
// warp 16 of them); item i of 2 nkt streams key tile i (pass 1: K only)
// or tile i - nkt (pass 2: K and V) into stage i % 2 of a cp.async ring
// while the warps work on the other stage. Pass 1 keeps each row's running
// max and its lanes' parts of the sum rescaled to it (the row's sum is the
// four parts' total); pass 2 recomputes the same scores, forms p =
// exp(x - max) / sum after the row's global max and sum, and adds p v. The
// scores and p·v run on 3xTF32 (ak_qk, ak_pv); each tile's p·v is summed
// into a fresh fragment and folded into the fp32 context with an IEEE add,
// as gemm_tf32x3.cuh folds its K slabs, so the context's sum over many
// tiles rounds to nearest.
template <int HD>
__global__ void __launch_bounds__(AKT_THREADS, HD <= 64 ? 2 : 1)
attention_nokeep_tiled_kernel(const float* __restrict__ q, long long q_bs, long long q_ss,
                              const float* __restrict__ k, long long k_bs, long long k_ss,
                              const float* __restrict__ v, long long v_bs, long long v_ss,
                              float* __restrict__ out, long long o_bs, long long o_ss,
                              const float* __restrict__ mask, const float* __restrict__ key_bias,
                              int heads, int Sq, int Sk, float scale) {
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(float)), KS = AKT_K / 16;
  extern __shared__ __align__(16) unsigned char akt_smem[];
  float* const Qs = reinterpret_cast<float*>(akt_smem);  // [AKT_Q][LD]
  float* const Ks = Qs + AKT_Q * LD;                      // [2][AKT_K][LD]
  float* const Vs = Ks + 2 * AKT_K * LD;                  // [2][AKT_K][LD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ntiles = (Sq + AKT_Q - 1) / AKT_Q, nkt = (Sk + AKT_K - 1) / AKT_K;
  const long long pr = blockIdx.x / ntiles, b = pr / heads;
  const int h = (int)(pr % heads), q0 = (int)(blockIdx.x % ntiles) * AKT_Q;
  const long long col = (long long)h * HD;
  const float* const kh = k + b * k_bs + col;
  const float* const vh = v + b * v_bs + col;
  const int wr = warp * AK_ROWS, r0 = q0 + wr;  // the warp's first row
  // a warp whose 16 rows all lie past Sq copies its share and computes nothing
  const bool live = r0 < Sq;
  const float* const m0 = ak_mask_row(mask, r0 + g, Sq, Sk);
  const float* const m1 = ak_mask_row(mask, r0 + g + 8, Sq, Sk);
  const float* const kb = key_bias ? key_bias + b * Sk : nullptr;

  const int items = 2 * nkt;
  auto fetch = [&](int i) {
    const int st = (i & 1) * AKT_K * LD, k0 = (i < nkt ? i : i - nkt) * AKT_K;
    ak_load<float, HD>(Ks + st, kh + (long long)k0 * k_ss, k_ss, AKT_K, Sk - k0, tid, AKT_THREADS);
    if (i >= nkt)
      ak_load<float, HD>(Vs + st, vh + (long long)k0 * v_ss, v_ss, AKT_K, Sk - k0, tid,
                         AKT_THREADS);
  };
  ak_load<float, HD>(Qs, q + b * q_bs + (long long)q0 * q_ss + col, q_ss, AKT_Q, Sq - q0, tid,
                     AKT_THREADS);
  fetch(0);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
  ak_zero(o);
  // the logits of key tile k0: scale, mask and key bias where the call has
  // them (BIASED), -inf past Sk (only the last tile, BOUNDED, reaches it)
  auto logits = [&](float(&s)[2 * KS][4], int k0, auto biased, auto bounded) {
    constexpr bool BOUNDED = decltype(bounded)::value;
    if constexpr (decltype(biased)::value) {
      ak_bias<KS, BOUNDED>(s, KS, Sk, scale, t4, m0, m1, kb, k0);
    } else {
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    }
    if constexpr (BOUNDED) {
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t4 + (e & 1) >= Sk) s[j][e] = -INFINITY;
    }
  };
  auto tile = [&](int i, auto biased) {
    const int st = (i & 1) * AKT_K * LD, k0 = (i < nkt ? i : i - nkt) * AKT_K;
    float s[2 * KS][4];
    ak_zero(s);
    ak_qk<HD, KS>(s, Qs + wr * LD, Ks + st, KS, lane);
    if (k0 + AKT_K <= Sk)
      logits(s, k0, biased, std::false_type{});
    else
      logits(s, k0, biased, std::true_type{});
    if (i < nkt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx));
        if (mn == -INFINITY) continue;  // every key so far masked out
        float part = l[r] * expf(m[r] - mn);
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j)
          part += expf(s[j][2 * r] - mn) + expf(s[j][2 * r + 1] - mn);
        l[r] = part;
        m[r] = mn;
      }
      if (i == nkt - 1) {
        inv[0] = 1.0f / quad_sum(l[0]);
        inv[1] = 1.0f / quad_sum(l[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) * inv[e >> 1];
      float part[HD / 8][4];
      ak_zero(part);
      ak_pv<HD, KS>(part, s, Vs + st, KS, lane);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += part[n][e];
    }
  };
  auto run = [&](auto biased) {
    for (int i = 0; i < items; ++i) {
      if (i + 1 < items) {
        fetch(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile i has landed in every thread's share
      if (live) tile(i, biased);
      __syncthreads();  // stage i % 2 is refilled by the next iteration's fetch
    }
  };
  if (mask || key_bias)
    run(std::true_type{});
  else
    run(std::false_type{});
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    if (qi >= Sq) continue;
    float* orow = out + b * o_bs + (long long)qi * o_ss + col + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) ak_pair(orow + 8 * n, o[n][2 * r], o[n][2 * r + 1]);
  }
}

// The backward. SHORT: a warp per problem as forward; otherwise a block per
// problem, its warps taking the 16-row query tiles in turn. Shared memory
// per problem: Q and G [SqP][LD], K and V [SkP][LD] (in the long form at
// least AK_Q rows together, keep_kv_rows), then dS and pd [SqP]
// [keep_pld(Sk)] (SqP, SkP: Sq, Sk rounded up to 16; zero rows past them).
template <typename T, int HD, bool SHORT>
__global__ void __launch_bounds__(AK_THREADS)
attention_keep_bwd_kernel(const T* __restrict__ q, long long q_bs, long long q_ss,
                          const T* __restrict__ k, long long k_bs, long long k_ss,
                          const T* __restrict__ v, long long v_bs, long long v_ss,
                          const T* __restrict__ g, long long g_bs, long long g_ss,
                          T* __restrict__ gq, long long gq_bs, long long gq_ss,
                          T* __restrict__ gk, long long gk_bs, long long gk_ss,
                          T* __restrict__ gv, long long gv_bs, long long gv_ss,
                          const T* __restrict__ keep, long long keep_ld, int problems, int heads,
                          int Sq, int Sk, float scale, bool round_p_first, bool accumulate_kv) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = keep_stage_ld(HD, (int)sizeof(T)), KS = SHORT ? 1 : ATT_KEEP_MAX_SK / 16;
  extern __shared__ __align__(16) unsigned char akb_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq4 = lane >> 2, t4 = lane & 3;
  const int sqp = SHORT ? AK_ROWS : keep_pad16(Sq), skp = SHORT ? AK_ROWS : keep_pad16(Sk);
  const int pld = keep_pld(Sk, (int)sizeof(T)), nks = skp / 16;
  T* const Qs = reinterpret_cast<T*>(akb_smem) +
                (SHORT ? (size_t)warp * AK_ROWS * (4 * LD + 2 * pld) : 0);
  T* const Gs = Qs + sqp * LD;
  T* const Ks = Gs + sqp * LD;
  T* const Vs = Ks + skp * LD;
  T* const Ds = Ks + (SHORT ? 2 * AK_ROWS : keep_kv_rows(Sk)) * LD;  // dS
  T* const Ps = Ds + sqp * pld;  // pd
  const long long pr = SHORT ? (long long)blockIdx.x * AK_WARPS + warp : blockIdx.x;
  if (SHORT && pr >= problems) return;  // no block-wide barrier in this form
  const long long b = pr / heads;
  const int h = (int)(pr % heads);
  const long long col = (long long)h * HD;
  const int tid = SHORT ? lane : threadIdx.x, nthr = SHORT ? 32 : AK_THREADS;
  ak_load<T, HD>(Qs, q + b * q_bs + col, q_ss, sqp, Sq, tid, nthr);
  ak_load<T, HD>(Gs, g + b * g_bs + col, g_ss, sqp, Sq, tid, nthr);
  ak_load<T, HD>(Ks, k + b * k_bs + col, k_ss, skp, Sk, tid, nthr);
  ak_load<T, HD>(Vs, v + b * v_bs + col, v_ss, skp, Sk, tid, nthr);
  cp_async_commit();
  cp_async_wait<0>();
  if (SHORT)
    __syncwarp();
  else
    __syncthreads();

  // each warp's query tiles: P, pd, dS in registers; pd and dS to shared
  // memory (zero in rows past Sq, where keep reads 0); dq from dS
  for (int r0 = SHORT ? 0 : warp * AK_ROWS; r0 < Sq; r0 += SHORT ? AK_ROWS : AK_Q) {
    const T* krow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + gq4 + 8 * r;
      krow[r] = qi < Sq ? keep + (b * Sq + qi) * keep_ld + (long long)h * Sk : nullptr;
    }
    float s[2 * KS][4], dp[2 * KS][4];
    ak_zero(s);
    ak_zero(dp);
    ak_qk<HD, KS>(s, Qs + r0 * LD, Ks, nks, lane);
    ak_qk<HD, KS>(dp, Gs + r0 * LD, Vs, nks, lane);  // dPd = g vᵀ
    ak_softmax<KS>(s, nks, Sk, scale, t4);
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      if (j >= 2 * nks) continue;
      float pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kv = ak_keep<T>(krow, j, e, t4, Sk);
        const float p = round_p_first ? round_t<T>(s[j][e]) : s[j][e];
        pd[e] = round_t<T>(p * kv);
        s[j][e] = p;
        dp[j][e] *= kv;  // dP = dPd keep
        dot[e >> 1] = fmaf(dp[j][e], p, dot[e >> 1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ak_pair(Ps + (r0 + gq4 + 8 * r) * pld + 8 * j + 2 * t4, pd[2 * r], pd[2 * r + 1]);
    }
    dot[0] = quad_sum(dot[0]);
    dot[1] = quad_sum(dot[1]);
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      if (j >= 2 * nks) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = round_t<T>(s[j][e] * (dp[j][e] - dot[e >> 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ak_pair(Ds + (r0 + gq4 + 8 * r) * pld + 8 * j + 2 * t4, dp[j][2 * r], dp[j][2 * r + 1]);
    }
    float o[HD / 8][4];
    ak_zero(o);
    ak_pv<HD, KS>(o, dp, Ks, nks, lane);  // dS k
    if (SHORT)  // its K rows are the warp's own, and read for the last time
      ak_flush<T, HD>(gq + b * gq_bs + col, gq_ss, o, Ks, r0, Sq, scale, false, lane);
    else        // the other warps still read K
      ak_store<T, HD>(gq + b * gq_bs + col, gq_ss, o, r0, Sq, scale, lane);
  }
  if (SHORT)
    __syncwarp();
  else
    __syncthreads();

  // dk = scale dSᵀ q and dv = pdᵀ g by 16-key tiles, one warp a tile; the
  // K and V rows, dead now, stage each warp's tile (16 rows a warp; the
  // long form's are at least AK_Q, attention_keep_bwd_smem_bytes)
  T* const stage = Ks + (SHORT ? 0 : warp * AK_ROWS * LD);
  const int nq = kBf16 ? sqp / 16 : sqp / 8;
  for (int it = SHORT ? 0 : warp; it < 2 * nks; it += SHORT ? 1 : AK_WARPS) {
    const bool dv = it & 1;
    const int m0 = (it >> 1) * 16;
    float o[HD / 8][4];
    ak_zero(o);
    ak_tn<HD>(o, dv ? Ps : Ds, pld, dv ? Gs : Qs, m0, nq, lane);
    if (dv)
      ak_flush<T, HD>(gv + b * gv_bs + col, gv_ss, o, stage, m0, Sk, 1.0f, accumulate_kv, lane);
    else
      ak_flush<T, HD>(gk + b * gk_bs + col, gk_ss, o, stage, m0, Sk, scale, accumulate_kv, lane);
  }
}

// 16-byte aligned, batch and row strides whole 16 bytes
template <typename T> bool ak_operand(const void* p, long long bs, long long ss) {
  constexpr long long PER = 16 / (long long)sizeof(T);
  return !(reinterpret_cast<uintptr_t>(p) & 15) && !(bs % PER) && !(ss % PER);
}

template <auto Kernel> cudaError_t ak_set_smem(size_t bytes) {
  return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD, int FORM, bool KEEP>
cudaError_t keep_fwd_form(KeepIn q, KeepIn k, KeepIn v, KeepOut out, const T* keep,
                          long long keep_ld, int B, int Sq, int Sk, int heads, float scale,
                          bool round_p_first, cudaStream_t stream, const float* mask,
                          const float* key_bias) {
  const size_t smem = attention_keep_smem_bytes((int)sizeof(T), Sq, Sk, HD, KEEP);
  const long long problems = (long long)B * heads;
  const long long blocks = FORM == AK_SHORT  ? (problems + AK_WARPS - 1) / AK_WARPS
                           : FORM == AK_WARP ? problems
                                             : problems * ((Sq + AK_Q - 1) / AK_Q);
  if (problems > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = ak_set_smem<attention_keep_kernel<T, HD, FORM, KEEP>>(smem);
  if (err != cudaSuccess) return err;
  attention_keep_kernel<T, HD, FORM, KEEP>
      <<<(unsigned)blocks, FORM == AK_WARP ? 32 : AK_THREADS, smem, stream>>>(
          static_cast<const T*>(q.p), q.bs, q.ss, static_cast<const T*>(k.p), k.bs, k.ss,
          static_cast<const T*>(v.p), v.bs, v.ss, static_cast<T*>(out.p), out.bs, out.ss, keep,
          keep_ld, (int)problems, heads, Sq, Sk, scale, round_p_first, mask, key_bias);
  return cudaGetLastError();
}

// keep null: the form without a keep mask ("mma_nokeep"; in fp32 with the
// mask and key bias, either may be null)
template <typename T, int HD>
cudaError_t keep_fwd(KeepIn q, KeepIn k, KeepIn v, KeepOut out, const T* keep,
                     long long keep_ld, int B, int Sq, int Sk, int heads, float scale,
                     bool round_p_first, cudaStream_t stream, const float* mask,
                     const float* key_bias) {
#define QT_FORM(FORM, KEEP)                                                                \
  keep_fwd_form<T, HD, FORM, KEEP>(q, k, v, out, keep, keep_ld, B, Sq, Sk, heads, scale, \
                                   round_p_first, stream, mask, key_bias)
  switch (keep_form(Sq, Sk, keep != nullptr)) {
    case AK_SHORT: return keep ? QT_FORM(AK_SHORT, true) : QT_FORM(AK_SHORT, false);
    case AK_WARP: return QT_FORM(AK_WARP, false);
    default: return keep ? QT_FORM(AK_LONG, true) : QT_FORM(AK_LONG, false);
  }
#undef QT_FORM
}

template <typename T, int HD>
cudaError_t keep_bwd(KeepIn q, KeepIn k, KeepIn v, KeepIn g, KeepOut gq, KeepOut gk, KeepOut gv,
                     const T* keep, long long keep_ld, int B, int Sq, int Sk, int heads,
                     float scale, bool round_p_first, bool accumulate_kv, cudaStream_t stream) {
  const bool shrt = keep_short(Sq, Sk);
  const size_t smem = attention_keep_bwd_smem_bytes((int)sizeof(T), Sq, Sk, HD);
  const long long problems = (long long)B * heads;
  const long long blocks = shrt ? (problems + AK_WARPS - 1) / AK_WARPS : problems;
  if (problems > INT_MAX) return cudaErrorInvalidValue;
  auto kernel =
      shrt ? attention_keep_bwd_kernel<T, HD, true> : attention_keep_bwd_kernel<T, HD, false>;
  cudaError_t err = shrt ? ak_set_smem<attention_keep_bwd_kernel<T, HD, true>>(smem)
                         : ak_set_smem<attention_keep_bwd_kernel<T, HD, false>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, AK_THREADS, smem, stream>>>(
      static_cast<const T*>(q.p), q.bs, q.ss, static_cast<const T*>(k.p), k.bs, k.ss,
      static_cast<const T*>(v.p), v.bs, v.ss, static_cast<const T*>(g.p), g.bs, g.ss,
      static_cast<T*>(gq.p), gq.bs, gq.ss, static_cast<T*>(gk.p), gk.bs, gk.ss,
      static_cast<T*>(gv.p), gv.bs, gv.ss, keep, keep_ld, (int)problems, heads, Sq, Sk, scale,
      round_p_first, accumulate_kv);
  return cudaGetLastError();
}

template <int HD>
cudaError_t nokeep_tiled(KeepIn q, KeepIn k, KeepIn v, KeepOut out, const float* mask,
                         const float* key_bias, int B, int Sq, int Sk, int heads, float scale,
                         cudaStream_t stream) {
  const size_t smem = attention_nokeep_tiled_smem_bytes(HD);
  const long long blocks = (long long)B * heads * ((Sq + AKT_Q - 1) / AKT_Q);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = ak_set_smem<attention_nokeep_tiled_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  attention_nokeep_tiled_kernel<HD><<<(unsigned)blocks, AKT_THREADS, smem, stream>>>(
      static_cast<const float*>(q.p), q.bs, q.ss, static_cast<const float*>(k.p), k.bs, k.ss,
      static_cast<const float*>(v.p), v.bs, v.ss, static_cast<float*>(out.p), out.bs, out.ss,
      mask, key_bias, heads, Sq, Sk, scale);
  return cudaGetLastError();
}

template <typename T>
bool ak_operands(std::initializer_list<KeepIn> ins, std::initializer_list<KeepOut> outs) {
  for (const KeepIn& x : ins)
    if (!ak_operand<T>(x.p, x.bs, x.ss)) return false;
  for (const KeepOut& x : outs)
    if (!ak_operand<T>(x.p, x.bs, x.ss)) return false;
  return true;
}

template <typename T>
bool ak_args(std::initializer_list<KeepIn> ins, std::initializer_list<KeepOut> outs, int Sk,
             int hd) {
  return ak_operands<T>(ins, outs) && keep_head(hd) && Sk >= 1 && Sk <= ATT_KEEP_MAX_SK;
}

}  // namespace

cudaError_t attention_keep_fwd(bool bf16, KeepIn q, KeepIn k, KeepIn v, KeepOut out,
                               const void* keep, long long keep_ld, int B, int Sq, int Sk,
                               int heads, int hd, float scale, bool round_p_first,
                               cudaStream_t stream, const float* mask, const float* key_bias) {
  if (B <= 0 || Sq <= 0 || heads <= 0) return cudaSuccess;
  const bool ok = bf16 ? ak_args<__nv_bfloat16>({q, k, v}, {out}, Sk, hd)
                       : ak_args<float>({q, k, v}, {out}, Sk, hd);
  // a mask or a key bias only in fp32 without a keep mask
  if (!ok || ((mask || key_bias) && (bf16 || keep))) return cudaErrorInvalidValue;
#define QT_KEEP_FWD(T, HD)                                                                       \
  keep_fwd<T, HD>(q, k, v, out, static_cast<const T*>(keep), keep_ld, B, Sq, Sk, heads, scale, \
                  round_p_first, stream, mask, key_bias)
  if (bf16) {
    switch (hd) {
      case 32: return QT_KEEP_FWD(__nv_bfloat16, 32);
      case 64: return QT_KEEP_FWD(__nv_bfloat16, 64);
      default: return QT_KEEP_FWD(__nv_bfloat16, 128);
    }
  }
  switch (hd) {
    case 32: return QT_KEEP_FWD(float, 32);
    case 64: return QT_KEEP_FWD(float, 64);
    default: return QT_KEEP_FWD(float, 128);
  }
#undef QT_KEEP_FWD
}

cudaError_t attention_nokeep_tiled(KeepIn q, KeepIn k, KeepIn v, KeepOut out, const float* mask,
                                   const float* key_bias, int B, int Sq, int Sk, int heads,
                                   int hd, float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || heads <= 0) return cudaSuccess;
  if (!ak_operands<float>({q, k, v}, {out}) || !keep_head(hd) || Sk < 1)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return nokeep_tiled<32>(q, k, v, out, mask, key_bias, B, Sq, Sk, heads, scale, stream);
    case 64: return nokeep_tiled<64>(q, k, v, out, mask, key_bias, B, Sq, Sk, heads, scale, stream);
    default:
      return nokeep_tiled<128>(q, k, v, out, mask, key_bias, B, Sq, Sk, heads, scale, stream);
  }
}

cudaError_t attention_keep_bwd(bool bf16, KeepIn q, KeepIn k, KeepIn v, KeepIn g, KeepOut gq,
                               KeepOut gk, KeepOut gv, const void* keep, long long keep_ld,
                               int B, int Sq, int Sk, int heads, int hd, float scale,
                               bool round_p_first, bool accumulate_kv, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || heads <= 0) return cudaSuccess;
  const bool ok = keep && (bf16 ? ak_args<__nv_bfloat16>({q, k, v, g}, {gq, gk, gv}, Sk, hd)
                               : ak_args<float>({q, k, v, g}, {gq, gk, gv}, Sk, hd));
  if (!ok) return cudaErrorInvalidValue;
#define QT_KEEP_BWD(T, HD)                                                                    \
  keep_bwd<T, HD>(q, k, v, g, gq, gk, gv, static_cast<const T*>(keep), keep_ld, B, Sq, Sk,    \
                  heads, scale, round_p_first, accumulate_kv, stream)
  if (bf16) {
    switch (hd) {
      case 32: return QT_KEEP_BWD(__nv_bfloat16, 32);
      case 64: return QT_KEEP_BWD(__nv_bfloat16, 64);
      default: return QT_KEEP_BWD(__nv_bfloat16, 128);
    }
  }
  switch (hd) {
    case 32: return QT_KEEP_BWD(float, 32);
    case 64: return QT_KEEP_BWD(float, 64);
    default: return QT_KEEP_BWD(float, 128);
  }
#undef QT_KEEP_BWD
}

}  // namespace qt

// The two kernels by themselves (ops/avq.py attention_keep and
// attention_keep_bwd), for their checks and timing; the model paths reach
// them through the train kernels. q, k, v, g and the outputs are [B, S,
// heads * hd] with unit stride along the lanes (strides in elements); keep
// [B * Sq, >= heads * Sk] in the operands' type, row stride keep_ld, lane
// h * Sk + key. dtype 0 float32, 1 bfloat16.
extern "C" int qt_attention_keep(int dtype, const void* q, long long q_bs, long long q_ss,
                                 const void* k, long long k_bs, long long k_ss, const void* v,
                                 long long v_bs, long long v_ss, void* out, long long o_bs,
                                 long long o_ss, const void* keep, long long keep_ld, int B,
                                 int Sq, int Sk, int heads, int hd, float scale,
                                 int round_p_first, void* stream) {
  return qt::attention_keep_fwd(dtype == 1, {q, q_bs, q_ss}, {k, k_bs, k_ss}, {v, v_bs, v_ss},
                                {out, o_bs, o_ss}, keep, keep_ld, B, Sq, Sk, heads, hd, scale,
                                round_p_first != 0, static_cast<cudaStream_t>(stream));
}

extern "C" int qt_attention_keep_bwd(int dtype, const void* q, long long q_bs, long long q_ss,
                                     const void* k, long long k_bs, long long k_ss,
                                     const void* v, long long v_bs, long long v_ss,
                                     const void* g, long long g_bs, long long g_ss, void* gq,
                                     long long gq_bs, long long gq_ss, void* gk, long long gk_bs,
                                     long long gk_ss, void* gv, long long gv_bs, long long gv_ss,
                                     const void* keep, long long keep_ld, int B, int Sq, int Sk,
                                     int heads, int hd, float scale, int round_p_first,
                                     int accumulate_kv, void* stream) {
  return qt::attention_keep_bwd(dtype == 1, {q, q_bs, q_ss}, {k, k_bs, k_ss}, {v, v_bs, v_ss},
                                {g, g_bs, g_ss}, {gq, gq_bs, gq_ss}, {gk, gk_bs, gk_ss},
                                {gv, gv_bs, gv_ss}, keep, keep_ld, B, Sq, Sk, heads, hd, scale,
                                round_p_first != 0, accumulate_kv != 0,
                                static_cast<cudaStream_t>(stream));
}
