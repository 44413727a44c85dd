// ---------------------------------------------------------------------------
// attention_wide's tensor-parallel form for one head split by lanes (TSPM's
// one-head AV_Attn and TokensAttn under a model axis, where no rank holds a
// whole head). It is a form of the kernel that replaces
// fused_attention_wide's pl.pallas_call (qa_tiger_tpu/ops/pallas/
// attention.py:351), which under a model axis JAX leaves whole on every
// device (GSPMD gathers around it). Each model rank holds W = head/tp lanes
// of q, k and v. Two stages, the model group's sum of the fp32 partial
// scores between them:
//
//   tp_scores: s_r = q_r k_rᵀ over the rank's lanes, fp32 and unscaled (the
//              single-rank kernels scale the whole fp32 product, so the
//              scale waits for the sum);
//   tp_pv:     from the summed scores, x = s * scale, then + mask, the row
//              max and sum, p = round_T(exp(x - max) / sum), and
//              ctx_r = p v_r summed in fp32, rounded to T.
//
// Bound: bytes. At TSPM's shapes (B=256, tp 2: AV_Attn [512, 60, 256 lanes],
// TokensAttn [2560, 14, 256]) a stage moves 20-70 MB for 2 Sq Sk W
// operations a problem: at most 30 per byte, against ridges of ~295 (bf16)
// and ~50 (3xTF32, a third of 495 TFLOP/s). So the design keeps every SM
// busy with copies and never drains between two problems:
// - every operand streams through shared memory in slabs of 128 bytes a row
//   (64 bf16 or 32 fp32 lanes; rows padded to 144 bytes, so that the
//   fragment reads below hit 32 banks) by 16-byte cp.async copies into a
//   two-stage ring: one stage in use while the next item lands (three and
//   four stages ran slower at TSPM's shapes, fewer blocks a SM, and so did
//   L2's 256-byte prefetch hint; PERF.md §6, PR 21);
// - blocks are persistent, as many as the SMs hold, and each walks its units
//   (a 64-row query tile of a problem, or, at most 16 queries and keys, a
//   whole problem a warp with a ring of its own) as one stream of items, so
//   the next unit's first slab is in flight behind this one's last;
// - the products run on the tensor cores: bf16 on mma.sync.m16n8k16, fp32 on
//   3xTF32 (mma.sync.m16n8k8 on hi/lo splits, lo·hi + hi·lo + hi·hi). Each
//   slab (scores) or key tile (pv) is summed into a fresh fragment and
//   folded into the fp32 accumulator with an IEEE add, as gemm_tf32x3.cuh
//   does. No product runs single-pass TF32. (At AV_Attn's 60 x 60 in fp32
//   the splits and products alone take about as long as the copies alone:
//   there the stage is bound by both; PERF.md §6, PR 21);
// - tp_pv: each warp owns 16 query rows and reads their scores once, two
//   keys at a time, straight into the registers where m16n8k16's A
//   fragments want them (3xTF32's m16n8k8 too, with the keys permuted within
//   each 8: k slot t is key 2t, slot t + 4 key 2t + 1, on both operands).
//   Scale, mask, max, sum and p stay in registers; p never touches shared
//   memory. v streams in 128-byte lane chunks, read with ldmatrix.trans
//   (bf16) or two scalar loads a fragment (fp32). Up to 64 keys (one key
//   tile) p is held whole; past that the row max and sum take two passes
//   over the scores and p is formed again for each 64-key tile from the
//   scores, by then in L2.
//
// Needs 16-byte aligned operands whose batch and row strides are multiples
// of 16 bytes and W a multiple of a slab's lanes (the wrappers zero-pad the
// lanes or copy); a call that breaks that returns cudaErrorInvalidValue.
// ---------------------------------------------------------------------------
#pragma once

#include "common.cuh"

namespace qt {
namespace {

template <typename T> struct TpSlab {
  static constexpr int LANES = 128 / (int)sizeof(T);      // 64 bf16, 32 fp32
  static constexpr int LD = LANES + 16 / (int)sizeof(T);  // a row of 144 bytes
};
constexpr int TP_ROW_BYTES = 144, TP_WARPS = 4, TP_THREADS = TP_WARPS * 32;
// a block's query and key tiles; the short kernels' problems (a warp each);
// the ring's stages
constexpr int TP_ROWS = 64, TP_SHORT = ATT_SHORT_MAX, TP_STAGES = 2;
static_assert(TpSlab<__nv_bfloat16>::LD == AWM_LD && TpSlab<__nv_bfloat16>::LANES == AWM_SLAB,
              "the bf16 slabs are mma_wide's");

inline bool tp_short(int Sq, int Sk) { return Sq <= TP_SHORT && Sk <= TP_SHORT; }

// the scores kernels: a stage holds a Q slab and a K slab
template <bool SHORT> struct TpScoresGeo {
  static constexpr int Q = SHORT ? TP_SHORT : TP_ROWS, K = Q, STAGE_ROWS = Q + K;
  static constexpr size_t SMEM =
      (size_t)(SHORT ? TP_WARPS : 1) * TP_STAGES * STAGE_ROWS * TP_ROW_BYTES;
};

// the pv kernels: a stage holds a lane chunk of K keys of v
template <bool SHORT> struct TpPvGeo {
  static constexpr int Q = SHORT ? TP_SHORT : TP_ROWS, K = Q;
  static constexpr size_t SMEM = (size_t)(SHORT ? TP_WARPS : 1) * TP_STAGES * K * TP_ROW_BYTES;
};

// rows r0 .. r0 + ROWS - 1 of src (row stride ss), lanes c0 .. c0 + LANES -
// 1, into [ROWS][LD], zero past row n; THREADS threads share the copy, this
// one being thread tid of them
template <int ROWS, int THREADS, typename T>
__device__ __forceinline__ void tp_load_rows(T* dst, const T* __restrict__ src, long long ss,
                                             int r0, int n, int c0, int tid) {
  constexpr int PER = 16 / (int)sizeof(T);
  static_assert(ROWS * 8 % THREADS == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i >> 3, c = (i & 7) * PER;
    const bool in = r0 + r < n;
    const T* from = in ? src + (long long)(r0 + r) * ss + c0 + c : src;
    cp_async16(dst + r * TpSlab<T>::LD + c, from, in);
  }
}

// The units a persistent block (or warp) walks, first, first + stride, ...
// below units, per items each, as one stream: item n's unit and index.
struct TpWalk {
  long long first, stride, units;
  int per;
  __device__ long long items() const {
    return first < units ? ((units - 1 - first) / stride + 1) * per : 0;
  }
  __device__ long long unit(long long n) const { return first + (n / per) * stride; }
  __device__ int index(long long n) const { return (int)(n % per); }
};

// items 0 .. n - 1 through a ring of S stages: fetch(i, stage) issues item
// i's copies, use(i, stage) reads them once they have landed, sync() makes
// every participant's copies visible (__syncthreads or __syncwarp). A
// stage is refilled only after every participant passed the sync that
// follows its last use.
template <int S, class Fetch, class Use, class Sync>
__device__ __forceinline__ void tp_ring(long long n, Fetch&& fetch, Use&& use, Sync&& sync) {
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) fetch((long long)i, i);
    cp_async_commit();
  }
  for (long long i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();
    sync();
    const long long next = i + S - 1;
    if (next < n) fetch(next, (int)(next % S));
    cp_async_commit();
    use(i, (int)(i % S));
  }
}

// s += the 16 x 8 NJ scores of one bf16 slab: a warp's 16 Q rows (Qw)
// against 8 NJ keys (Kt), both [*][LD]
template <int NJ>
__device__ __forceinline__ void tp_qk(float (&s)[NJ][4], const __nv_bfloat16* Qw,
                                      const __nv_bfloat16* Kt, int lane) {
  qk_slab<NJ>(s, Qw, Kt, lane);
}

// the same for an fp32 slab of 32 lanes, in 3xTF32 (small terms first)
template <int NJ>
__device__ __forceinline__ void tp_qk(float (&s)[NJ][4], const float* Qw, const float* Kt,
                                      int lane) {
  constexpr int LD = TpSlab<float>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < TpSlab<float>::LANES; kk += 8) {
    uint32_t ah[4], al[4], bh[NJ][2], bl[NJ][2];
    split_tf32(Qw[g * LD + kk + t], ah[0], al[0]);
    split_tf32(Qw[(g + 8) * LD + kk + t], ah[1], al[1]);
    split_tf32(Qw[g * LD + kk + t + 4], ah[2], al[2]);
    split_tf32(Qw[(g + 8) * LD + kk + t + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      split_tf32(Kt[(8 * j + g) * LD + kk + t], bh[j][0], bl[j][0]);
      split_tf32(Kt[(8 * j + g) * LD + kk + t + 4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(s[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ah, bh[j]);
  }
}

template <int NJ> __device__ __forceinline__ void tp_zero(float (&f)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = 0.0f;
}

template <int NJ>
__device__ __forceinline__ void tp_fold(float (&acc)[NJ][4], const float (&part)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// The partial scores. A thread's fragment s[j][e] is row g + 8 (e / 2) of
// its warp's 16 and key 8 j + 2 t + e % 2 of the key tile (g = lane / 4,
// t = lane % 4). Units: a 64-row query tile of a problem, 4 warps of 16
// rows, its items (key tile, lane slab); SHORT: a problem a warp, its items
// the lane slabs. vec: Sk is even, so a row's key pairs are float2 stores.
template <typename T, bool SHORT>
__global__ void __launch_bounds__(TP_THREADS)
tp_scores_kernel(const T* __restrict__ q, long long q_bs, long long q_ss, const T* __restrict__ k,
                 long long k_bs, long long k_ss, float* __restrict__ s, int B, int Sq, int Sk,
                 int W, bool vec) {
  using G = TpScoresGeo<SHORT>;
  constexpr int LD = TpSlab<T>::LD, LANES = TpSlab<T>::LANES, NJ = G::K / 8;
  constexpr int STAGE = G::STAGE_ROWS * LD, THREADS = SHORT ? 32 : TP_THREADS;
  extern __shared__ __align__(16) unsigned char tps_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  T* const ring = reinterpret_cast<T*>(tps_smem) + (SHORT ? (size_t)warp * TP_STAGES * STAGE : 0);
  const int ntiles = (Sq + G::Q - 1) / G::Q, nkt = (Sk + G::K - 1) / G::K, nd = W / LANES;
  const int ptid = SHORT ? lane : tid;
  const TpWalk walk =
      SHORT ? TpWalk{(long long)blockIdx.x * TP_WARPS + warp, (long long)gridDim.x * TP_WARPS, B,
                     nd}
            : TpWalk{blockIdx.x, gridDim.x, (long long)B * ntiles, nkt * nd};
  auto fetch = [&](long long n, int st) {
    const long long u = walk.unit(n), b = u / ntiles;
    const int i = walk.index(n), t = i / nd, d = i % nd, q0 = (int)(u % ntiles) * G::Q;
    T* dst = ring + st * STAGE;
    tp_load_rows<G::Q, THREADS>(dst, q + b * q_bs, q_ss, q0, Sq, d * LANES, ptid);
    tp_load_rows<G::K, THREADS>(dst + G::Q * LD, k + b * k_bs, k_ss, t * G::K, Sk, d * LANES,
                                ptid);
  };
  float acc[NJ][4], part[NJ][4];
  auto use = [&](long long n, int st) {
    const long long u = walk.unit(n), b = u / ntiles;
    const int i = walk.index(n), t = i / nd, d = i % nd;
    const int r0 = (int)(u % ntiles) * G::Q + (SHORT ? 0 : warp * 16);
    if (r0 >= Sq) return;  // rows past Sq: this warp only copies
    const T* src = ring + st * STAGE;
    tp_zero(part);
    tp_qk<NJ>(part, src + (SHORT ? 0 : warp * 16 * LD), src + G::Q * LD, lane);
    if (d == 0) tp_zero(acc);
    tp_fold(acc, part);
    if (d != nd - 1) return;
    float* sb = s + b * (long long)Sq * Sk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + g + 8 * r;
      if (qi >= Sq) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kj = t * G::K + 8 * j + 2 * t4;
        float* dst = sb + (long long)qi * Sk + kj;
        if (vec && kj < Sk) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        } else {
          if (kj < Sk) dst[0] = acc[j][2 * r];
          if (kj + 1 < Sk) dst[1] = acc[j][2 * r + 1];
        }
      }
    }
  };
  if constexpr (SHORT)
    tp_ring<TP_STAGES>(walk.items(), fetch, use, [] { __syncwarp(); });
  else
    tp_ring<TP_STAGES>(walk.items(), fetch, use, [] { __syncthreads(); });
}

// One 16-key step of the scores from key kb for the thread's two rows r0 +
// g and r0 + g + 8: x[4 h + 2 r + e] = fl(fl(s * scale) + mask) of row
// r0 + g + 8 r and key kb + 8 h + 2 t + e, -inf past Sk; a row past Sq
// reads 0 (its p is finite and never stored). vec: Sk is even and s
// 8-byte aligned, so each key pair is one float2 load.
__device__ __forceinline__ void tp_load_step(float (&x)[8], const float* __restrict__ sb,
                                             const float* __restrict__ mask, int r0, int g, int t4,
                                             int Sq, int Sk, int kb, float scale, bool vec) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kb + 8 * h + 2 * t4;
      float a = 0.0f, c = 0.0f;
      if (row < Sq) {
        const float* sr = sb + (long long)row * Sk + key;
        if (vec && key < Sk) {
          const float2 pair = __ldg(reinterpret_cast<const float2*>(sr));
          a = pair.x;
          c = pair.y;
        } else {
          if (key < Sk) a = __ldg(sr);
          if (key + 1 < Sk) c = __ldg(sr + 1);
        }
        a = __fmul_rn(a, scale);  // rounded before the mask, as the plain version
        c = __fmul_rn(c, scale);
        if (mask) {
          const float* mr = mask + (long long)row * Sk + key;
          if (key < Sk) a = __fadd_rn(a, __ldg(mr));
          if (key + 1 < Sk) c = __fadd_rn(c, __ldg(mr + 1));
        }
      }
      x[4 * h + 2 * r] = key < Sk ? a : -INFINITY;
      x[4 * h + 2 * r + 1] = key + 1 < Sk ? c : -INFINITY;
    }
  }
}

// part += p v over one 16-key step: p the thread's values in tp_load_step's
// layout, rounded to bf16 as m16n8k16's A fragment; V 16 keys x 64 lanes
// ([*][LD], key 0 at Vt) read transposed
__device__ __forceinline__ void tp_pv_step(float (&part)[8][4], const float (&p)[8],
                                           const __nv_bfloat16* Vt, int lane) {
  const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]), pack_bf16(p[4], p[5]),
                          pack_bf16(p[6], p[7])};
  pv_step(part, pa, Vt, lane);
}

// the same in 3xTF32 over 32 lanes of fp32 V ([*][LD]): two m16n8k8 steps,
// k slot t being key 2 t and slot t + 4 key 2 t + 1 on both operands
__device__ __forceinline__ void tp_pv_step(float (&part)[4][4], const float (&p)[8],
                                           const float* Vt, int lane) {
  constexpr int LD = TpSlab<float>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    split_tf32(p[4 * h], ah[0], al[0]);      // row g, key 2t
    split_tf32(p[4 * h + 2], ah[1], al[1]);  // row g + 8, key 2t
    split_tf32(p[4 * h + 1], ah[2], al[2]);  // row g, key 2t + 1
    split_tf32(p[4 * h + 3], ah[3], al[3]);  // row g + 8, key 2t + 1
    const float* v0 = Vt + (8 * h + 2 * t) * LD + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(v0[8 * j], bh[j][0], bl[j][0]);
      split_tf32(v0[LD + 8 * j], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(part[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(part[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(part[j], ah, bh[j]);
  }
}

__device__ __forceinline__ void tp_store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void tp_store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The context lanes from the summed scores. Units as tp_scores_kernel's
// (a 64-row query tile, 4 warps of 16 rows; SHORT a problem a warp), the
// items (lane chunk c, key tile t), chunk by chunk. At a unit's first item
// each warp forms its rows' p: HOLD (at most one key tile), held in
// registers (p in fp32, rounded to bf16 as it enters the product); else the
// row max and sum over every key tile, p formed again per tile. A thread's
// context fragment o[j][e] is row g + 8 (e / 2) and lane 8 j + 2 t + e % 2
// of the chunk.
template <typename T, bool HOLD, bool SHORT>
__global__ void __launch_bounds__(TP_THREADS)
tp_pv_kernel(const float* __restrict__ s, const T* __restrict__ v, long long v_bs,
             long long v_ss, const float* __restrict__ mask, T* __restrict__ out, long long o_bs,
             long long o_ss, int B, int Sq, int Sk, int W, float scale, bool vec) {
  using G = TpPvGeo<SHORT>;
  constexpr int LD = TpSlab<T>::LD, LANES = TpSlab<T>::LANES, NJ = LANES / 8;
  constexpr int KS = G::K / 16;  // 16-key steps of a key tile
  constexpr int STAGE = G::K * LD, THREADS = SHORT ? 32 : TP_THREADS;
  static_assert(!SHORT || HOLD, "a short problem is one key tile");
  extern __shared__ __align__(16) unsigned char tpv_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  T* const ring = reinterpret_cast<T*>(tpv_smem) + (SHORT ? (size_t)warp * TP_STAGES * STAGE : 0);
  const int ntiles = (Sq + G::Q - 1) / G::Q, nkt = HOLD ? 1 : (Sk + G::K - 1) / G::K;
  const int nc = W / LANES, per = nc * nkt, ptid = SHORT ? lane : tid;
  const TpWalk walk =
      SHORT ? TpWalk{(long long)blockIdx.x * TP_WARPS + warp, (long long)gridDim.x * TP_WARPS, B,
                     per}
            : TpWalk{blockIdx.x, gridDim.x, (long long)B * ntiles, per};
  auto fetch = [&](long long n, int st) {
    const long long b = walk.unit(n) / ntiles;
    const int i = walk.index(n), c = i / nkt, t = i % nkt;
    tp_load_rows<G::K, THREADS>(ring + st * STAGE, v + b * v_bs, v_ss, t * G::K, Sk, c * LANES,
                                ptid);
  };
  float x[KS][8], mx[2], inv[2], o[NJ][4], part[NJ][4];
  const float* sb = s;
  int r0 = 0;
  // the scores of key tile t of the warp's rows, as p = exp(x - max) / sum
  // (the row max and 1 / sum known)
  auto probs = [&](float (&xs)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) xs[e] = expf(xs[e] - mx[(e >> 1) & 1]) * inv[(e >> 1) & 1];
  };
  auto softmax = [&]() {
    float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
    if constexpr (HOLD) {
#pragma unroll
      for (int h = 0; h < KS; ++h) {
        tp_load_step(x[h], sb, mask, r0, g, t4, Sq, Sk, 16 * h, scale, vec);
#pragma unroll
        for (int e = 0; e < 8; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], x[h][e]);
      }
      mx[0] = quad_max(m[0]);
      mx[1] = quad_max(m[1]);
#pragma unroll
      for (int h = 0; h < KS; ++h)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          x[h][e] = expf(x[h][e] - mx[(e >> 1) & 1]);
          sum[(e >> 1) & 1] += x[h][e];
        }
      inv[0] = 1.0f / quad_sum(sum[0]);
      inv[1] = 1.0f / quad_sum(sum[1]);
#pragma unroll
      for (int h = 0; h < KS; ++h)
#pragma unroll
        for (int e = 0; e < 8; ++e) x[h][e] *= inv[(e >> 1) & 1];
    } else {
      for (int kb = 0; kb < Sk; kb += 16) {
        tp_load_step(x[0], sb, mask, r0, g, t4, Sq, Sk, kb, scale, vec);
#pragma unroll
        for (int e = 0; e < 8; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], x[0][e]);
      }
      mx[0] = quad_max(m[0]);
      mx[1] = quad_max(m[1]);
      for (int kb = 0; kb < Sk; kb += 16) {
        tp_load_step(x[0], sb, mask, r0, g, t4, Sq, Sk, kb, scale, vec);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[(e >> 1) & 1] += expf(x[0][e] - mx[(e >> 1) & 1]);
      }
      inv[0] = 1.0f / quad_sum(sum[0]);
      inv[1] = 1.0f / quad_sum(sum[1]);
    }
  };
  auto use = [&](long long n, int st) {
    const long long u = walk.unit(n), b = u / ntiles;
    const int i = walk.index(n), c = i / nkt, t = i % nkt;
    r0 = (int)(u % ntiles) * G::Q + (SHORT ? 0 : warp * 16);
    if (r0 >= Sq) return;  // rows past Sq: this warp only copies
    sb = s + b * (long long)Sq * Sk;
    if (i == 0) softmax();
    const T* Vt = ring + st * STAGE;
    tp_zero(part);
    if constexpr (HOLD) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) tp_pv_step(part, x[ks], Vt + ks * 16 * LD, lane);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        tp_load_step(x[0], sb, mask, r0, g, t4, Sq, Sk, t * G::K + 16 * ks, scale, vec);
        probs(x[0]);
        tp_pv_step(part, x[0], Vt + ks * 16 * LD, lane);
      }
    }
    if (t == 0) tp_zero(o);
    tp_fold(o, part);
    if (t != nkt - 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= Sq) continue;
      T* orow = out + b * o_bs + (long long)row * o_ss + c * LANES + 2 * t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j) tp_store_pair(orow + 8 * j, o[j][2 * r], o[j][2 * r + 1]);
    }
  };
  if constexpr (SHORT)
    tp_ring<TP_STAGES>(walk.items(), fetch, use, [] { __syncwarp(); });
  else
    tp_ring<TP_STAGES>(walk.items(), fetch, use, [] { __syncthreads(); });
}

// As many blocks of Kernel (TP_THREADS threads, smem bytes) as the card
// holds at once, at most needed. Read once per kernel.
template <auto Kernel>
inline unsigned tp_blocks(size_t smem, long long needed) {
  static const long long resident = [&] {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, TP_THREADS, smem);
    return (long long)sms * (per_sm > 0 ? per_sm : 1);
  }();
  return (unsigned)(needed < resident ? needed : resident);
}

// a 16-byte aligned operand whose batch and row strides are whole 16 bytes
template <typename T> inline bool tp_operand(const T* p, long long bs, long long ss) {
  constexpr long long PER = 16 / (long long)sizeof(T);
  return !(reinterpret_cast<uintptr_t>(p) & 15) && !(bs % PER) && !(ss % PER);
}

template <typename T, bool SHORT>
inline cudaError_t launch_tp_scores(const T* q, long long q_bs, long long q_ss, const T* k,
                                    long long k_bs, long long k_ss, float* s, int B, int Sq,
                                    int Sk, int W, cudaStream_t stream) {
  using G = TpScoresGeo<SHORT>;
  const long long needed = SHORT ? ((long long)B + TP_WARPS - 1) / TP_WARPS
                                 : (long long)B * ((Sq + G::Q - 1) / G::Q);
  const unsigned blocks = tp_blocks<tp_scores_kernel<T, SHORT> >(G::SMEM, needed);
  tp_scores_kernel<T, SHORT><<<blocks, TP_THREADS, G::SMEM, stream>>>(
      q, q_bs, q_ss, k, k_bs, k_ss, s, B, Sq, Sk, W, Sk % 2 == 0);
  return cudaGetLastError();
}

// s [B, Sq, Sk] fp32 contiguous from q [B, Sq, W] and k [B, Sk, W] (unit
// stride along W), W a multiple of TpSlab<T>::LANES
template <typename T>
inline cudaError_t attention_tp_scores(const T* q, long long q_bs, long long q_ss, const T* k,
                                       long long k_bs, long long k_ss, float* s, int B, int Sq,
                                       int Sk, int W, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (W <= 0 || W % TpSlab<T>::LANES || !tp_operand(q, q_bs, q_ss) || !tp_operand(k, k_bs, k_ss) ||
      (reinterpret_cast<uintptr_t>(s) & 7))
    return cudaErrorInvalidValue;
  if (tp_short(Sq, Sk))
    return launch_tp_scores<T, true>(q, q_bs, q_ss, k, k_bs, k_ss, s, B, Sq, Sk, W, stream);
  return launch_tp_scores<T, false>(q, q_bs, q_ss, k, k_bs, k_ss, s, B, Sq, Sk, W, stream);
}

template <typename T, bool HOLD, bool SHORT>
inline cudaError_t launch_tp_pv(const float* s, const T* v, long long v_bs, long long v_ss,
                                const float* mask, T* out, long long o_bs, long long o_ss, int B,
                                int Sq, int Sk, int W, float scale, cudaStream_t stream) {
  using G = TpPvGeo<SHORT>;
  const long long needed = SHORT ? ((long long)B + TP_WARPS - 1) / TP_WARPS
                                 : (long long)B * ((Sq + G::Q - 1) / G::Q);
  const bool vec = Sk % 2 == 0 && !(reinterpret_cast<uintptr_t>(s) & 7);
  const unsigned blocks = tp_blocks<tp_pv_kernel<T, HOLD, SHORT> >(G::SMEM, needed);
  tp_pv_kernel<T, HOLD, SHORT><<<blocks, TP_THREADS, G::SMEM, stream>>>(
      s, v, v_bs, v_ss, mask, out, o_bs, o_ss, B, Sq, Sk, W, scale, vec);
  return cudaGetLastError();
}

// out [B, Sq, W] from the summed scores s [B, Sq, Sk] (contiguous fp32), v
// [B, Sk, W] (unit stride along W) and an additive [Sq, Sk] fp32 mask or
// null; W a multiple of TpSlab<T>::LANES, v and out as tp_operand says
template <typename T>
inline cudaError_t attention_tp_pv(const float* s, const T* v, long long v_bs, long long v_ss,
                                   const float* mask, T* out, long long o_bs, long long o_ss,
                                   int B, int Sq, int Sk, int W, float scale,
                                   cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || W <= 0) return cudaSuccess;
  if (Sk <= 0 || W % TpSlab<T>::LANES || !tp_operand(v, v_bs, v_ss) ||
      !tp_operand<T>(out, o_bs, o_ss))
    return cudaErrorInvalidValue;
  if (tp_short(Sq, Sk))
    return launch_tp_pv<T, true, true>(s, v, v_bs, v_ss, mask, out, o_bs, o_ss, B, Sq, Sk, W,
                                       scale, stream);
  if (Sk <= TP_ROWS)
    return launch_tp_pv<T, true, false>(s, v, v_bs, v_ss, mask, out, o_bs, o_ss, B, Sq, Sk, W,
                                        scale, stream);
  return launch_tp_pv<T, false, false>(s, v, v_bs, v_ss, mask, out, o_bs, o_ss, B, Sq, Sk, W,
                                       scale, stream);
}

}  // namespace
}  // namespace qt
