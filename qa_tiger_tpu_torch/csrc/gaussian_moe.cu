// fused_gaussian_moe: out[b] = sum_e sum_t w[b,e,t] * MLP_e(x[b,t]) with
// MLP_e = Linear(D->H) -> ReLU -> Linear(H->D), T contracted before the
// second Linear:
//   s[b, e, :] = sum_t w[b,e,t] relu(x[b,t] W1_e + b1_e)        (fp32)
//   out[b]     = sum_e s[b,e,:] W2_e + (sum_t w[b,e,t]) b2_e      (fp32, cast once)
//
// Replaces qa_tiger_tpu/ops/pallas/gaussian_moe.py:_pallas_impl (_kernel).
//
// Bound on the H100: operations. The first Linear over every (b, t, e) is
// one product of M = B*T rows, N = E*H columns and K = D: 56 GFLOP at B=512,
// T=60, D=512, H=256, E=7 (57 us at the bf16 tensor-core peak, 989 TFLOP/s)
// against a few MB of x and weights; the second is 1/60 of it. In fp32
// (the train step, B = 32 and 64) the 3xTF32 rate, 494.7 / 3 = 164.9
// TFLOP/s, bounds it. Two launches, no atomics, no [B, T, E, D] tensor:
//   1. the [B*T, E*H] product with its epilogue, one block per pair of
//      samples (and, where pairs are fewer than the SMs, per share of the
//      E*H columns): each 64-row tile of the product is one sample's T
//      chunk, so the weighted sum over t completes inside the block and no
//      partial sum crosses blocks (bitwise repeatable). The epilogue adds
//      b1, applies the ReLU, weights row t by w[b, e(n), t] (rows past T
//      weigh 0: relu(0 + b1) is not 0), sums the tile's rows (warp
//      shuffles, then a shared-memory pass across a warpgroup's warps) and
//      carries the sum over T chunks in registers; s[b, :] is stored once
//      in fp32, wsum[b, e] = sum_t w[b,e,t] once.
//      - bf16 (route "wgmma"): TMA + wgmma. Each consumer warpgroup owns one
//        sample; its T chunk of x (64 rows x D <= 512) is loaded by TMA
//        through a 3-D tensor map over (D, T, B) whose box runs past T and
//        is zero-filled, and stays in shared memory while the block walks
//        W1^T ([E*H, D], K-major) in 128-column tiles through a 4-stage
//        mbarrier ring fed by one producer warp; both warpgroups run
//        wgmma.m64n128k16 on the same W1 tile, so W1 is read once per pair
//        of samples (from L2) and x once from HBM.
//      - fp32 (route "tf32x3", and bf16 with D > 512 on widened copies):
//        a 3xTF32 tile on mma.sync (cp.async into padded tiles, the per-slab
//        IEEE fold of gemm_tf32x3), 128 rows = two samples' 64-row chunks,
//        128 columns; a warp's 64 rows are one sample's chunk, so its
//        shuffles finish the sum.
//   2. out = s W2 + sum_e wsum[b,e] b2_e: gemm_tf32x3 (fp32 A, W2 in fp32,
//      the wrapper's split-K plan; 3xTF32 on its Hopper kernel, TMA +
//      wgmma), the bias term and the cast in its epilogue.
// Under tensor parallelism (parallel/tensor.py) each model rank holds H/tp of
// every expert's hidden columns (w1, b1 and w2's rows) and launches the same
// two products over N = E*H/tp with out_f32: an fp32 partial [B, D] with a
// zero b2 (the caller adds b2's term to the sum over the ranks, on every
// rank alike, and rounds once). At tp = 4 N = 448 leaves a ragged last
// 128-column tile: TMA zero-fills W1 past N and the epilogue masks n >= N.
#include "gemm_tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MOE_ROWS = 64;   // rows of one sample's T chunk: one wgmma row tile
constexpr int MOE_BN = 128;    // W1^T rows (columns of the product) per tile
constexpr int MOE_BK = 64;     // K slab: 64 bf16, one 128-byte swizzle row
constexpr int MOE_STAGES = 4;
constexpr int MOE_MAX_D = 512;  // both samples' x chunks stay in shared memory
// two consumer warpgroups (threads 0-255), then one producer warp
constexpr int MOE_THREADS = 288, MOE_PRODUCER = 256;
constexpr int MOE_A_SLAB = MOE_ROWS * MOE_BK * 2;     // 8 KB
constexpr int MOE_B_STAGE = MOE_BN * MOE_BK * 2;      // 16 KB

// The fp32 hidden product's 3xTF32 tile (route "tf32x3"): 128 rows by
// MOE_BN columns, K slabs of MOE_TF_BK through a cp.async ring of
// MOE_TF_STAGES stages, 8 warps of 64 x 32 each. A shared-memory tile holds
// 128 rows (x's rows or W1^T's) by MOE_TF_BK k, rows padded by 4 floats.
constexpr int MOE_TF_BK = 32, MOE_TF_STAGES = 3, MOE_TF_THREADS = 256;
constexpr int MOE_TF_LD = MOE_TF_BK + 4, MOE_TF_TILE = 128 * MOE_TF_LD;
__device__ __forceinline__ int moe_tf_at(int r, int k) { return r * MOE_TF_LD + k; }

// the resident x chunks (two samples x kt slabs), the W1 ring, the
// cross-warp sums (2 warpgroups x 4 warps x MOE_BN), the barriers, and 1 KB
// of slack to align the swizzled tiles to 1 KB
inline int moe_wgmma_smem(int kt) {
  return 1024 + 2 * kt * MOE_A_SLAB + MOE_STAGES * MOE_B_STAGE + 8 * MOE_BN * 4 +
         (2 * MOE_STAGES + 2) * 8;
}

struct MoeShape {
  int B, T, D, H, E, N;  // N = E * H
  int kt;                // K slabs (wgmma)
  int chunks;            // T chunks of MOE_ROWS
  int tiles;             // column tiles over N
  int per;               // column tiles per block along grid y
  long long lds;         // row stride of s
};

// one 3-D box (c0 innermost) into shared memory, completion counted on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(qt::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(qt::smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the 128 threads of consumer warpgroup wg (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// the expert of column n, for columns visited in increasing order: e and
// its end nb = (e + 1) H move forward, no division
__device__ __forceinline__ int expert_of(int n, int H, int& e, int& nb) {
  while (n >= nb) {
    ++e;
    nb += H;
  }
  return e;
}

// *out = sum_t wr[t], in order
template <typename T> __device__ __forceinline__ void write_wsum(const T* wr, float* out, int T_) {
  float acc = 0.0f;
  for (int i = 0; i < T_; ++i) acc += qt::to_f<T>(wr[i]);
  *out = acc;
}

// The bf16 hidden product: blockIdx.x a pair of samples (one per consumer
// warpgroup), blockIdx.y a share of `per` column tiles.
__global__ void __launch_bounds__(MOE_THREADS, 1)
moe_hidden_wgmma(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ b1,
                 const bf16* __restrict__ w, float* __restrict__ s, float* __restrict__ wsum,
                 MoeShape sh) {
  extern __shared__ unsigned char moe_smem[];
  unsigned char* base = moe_smem + ((1024 - (qt::smem_addr(moe_smem) & 1023)) & 1023);
  unsigned char* a_sm = base;  // [sample][kt] slabs of 64 rows x 64 bf16
  unsigned char* ring = a_sm + 2 * sh.kt * MOE_A_SLAB;
  float* red = reinterpret_cast<float*>(ring + MOE_STAGES * MOE_B_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * MOE_BN);
  uint64_t* empty = full + MOE_STAGES;
  uint64_t* a_full = empty + MOE_STAGES;
  uint64_t* a_empty = a_full + 1;

  const int b0 = 2 * blockIdx.x;
  const int nt0 = blockIdx.y * sh.per;
  const int nt1 = min(sh.tiles, nt0 + sh.per);
  // x chunks are loaded once when T fits one chunk, else per (tile, chunk)
  const bool reload = sh.chunks > 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < MOE_STAGES; ++i) {
      qt::mbar_init(&full[i], 1);
      qt::mbar_init(&empty[i], 2);
    }
    qt::mbar_init(a_full, 1);
    qt::mbar_init(a_empty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int stage = 0, phase = 0, aphase = 0;
  auto advance = [&]() {
    if (++stage == MOE_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (threadIdx.x >= MOE_PRODUCER) {
    if (threadIdx.x == MOE_PRODUCER) {
      for (int nt = nt0; nt < nt1; ++nt)
        for (int c = 0; c < sh.chunks; ++c) {
          if (reload || nt == nt0) {
            qt::mbar_wait(a_empty, aphase ^ 1);  // the first load passes at once
            qt::mbar_expect_tx(a_full, 2 * sh.kt * MOE_A_SLAB);
            for (int g = 0; g < 2; ++g) {
              const int b = min(b0 + g, sh.B - 1);  // a missing second sample repeats the first
              for (int kt = 0; kt < sh.kt; ++kt)
                tma_load_3d(a_sm + (g * sh.kt + kt) * MOE_A_SLAB, &map_x, a_full, kt * MOE_BK,
                            c * MOE_ROWS, b);
            }
            aphase ^= 1;
          }
          for (int kt = 0; kt < sh.kt; ++kt) {
            qt::mbar_wait(&empty[stage], phase ^ 1);
            qt::mbar_expect_tx(&full[stage], MOE_B_STAGE);
            qt::tma_load_2d(ring + stage * MOE_B_STAGE, &map_w, &full[stage], kt * MOE_BK,
                            nt * MOE_BN);
            advance();
          }
        }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int b = b0 + wg;
  const bool active = b < sh.B, signals = t == 0;
  const bf16* wb = w + (long long)min(b, sh.B - 1) * sh.E * sh.T;
  if (blockIdx.y == 0 && active && t < sh.E)
    write_wsum(wb + (long long)t * sh.T, wsum + (long long)b * sh.E + t, sh.T);

  // d[i] of thread (warp, lane) is row 16 warp + lane / 4 + 8 ((i / 2) % 2)
  // of the 64 and column 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile
  const int q = lane & 3, rw = warp * 16 + (lane >> 2);
  const unsigned char* a_wg = a_sm + wg * sh.kt * MOE_A_SLAB;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int nt = nt0; nt < nt1; ++nt) {
    const int n0 = nt * MOE_BN;
    float part[32];  // column sums of this thread's two rows, over the T chunks
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.0f;
    for (int c = 0; c < sh.chunks; ++c) {
      if (reload || nt == nt0) {
        qt::mbar_wait(a_full, aphase);
        aphase ^= 1;
      }
      int prev = 0;
      for (int kt = 0; kt < sh.kt; ++kt) {
        qt::mbar_wait(&full[stage], phase);
        const uint64_t da = qt::sw128_desc(a_wg + kt * MOE_A_SLAB);
        const uint64_t db = qt::sw128_desc(ring + stage * MOE_B_STAGE);
        qt::fence_regs(d);
        qt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < MOE_BK / 16; ++kk)
          qt::wgmma_m64n128k16(d, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        qt::wgmma_commit();
        qt::wgmma_wait<1>();
        qt::fence_regs(d);
        if (kt > 0 && signals) qt::mbar_arrive(&empty[prev]);
        prev = stage;
        advance();
      }
      qt::wgmma_wait<0>();
      qt::fence_regs(d);
      if (signals) {
        qt::mbar_arrive(&empty[prev]);
        if (reload) qt::mbar_arrive(a_empty);
      }
      // + b1, ReLU, x w[b, e, t], summed over this thread's two rows
      const int t0 = c * MOE_ROWS + rw, t1 = t0 + 8;
      int e = n0 / sh.H, nb = (e + 1) * sh.H, ew = -1;
      float w0 = 0.0f, w1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int n = n0 + 8 * j + 2 * q + p;
          if (n < sh.N) {
            if (expert_of(n, sh.H, e, nb) != ew) {
              ew = e;
              const bf16* we = wb + (long long)e * sh.T;
              w0 = t0 < sh.T ? qt::to_f<bf16>(we[t0]) : 0.0f;
              w1 = t1 < sh.T ? qt::to_f<bf16>(we[t1]) : 0.0f;
            }
            const float bias = qt::to_f<bf16>(b1[n]);
            part[2 * j + p] = fmaf(w0, fmaxf(d[4 * j + p] + bias, 0.0f), part[2 * j + p]);
            part[2 * j + p] = fmaf(w1, fmaxf(d[4 * j + 2 + p] + bias, 0.0f), part[2 * j + p]);
          }
        }
    }
    // the sum over the warp's 16 rows (lanes of one lane % 4), then over the
    // warpgroup's four warps in a fixed order
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], 4);
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], 8);
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], 16);
    }
    float* mine = red + (wg * 4 + warp) * MOE_BN;
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mine[8 * j + 2 * q] = part[2 * j];
        mine[8 * j + 2 * q + 1] = part[2 * j + 1];
      }
    }
    wg_sync(wg);
    const float* sums = red + wg * 4 * MOE_BN;
    if (active && n0 + t < sh.N)
      s[(long long)b * sh.lds + n0 + t] =
          ((sums[t] + sums[MOE_BN + t]) + sums[2 * MOE_BN + t]) + sums[3 * MOE_BN + t];
    wg_sync(wg);
  }
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (bytes 0: nothing is read)
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(qt::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows [0, 128) of an fp32 x tile: row r is t = t0 + r % 64 of sample
// b0 + r / 64, k in [k0, k0 + MOE_TF_BK); rows past T or B and k past D are 0.
__device__ __forceinline__ void moe_load_x(float* sa, const float* __restrict__ x, int D, int b0,
                                           int B, int t0, int T, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * MOE_TF_THREADS;
    const int r = c >> 3, k = (c & 7) * 4;
    const int bb = b0 + (r >> 6), tt = t0 + (r & 63), gk = k0 + k;
    const float* src = x;
    int bytes = 0;
    if (bb < B && tt < T && gk < D) {
      const int left = D - gk;
      bytes = (left < 4 ? left : 4) * 4;
      src = x + ((long long)bb * T + tt) * D + gk;
    }
    cp_async16_n(sa + moe_tf_at(r, k), src, bytes);
  }
}

// Rows [n0, n0 + 128) x k [k0, k0 + MOE_TF_BK) of W1^T [N, D] into a tile;
// rows >= N and k >= D are zero. 1024 chunks of 4 floats, four per thread.
__device__ __forceinline__ void moe_load_w1(float* sb, const float* __restrict__ w1, int D,
                                            int n0, int N, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * MOE_TF_THREADS;
    const int r = c >> 3, k = (c & 7) * 4;
    const int gr = n0 + r, gk = k0 + k;
    const float* src = w1;
    int bytes = 0;
    if (gr < N && gk < D) {
      const int left = D - gk;
      bytes = (left < 4 ? left : 4) * 4;
      src = w1 + (long long)gr * D + gk;
    }
    cp_async16_n(sb + moe_tf_at(r, k), src, bytes);
  }
}

// One K slab of a warp's 64 x 32 share of the tile: the slab's 3xTF32 sums
// into a fresh fragment, folded into the fp32 accumulator acc with IEEE
// adds. As and Bs hold the slab's x rows (m) and W1^T rows (n); warp
// offsets wm, wn, g = lane / 4, t = lane % 4.
__device__ __forceinline__ void moe_tf32x3_slab(float (&acc)[4][4][4], const float* As,
                                                const float* Bs, int wm, int wn, int g, int t) {
  float part[4][4][4];  // this slab's sums, on the tensor cores
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < MOE_TF_BK; kk += 8) {
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + i * 16 + g;
      qt::split_tf32(As[moe_tf_at(r, kk + t)], ah[i][0], al[i][0]);
      qt::split_tf32(As[moe_tf_at(r + 8, kk + t)], ah[i][1], al[i][1]);
      qt::split_tf32(As[moe_tf_at(r, kk + t + 4)], ah[i][2], al[i][2]);
      qt::split_tf32(As[moe_tf_at(r + 8, kk + t + 4)], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + j * 8 + g;
      qt::split_tf32(Bs[moe_tf_at(c, kk + t)], bh[j][0], bl[j][0]);
      qt::split_tf32(Bs[moe_tf_at(c, kk + t + 4)], bh[j][1], bl[j][1]);
    }
    // one pass over all 16 fragments at a time, so that two products on
    // the same accumulator are 16 instructions apart, not back to back
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qt::mma_tf32(part[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qt::mma_tf32(part[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qt::mma_tf32(part[i][j], ah[i], bh[j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// The fp32 hidden product on 3xTF32: blockIdx.x a 128-column tile,
// blockIdx.y a pair of samples; warps 0-3 own the first sample's rows, 4-7
// the second's. TE is the type of b1 and w.
template <typename TE>
__global__ void __launch_bounds__(MOE_TF_THREADS)
moe_hidden_tf32x3(const float* __restrict__ x, const float* __restrict__ w1,
                  const TE* __restrict__ b1, const TE* __restrict__ w, float* __restrict__ s,
                  float* __restrict__ wsum, MoeShape sh) {
  extern __shared__ __align__(16) float moe_tf_smem[];
  constexpr int STAGE = 2 * MOE_TF_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * MOE_BN, b0 = 2 * blockIdx.y;
  const int b = b0 + (warp >> 2);

  if (blockIdx.x == 0 && tid < 2 * sh.E) {
    const int bb = b0 + tid / sh.E, e = tid % sh.E;
    if (bb < sh.B)
      write_wsum(w + ((long long)bb * sh.E + e) * sh.T, wsum + (long long)bb * sh.E + e, sh.T);
  }
  // this thread's eight columns: n0 + wn + 8 j + 2 t + p
  int ecol[4][2];
  float bcol[4][2], part[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n = n0 + wn + 8 * j + 2 * t + p;
      ecol[j][p] = n < sh.N ? n / sh.H : 0;
      bcol[j][p] = n < sh.N ? qt::to_f<TE>(b1[n]) : 0.0f;
      part[j][p] = 0.0f;
    }
  const TE* wb = w + (long long)min(b, sh.B - 1) * sh.E * sh.T;
  const int nk = (sh.D + MOE_TF_BK - 1) / MOE_TF_BK;
  for (int c = 0; c < sh.chunks; ++c) {
    const int c0 = c * MOE_ROWS;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    auto load = [&](int st, int kt) {
      float* sa = moe_tf_smem + st * STAGE;
      const int k0 = kt * MOE_TF_BK;
      moe_load_x(sa, x, sh.D, b0, sh.B, c0, sh.T, k0, tid);
      moe_load_w1(sa + MOE_TF_TILE, w1, sh.D, n0, sh.N, k0, tid);
    };
#pragma unroll
    for (int st = 0; st < MOE_TF_STAGES - 1; ++st) {
      if (st < nk) load(st, st);
      qt::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      qt::cp_async_wait<MOE_TF_STAGES - 2>();
      __syncthreads();  // slab kt has landed; every warp is done with slab kt - 1
      if (kt + MOE_TF_STAGES - 1 < nk)
        load((kt + MOE_TF_STAGES - 1) % MOE_TF_STAGES, kt + MOE_TF_STAGES - 1);
      qt::cp_async_commit();
      const float* As = moe_tf_smem + (kt % MOE_TF_STAGES) * STAGE;
      moe_tf32x3_slab(acc, As, As + MOE_TF_TILE, wm, wn, g, t);
    }
    qt::cp_async_wait<0>();
    __syncthreads();  // the next chunk's first loads overwrite the stages
    // + b1, ReLU, x w[b, e, t], summed over this thread's eight rows;
    // acc[i][j][2 h + p] is row 16 i + g + 8 h, column 8 j + 2 t + p
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tt = c0 + 16 * i + g + 8 * h;
        if (tt < sh.T) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const float wt = qt::to_f<TE>(wb[(long long)ecol[j][p] * sh.T + tt]);
              part[j][p] = fmaf(wt, fmaxf(acc[i][j][2 * h + p] + bcol[j][p], 0.0f), part[j][p]);
            }
        }
      }
  }
  // the sum over the warp's 64 rows: lanes of one t
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v = part[j][p];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      const int n = n0 + wn + 8 * j + 2 * t + p;
      if (g == 0 && b < sh.B && n < sh.N) s[(long long)b * sh.lds + n] = v;
    }
}

// out[b, n] = acc + sum_e wsum[b, e] b2[e, n], cast once to TO (T, or fp32
// for a tensor-parallel partial); applied by gemm_tf32x3's split-K pass
// alone, at one chunk too (after_pass)
template <typename T, typename TO> struct EpiMoeOut {
  static constexpr bool after_pass = true;
  TO* out;
  const float* wsum;
  const T* b2;
  int D, E;
  __device__ void operator()(int m, int n, float acc) const {
    for (int e = 0; e < E; ++e)
      acc = fmaf(wsum[(long long)m * E + e], qt::to_f<T>(b2[(long long)e * D + n]), acc);
    out[(long long)m * D + n] = qt::from_f<TO>(acc);
  }
};

// the map of x [B, T, D] bf16 in boxes of 64 columns x 64 rows of one
// sample, 128-byte swizzle, zero past T (and past B or D)
bool x_tensor_map(CUtensorMap* map, const bf16* x, int B, int T, int D) {
  const qt::EncodeTiled encode = qt::encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16), (cuuint64_t)T * D * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)MOE_BK, (cuuint32_t)MOE_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t hidden_wgmma(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w, float* s,
                         float* wsum, MoeShape sh, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1);
  if (sh.D > MOE_MAX_D || sh.D % 8 || (ptrs & 15)) return cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  if (!x_tensor_map(&map_x, x, sh.B, sh.T, sh.D) ||
      !qt::tensor_map_2d(&map_w, w1, sh.D, sh.N, sh.D, MOE_BN))
    return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_hidden_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        moe_wgmma_smem(MOE_MAX_D / MOE_BK));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((sh.B + 1) / 2, (sh.tiles + sh.per - 1) / sh.per);
  moe_hidden_wgmma<<<grid, MOE_THREADS, moe_wgmma_smem(sh.kt), stream>>>(map_x, map_w, b1, w, s,
                                                                        wsum, sh);
  return cudaGetLastError();
}

template <typename TE>
cudaError_t hidden_tf32x3(const float* x, const float* w1, const TE* b1, const TE* w, float* s,
                          float* wsum, MoeShape sh, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1);
  if (sh.D % 4 || (ptrs & 15)) return cudaErrorInvalidValue;
  constexpr int SMEM = MOE_TF_STAGES * 2 * MOE_TF_TILE * (int)sizeof(float);
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_hidden_tf32x3<TE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const long long pairs = (sh.B + 1) / 2;
  if (pairs > 65535) return cudaErrorInvalidValue;
  const dim3 grid(sh.tiles, (unsigned)pairs);
  moe_hidden_tf32x3<TE><<<grid, MOE_TF_THREADS, SMEM, stream>>>(x, w1, b1, w, s, wsum, sh);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t run(int route, const void* x, const void* w1, const T* b1, const float* w2,
                long long ldw2, const T* b2, const T* w, float* s, long long lds, float* wsum,
                TO* out, float* ws, long long ws_floats, int chunk, int B, int T_, int D,
                int Dout, int H, int E, int sms, cudaStream_t stream) {
  if (B <= 0 || T_ <= 0 || D <= 0 || H <= 0 || E <= 0 || lds < (long long)E * H)
    return cudaErrorInvalidValue;
  MoeShape sh{B, T_, D, H, E, E * H, (D + MOE_BK - 1) / MOE_BK, (T_ + MOE_ROWS - 1) / MOE_ROWS,
              0, 0, lds};
  cudaError_t err;
  if (route == qt::GEMM_ROUTE_WGMMA) {
    if constexpr (std::is_same<T, bf16>::value) {
      sh.tiles = (sh.N + MOE_BN - 1) / MOE_BN;
      // the column tiles of a pair split over blocks where pairs are fewer
      // than the SMs
      const int pairs = (B + 1) / 2;
      int want = (sms + pairs - 1) / pairs;
      want = want < 1 ? 1 : (want > sh.tiles ? sh.tiles : want);
      sh.per = (sh.tiles + want - 1) / want;
      err = hidden_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1, w, s,
                         wsum, sh, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (route == qt::GEMM_ROUTE_TF32X3) {
    sh.tiles = (sh.N + MOE_BN - 1) / MOE_BN;
    err = hidden_tf32x3<T>(static_cast<const float*>(x), static_cast<const float*>(w1), b1, w, s,
                           wsum, sh, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  // the second Linear of every expert as one K = E*H product, fp32 A
  return qt::gemm_tf32x3<false, false>(s, lds, w2, ldw2, B, Dout, sh.N,
                                       EpiMoeOut<T, TO>{out, wsum, b2, Dout, E}, chunk, ws,
                                       ws_floats, stream);
}

}  // namespace

// dtype: the type of b1, b2, w and out (0 fp32, 1 bf16). route, a GemmRoute:
// GEMM_ROUTE_WGMMA takes x [B, T, D] and w1 = W1^T [E*H, D] in bf16, D <= 512
// and a multiple of 8; GEMM_ROUTE_TF32X3 takes both in fp32, D a multiple of
// 4. w2 [E*H, Dout] fp32, row stride ldw2; s [B, lds] and wsum [B, E] fp32
// scratch; out [B, Dout]; the second product's split-K chunk and workspace
// ws (ws_floats floats) from ops/gemm.py splitk_plan. out_f32: out is fp32
// whatever dtype (the tensor-parallel partial over the rank's H columns,
// summed over the model ranks before the one rounding).
extern "C" int qt_gaussian_moe(int dtype, int route, int out_f32, const void* x, const void* w1,
                               const void* b1, const void* w2, long long ldw2, const void* b2,
                               const void* w, void* s, long long lds, void* wsum, void* out,
                               void* ws, long long ws_floats, int chunk, int B, int T, int D,
                               int Dout, int H, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = qt::sm_count();
  if (!sms) return cudaErrorInvalidValue;
#define QT_MOE_ARGS(TY, TO)                                                                     \
  route, x, w1, static_cast<const TY*>(b1), static_cast<const float*>(w2), ldw2,                 \
      static_cast<const TY*>(b2), static_cast<const TY*>(w), static_cast<float*>(s), lds,        \
      static_cast<float*>(wsum), static_cast<TO*>(out), static_cast<float*>(ws), ws_floats,      \
      chunk, B, T, D, Dout, H, E, sms, st
  if (dtype == 0) return run<float, float>(QT_MOE_ARGS(float, float));
  if (out_f32) return run<bf16, float>(QT_MOE_ARGS(bf16, float));
  return run<bf16, bf16>(QT_MOE_ARGS(bf16, bf16));
#undef QT_MOE_ARGS
}
