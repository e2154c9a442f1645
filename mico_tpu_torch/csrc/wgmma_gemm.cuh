// The wgmma + TMA GEMM of K5's qkv projection, K8's two projections, K1's
// LayerNorm-prologue projection and P1's two products:
//   out (M, N) = A (M, K) . W (K, N) + bias
// A and W bf16 row-major, bias (N) fp32, out bf16. The products accumulate
// in fp32, the bias is added in fp32 in the epilogue and each output is
// rounded once to bf16: the rounding points of `_fused_qkv_attn_kernel`
// (mico_tpu/ops/flash_attention.py:1229), `_fused_qkv_attn_proj_kernel`
// (:1388) and `_fused_ln_qkv_attn_kernel` (:1567). In K1's instance
// (`ln_gemm_kernel`) A is the raw x and the operand is
//   xn = bf16(((x - mean) * rstd) * gamma + beta)
// from per-row fp32 (mean, rstd) that K1's statistics pass wrote, made in
// registers on the way into the tensor cores: xn never exists in global
// or shared memory.
//
// What bounds it on the H100: tensor-core operations (bigE's qkv product,
// M 28,784, K 1792, N 5376: 554.6 GFLOP, 0.561 ms at 989 TFLOP/s bf16,
// against 0.108 ms for its 361 MB of compulsory bytes; ViT-g's, K 1408, N
// 4224: 342.4 GFLOP, 0.346 ms).
//
// Design:
//  - persistent clusters of two CTAs (as many as the card holds at once, one
//    CTA an SM) walk the output tiles of 128 x BN; the cluster's CTAs take
//    the two row tiles of a pair with the same column tile, column tiles
//    fastest, so the CTAs in flight share a few row tiles of A through L2
//    and W stays L2-resident;
//  - one producer thread a CTA issues TMA loads into a ring of STAGES
//    stages (128-byte swizzle), each completing on its `full` mbarrier: its
//    own A tile (128 x 64), and half of the shared W tile (64 x BN), which
//    TMA multicasts to both CTAs of the cluster. That halves W's traffic
//    from L2, which at 48 KB a stage per CTA held the first version to 512
//    TFLOP/s. A stage is refilled once the consumers of both CTAs have
//    released it (`empty`, four arrivals, two of them remote); the ring
//    runs on across tiles;
//  - two consumer warpgroups each own 64 rows of the tile and run
//    wgmma.mma_async m64nBNk16 with W from shared memory. W (K, N)
//    row-major is MN-major for wgmma's B operand, which bf16 takes through
//    the descriptor's transpose bit: no transposed weight is made. A
//    consumer keeps one k-step of wgmmas in flight and frees the previous
//    stage when it retires;
//  - A: the plain GEMM reads it from shared memory too (SS wgmma). The LN
//    instance takes it from registers (RS wgmma): each consumer warp loads
//    its 16 rows of the raw x stage with ldmatrix in wgmma's A-fragment
//    layout, normalises them in fp32 with its two rows' (mean, rstd) and
//    the columns' (gamma, beta) (staged once in shared memory, (1, 0)
//    without the affine, (0, 0) past K: TMA fills x past K with zeros, which
//    would normalise to beta - mean * rstd * gamma) and rounds to bf16. The
//    RS wgmma reads its registers asynchronously, so k-step kt + 1's
//    fragments are made in a second register set while kt's wgmmas run,
//    and the k-loop runs in pairs (an even count of k-steps, a zero step
//    where K needs an odd one) so that each set is named at compile time
//    and no branch stands between the wgmmas of a step;
//  - the epilogue adds the bias, rounds to bf16 into a staging tile in
//    shared memory (swizzled, conflict-free) and hands it to TMA stores, so
//    the consumers go on to the next tile while the stores drain: stores
//    from registers took 40% of the GEMM's time;
//  - setmaxnreg moves registers from the producer warpgroup (40) to the
//    consumers (232: BN/2 accumulators a thread, and the LN instance's two
//    sets of 16 A registers);
//  - ragged edges: the tensor maps fill rows past M, columns past N and k
//    past K with zeros, and the TMA stores clip at M and N. Needs K % 8 == 0
//    and N % 8 == 0 (TMA's 16-byte strides), and K <= LN_COLS for the LN
//    instance.
// The epilogue is a compile-time choice (`Epi`): the bias above (K1, K5,
// K8), or P1's two (`epi_gemm_kernel`, no bias): the tanh GELU on the fp32
// accumulator, then one rounding (fc1), and one rounding of the product,
// then a bf16 add of the residual x read from global memory, rounded again
// (fc2: `mlp_kernel`'s bf16(y) + x).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace mico {
namespace wg {

// 128 x 256 tiles: 128 x 128 ones ran the bigE qkv product at 634 TFLOP/s
// against 758 (scripts/torch_qkv_bench.py, PERF.md)
constexpr int BM = 128, BN = 256, BK = 64;
constexpr int THREADS = 384;            // 2 consumer warpgroups + producer
constexpr int CLUSTER = 2;              // CTAs sharing each W tile
constexpr int RING_BYTES = 147456;      // 144 KB of stages (3 at BN 256)

constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE = A_BYTES + BK * BN * 2;
constexpr int STAGES = RING_BYTES / STAGE;
constexpr int C_BYTES = 64 * BN * 2;   // a warpgroup's output rows
constexpr int SMEM = STAGES * STAGE + 2 * C_BYTES + 2 * STAGES * 8 + 1024;
// the LN instance: K up to K1's statistics pass's 2048, with a (gamma,
// beta) pair of fp32 a column before the barriers
constexpr int LN_COLS = 2048;
constexpr int SMEM_LN = SMEM + LN_COLS * 8;


__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2],
                                          const unsigned char* a,
                                          const unsigned char* b, int first) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = hop::desc_sw128(a + kk * 32, 16, 1024);
    const uint64_t db = hop::desc_sw128(b + kk * 2048, BK * 128, 1024);
    hop::wgmma_ss_n256<1>(acc, da, db, !(first && kk == 0));
  }
}

// (x - mean) * rstd * gamma + beta of two neighbouring columns (g: their
// gamma, beta, gamma, beta) in fp32, rounded to bf16
__device__ __forceinline__ uint32_t ln_pair(uint32_t x, float mean, float rstd,
                                            float4 g) {
  const float2 f = unpack_bf16(x);
  return pack_bf16(fmaf((f.x - mean) * rstd, g.x, g.y),
                   fmaf((f.y - mean) * rstd, g.z, g.w));
}

// this warp's A fragments of one stage: its 16 rows (r = 16 warp + lane %
// 16 for ldmatrix) of the warpgroup's 64-row, 128-byte-swizzled x tile `at`
// over the stage's 64 columns, four k16 steps, normalised. gb: the stage's
// first column's (gamma, beta); rows g and g + 8 (g = lane / 4) of the
// warp take (m0, r0) and (m1, r1).
__device__ __forceinline__ void ln_fragments(uint32_t (&a)[4][4],
                                             const unsigned char* at,
                                             const float2* gb, float m0,
                                             float r0, float m1, float r1,
                                             int warp, int lane) {
  const int r = warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], at + r * 128 + (((2 * kk + (lane >> 4)) ^ (r & 7)) << 4));
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float4 g0 = *reinterpret_cast<const float4*>(gb + kk * 16 + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gb + kk * 16 + c + 8);
    a[kk][0] = ln_pair(a[kk][0], m0, r0, g0);
    a[kk][1] = ln_pair(a[kk][1], m1, r1, g0);
    a[kk][2] = ln_pair(a[kk][2], m0, r0, g1);
    a[kk][3] = ln_pair(a[kk][3], m1, r1, g1);
  }
}

// the epilogues: + bias (K1, K5, K8); P1's fc1, bf16(gelu_tanh(acc)); P1's
// fc2, bf16(bf16(acc) + x) with x (M, N) bf16 row-major; the fp32
// accumulator as it is (K8's partial out-projection on a tensor-parallel
// rank, summed over the ranks before its one rounding)
enum Epi { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_F32 = 3 };

// jax.nn.gelu(approximate=True) on fp32: 0.5 x (1 + tanh(sqrt(2/pi) (x +
// 0.044715 x^3))), with tanh.approx.f32 (relative error about 2^-11, under
// a quarter of the bf16 rounding that follows; `chip_smoke.py` holds the
// branch under the relative mean gate)
__device__ __forceinline__ float gelu_tanh(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n"
      : "=f"(t)
      : "f"(0.7978845608028654f * fmaf(0.044715f * x, x * x, x)));
  const float hx = 0.5f * x;
  return fmaf(hx, t, hx);
}

// bf16(bf16(y0) + x0), bf16(bf16(y1) + x1) of two neighbouring columns
__device__ __forceinline__ uint32_t residual_pair(float y0, float y1,
                                                  uint32_t x) {
  const float2 y = unpack_bf16(pack_bf16(y0, y1));
  const float2 r = unpack_bf16(x);
  return pack_bf16(y.x + r.x, y.y + r.y);
}

// the epilogue (+ bias in fp32, or P1's) with one rounding to bf16 into
// this warpgroup's staging rows (128-byte swizzle, conflict-free), then TMA
// stores that clip at M and N and run on while the next tile's products
// start
template <int EPI = EPI_BIAS>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                          unsigned char* cs,
                                          const CUtensorMap* tma_out,
                                          const float* __restrict__ bias,
                                          int N, int m0, int n0, int wgi,
                                          int tid, const bf16* res = nullptr,
                                          int M = 0) {
  const int warp = tid >> 5, lane = tid & 31;
  if constexpr (EPI == EPI_F32) {
    // fp32 (M, N) row-major at `res`, straight from the accumulators (no
    // staging: an fp32 tile of a warpgroup's rows would not fit beside the
    // ring): rows m and m + 8, two neighbouring columns every 8
    float* out = reinterpret_cast<float*>(const_cast<bf16*>(res));
    const int m = m0 + wgi * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < N && m < M)
        *reinterpret_cast<float2*>(out + (size_t)m * N + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (col < N && m + 8 < M)
        *reinterpret_cast<float2*>(out + (size_t)(m + 8) * N + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }
  if (tid == 0) hop::bulk_wait_read<0>();   // the last tile's stores
  hop::named_sync(1 + wgi, 128);
  const int rl = warp * 16 + (lane >> 2);
  if constexpr (EPI == EPI_RESIDUAL) {
    // x's rows m and m + 8 of this thread (columns past N and rows past M
    // read nothing: the stores clip them)
    const int m = m0 + wgi * 64 + rl;
    const bf16* x0 = res + (size_t)m * N + n0;
    const bf16* x1 = x0 + (size_t)8 * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const bool in = n0 + col < N;
      const uint32_t r0 =
          in && m < M ? *reinterpret_cast<const uint32_t*>(x0 + col) : 0u;
      const uint32_t r1 =
          in && m + 8 < M ? *reinterpret_cast<const uint32_t*>(x1 + col) : 0u;
      *reinterpret_cast<uint32_t*>(cs + hop::sw128_offset(rl, col, 8192)) =
          residual_pair(acc[4 * j], acc[4 * j + 1], r0);
      *reinterpret_cast<uint32_t*>(cs + hop::sw128_offset(rl + 8, col,
                                                          8192)) =
          residual_pair(acc[4 * j + 2], acc[4 * j + 3], r1);
    }
  } else if constexpr (EPI == EPI_GELU) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(cs + hop::sw128_offset(rl, col, 8192)) =
          pack_bf16(gelu_tanh(acc[4 * j]), gelu_tanh(acc[4 * j + 1]));
      *reinterpret_cast<uint32_t*>(cs + hop::sw128_offset(rl + 8, col,
                                                          8192)) =
          pack_bf16(gelu_tanh(acc[4 * j + 2]), gelu_tanh(acc[4 * j + 3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 bv = n0 + col < N
                            ? *reinterpret_cast<const float2*>(bias + n0 + col)
                            : make_float2(0.f, 0.f);
      *reinterpret_cast<uint32_t*>(cs + hop::sw128_offset(rl, col, 8192)) =
          pack_bf16(acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
      *reinterpret_cast<uint32_t*>(cs + hop::sw128_offset(rl + 8, col,
                                                          8192)) =
          pack_bf16(acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
    }
  }
  hop::fence_proxy_async();
  hop::named_sync(1 + wgi, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      hop::tma_store_2d(tma_out, cs + c * 8192, n0 + 64 * c, m0 + wgi * 64);
    hop::bulk_commit();
  }
}

// the kernels' body; under LN A is the raw x, normalised with stats (M) of
// (mean, rstd) and gamma/beta (K, read when affine) on its way into the
// tensor cores; EPI the epilogue (res: fc2's residual x)
template <bool LN, int EPI = EPI_BIAS>
__device__ __forceinline__ void gemm_body(const CUtensorMap& tma_a,
                                          const CUtensorMap& tma_w,
                                          const CUtensorMap& tma_out,
                                          const float* __restrict__ bias,
                                          int M, int N, int K,
                                          const float2* __restrict__ stats,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta,
                                          int affine,
                                          const bf16* res = nullptr) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* cstage = smem + STAGES * STAGE;   // [warpgroup]
  float2* gb = reinterpret_cast<float2*>(cstage + 2 * C_BYTES);   // LN
  uint64_t* full = reinterpret_cast<uint64_t*>(
      cstage + 2 * C_BYTES + (LN ? LN_COLS * 8 : 0));
  uint64_t* empty = full + STAGES;

  // the cluster's CTAs take consecutive row tiles of the same column tile:
  // tile group p -> (row group p / ntn, column tile p % ntn)
  const uint32_t rank = hop::cluster_rank();
  const int ntn = (N + BN - 1) / BN;
  const int npairs = ((M + CLUSTER * BM - 1) / (CLUSTER * BM)) * ntn;
  // LN's k-steps run in pairs: an even count, the last one past K (all
  // zeros) where K needs an odd one
  const int nk = LN ? ((K + BK - 1) / BK + 1) & ~1 : (K + BK - 1) / BK;
  const int first = blockIdx.x / CLUSTER, step = gridDim.x / CLUSTER;
  const int wgi = threadIdx.x / 128;

  if constexpr (LN) {
    for (int c = threadIdx.x; c < nk * BK; c += THREADS)
      gb[c] = c >= K ? make_float2(0.f, 0.f)
              : affine ? make_float2(gamma[c], beta[c])
                       : make_float2(1.f, 0.f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2 * CLUSTER);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  hop::cluster_sync();   // the peer's barriers exist before any multicast

  if (wgi == 2) {
    // producer warpgroup: one thread issues every load
    hop::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tma_a);
      hop::prefetch_map(&tma_w);
      int stage = 0, phase = 0;
      for (int p = first; p < npairs; p += step) {
        const int m0 = (CLUSTER * (p / ntn) + rank) * BM, n0 = (p % ntn) * BN;
        for (int kt = 0; kt < nk; ++kt) {
          // the stage is free in both CTAs: the W half lands in each
          hop::mbar_wait(&empty[stage], phase ^ 1);
          hop::mbar_expect_tx(&full[stage], STAGE);
          unsigned char* st = smem + stage * STAGE;
          hop::tma_load_2d(st, &tma_a, &full[stage], kt * BK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64 / CLUSTER; ++j) {
            const int box = rank * (BN / 64 / CLUSTER) + j;
            hop::tma_load_2d_mc(st + A_BYTES + box * BK * 128, &tma_w,
                                &full[stage], n0 + 64 * box, kt * BK,
                                (1 << CLUSTER) - 1);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // the tail: every stage released by both CTAs' consumers, so no
      // remote arrival reaches this CTA after it exits
      for (int i = 0; i < STAGES; ++i) {
        hop::mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // the pool: 384 x 168 registers = 2 x 128 x 232 + 128 x 40
    hop::setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    int stage = 0, phase = 0;
    auto release = [&](int s) {
      if (tid == 0)
        for (int r = 0; r < CLUSTER; ++r) hop::mbar_arrive_cluster(&empty[s], r);
    };
    auto advance = [&]() {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int p = first; p < npairs; p += step) {
      const int m0 = (CLUSTER * (p / ntn) + rank) * BM, n0 = (p % ntn) * BN;
      int prev = 0;
      if constexpr (!LN) {
        for (int kt = 0; kt < nk; ++kt) {
          hop::mbar_wait(&full[stage], phase);
          const unsigned char* st = smem + stage * STAGE;
          hop::fence_regs(acc);
          hop::wgmma_fence();
          mma_stage(acc, st + wgi * 64 * 128, st + A_BYTES, kt == 0);
          hop::wgmma_commit();
          if (kt > 0) {
            hop::wgmma_wait<1>();
            hop::fence_regs(acc);
            release(prev);
          }
          prev = stage;
          advance();
        }
      } else {
        // the statistics of this warp's rows g and g + 8 (zeros past M,
        // whose x TMA fills with zeros and whose outputs the stores clip)
        const int row = m0 + wgi * 64 + warp * 16 + (lane >> 2);
        const float2 s0 = row < M ? stats[row] : make_float2(0.f, 0.f);
        const float2 s1 = row + 8 < M ? stats[row + 8] : make_float2(0.f, 0.f);
        uint32_t a0[4][4], a1[4][4];
        auto fragments = [&](uint32_t (&a)[4][4], int kt) {
          hop::mbar_wait(&full[stage], phase);
          ln_fragments(a, smem + stage * STAGE + wgi * 64 * 128, gb + kt * BK,
                       s0.x, s0.y, s1.x, s1.y, warp, lane);
        };
        // k-step kt on `cur`, then k-step kt + 1's fragments into `nxt`
        // once kt - 1's wgmmas, the last to read `nxt`, have retired
        auto kstep = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4],
                         int kt) {
          const unsigned char* st = smem + stage * STAGE + A_BYTES;
          hop::fence_regs(acc);
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            hop::wgmma_rs_n256<1>(
                acc, cur[kk], hop::desc_sw128(st + kk * 2048, BK * 128, 1024),
                kt > 0 || kk > 0);
          hop::wgmma_commit();
          if (kt > 0) {
            hop::wgmma_wait<1>();
            hop::fence_regs(acc);
            release(prev);
          }
          prev = stage;
          advance();
          if (kt + 1 < nk) fragments(nxt, kt + 1);
        };
        fragments(a0, 0);
        for (int kt = 0; kt < nk; kt += 2) {
          kstep(a0, a1, kt);
          kstep(a1, a0, kt + 1);
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      release(prev);
      store_tile<EPI>(acc, cstage + wgi * C_BYTES, &tma_out, bias, N, m0, n0,
                      wgi, tid, res, M);
    }
    if (tid == 0) hop::bulk_wait<0>();
  }
}

__global__ void __launch_bounds__(THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_w,
                  const __grid_constant__ CUtensorMap tma_out,
                  const float* __restrict__ bias, int M, int N, int K) {
  gemm_body<false>(tma_a, tma_w, tma_out, bias, M, N, K, nullptr, nullptr,
                   nullptr, 0);
}

// K1's instance; a template, so that only a library that launches it
// compiles it
template <int = 0>
__global__ void __launch_bounds__(THREADS, 1)
ln_gemm_kernel(const __grid_constant__ CUtensorMap tma_x,
               const __grid_constant__ CUtensorMap tma_w,
               const __grid_constant__ CUtensorMap tma_out,
               const float* __restrict__ bias, int M, int N, int K,
               const float2* __restrict__ stats,
               const float* __restrict__ gamma,
               const float* __restrict__ beta, int affine) {
  gemm_body<true>(tma_x, tma_w, tma_out, bias, M, N, K, stats, gamma, beta,
                  affine);
}

// P1's instances (EPI_GELU, EPI_RESIDUAL); a template, so that only a
// library that launches them compiles them
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
epi_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_w,
                const __grid_constant__ CUtensorMap tma_out,
                const bf16* __restrict__ res, int M, int N, int K) {
  gemm_body<false, EPI>(tma_a, tma_w, tma_out, nullptr, M, N, K, nullptr,
                        nullptr, nullptr, 0, res);
}

// the tensor maps of a (M, K), w (K, N) and out (M, N)
static inline cudaError_t make_maps(CUtensorMap* ta, CUtensorMap* tw,
                                    CUtensorMap* tout, const bf16* a,
                                    const bf16* w, bf16* out, int M, int K,
                                    int N) {
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t astr[1] = {(cuuint64_t)K * 2};
  const cuuint32_t abox[2] = {BK, BM};
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t wstr[1] = {(cuuint64_t)N * 2};
  const cuuint32_t wbox[2] = {64, BK};
  const cuuint64_t odims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint32_t obox[2] = {64, 64};
  cudaError_t e = hop::make_map(ta, a, 2, adims, astr, abox);
  if (e != cudaSuccess) return e;
  e = hop::make_map(tw, w, 2, wdims, wstr, wbox);
  if (e != cudaSuccess) return e;
  return hop::make_map(tout, out, 2, odims, wstr, obox);
}

// launches `kernel` (one of the above: ID 0 the plain, 1 the LN, 2 + EPI
// P1's) on as many
// clusters of two as the card holds at once, at most one a pair of row
// tiles; the opt-in and that count are taken once per kernel and device
template <int ID>
static inline cudaError_t launch_clusters(const void* kernel, int smem, int M,
                                          int N, void** args,
                                          cudaStream_t stream) {
  static int clusters[hop::MAX_DEVICES] = {};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int held = dev < hop::MAX_DEVICES ? clusters[dev] : 0;
  if (held == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cfg.gridDim = dim3(CLUSTER);
    e = cudaOccupancyMaxActiveClusters(&held, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (held < 1) return cudaErrorInvalidConfiguration;
    if (dev < hop::MAX_DEVICES) clusters[dev] = held;
  }
  const int npairs =
      ((M + CLUSTER * BM - 1) / (CLUSTER * BM)) * ((N + BN - 1) / BN);
  cfg.gridDim = dim3(CLUSTER * (npairs < held ? npairs : held));
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

// out (M, N) = a (M, K) . w (K, N) + bias on `stream`
inline cudaError_t launch_gemm(const bf16* a, const bf16* w, const float* bias,
                               bf16* out, int M, int K, int N,
                               cudaStream_t stream) {
  if (K % 8 || N % 8 || M <= 0) return cudaErrorInvalidValue;
  CUtensorMap ta, tw, tout;
  cudaError_t e = make_maps(&ta, &tw, &tout, a, w, out, M, K, N);
  if (e != cudaSuccess) return e;
  void* args[] = {&ta, &tw, &tout, &bias, &M, &N, &K};
  return launch_clusters<0>((const void*)wgmma_gemm_kernel, SMEM, M, N,
                                args, stream);
}

// out (M, N) = LN(x) (M, K) . w (K, N) + bias on `stream`: stats (M) of
// (mean, rstd) in fp32, gamma/beta (K) fp32, read when affine
inline cudaError_t launch_ln_gemm(const bf16* x, const float2* stats,
                                  const float* gamma, const float* beta,
                                  int affine, const bf16* w, const float* bias,
                                  bf16* out, int M, int K, int N,
                                  cudaStream_t stream) {
  if (K % 8 || N % 8 || M <= 0 || K > LN_COLS) return cudaErrorInvalidValue;
  CUtensorMap tx, tw, tout;
  cudaError_t e = make_maps(&tx, &tw, &tout, x, w, out, M, K, N);
  if (e != cudaSuccess) return e;
  void* args[] = {&tx, &tw, &tout, &bias, &M, &N, &K,
                  &stats, &gamma, &beta, &affine};
  return launch_clusters<1>((const void*)ln_gemm_kernel<>, SMEM_LN, M, N,
                            args, stream);
}

// out (M, N) = epilogue(a (M, K) . w (K, N)) on `stream`, P1's two
// epilogues: EPI_GELU, or EPI_RESIDUAL with res (M, N) bf16 row-major; or
// EPI_F32, out (M, N) fp32 passed as res (and as out, whose tensor map it
// does not use)
template <int EPI>
inline cudaError_t launch_epi_gemm(const bf16* a, const bf16* w,
                                   const bf16* res, bf16* out, int M, int K,
                                   int N, cudaStream_t stream) {
  if (K % 8 || N % 8 || M <= 0) return cudaErrorInvalidValue;
  CUtensorMap ta, tw, tout;
  cudaError_t e = make_maps(&ta, &tw, &tout, a, w, out, M, K, N);
  if (e != cudaSuccess) return e;
  void* args[] = {&ta, &tw, &tout, &res, &M, &N, &K};
  return launch_clusters<2 + EPI>((const void*)epi_gemm_kernel<EPI>, SMEM, M,
                                  N, args, stream);
}

}  // namespace wg
}  // namespace mico
