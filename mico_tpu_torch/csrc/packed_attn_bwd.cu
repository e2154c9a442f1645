// K4: the gradient of K3, packed self-attention backward for ViT training.
//
// Replaces the TPU kernels `_packed_qkv_bwd` (mico_tpu/ops/flash_attention.py
// :1059, pallas_call :1070, kernel `_packed_qkv_bwd_kernel` :1023) and
// `_packed_bwd` (:1032, pallas_call :1040, kernel `_packed_bwd_kernel`
// :1017), both over the body `_packed_bwd_body` (:954). Per batch row and
// head, with the body's rounding points:
//   s  = q k^T in fp32, times scale * log2e
//   p  = exp2(s - rowmax) / rowsum, fp32, normalised BEFORE rounding
//   dv = bf16(p)^T g            dp = g v^T (fp32)
//   d  = rowsum(dp * p) over the unrounded p
//   ds = bf16(p * (dp - d) * scale)   (the true scale, no log2e)
//   dq = ds k                   dk = ds^T q
// every product accumulated in fp32 (mma.sync m16n8k16), every result
// written in bf16 at the q/k/v column offsets of its output rows.
//
// What bounds it on the H100: bytes. At the train step's vision pass
// (qkv (32, 257, 4224) and g (32, 257, 1408) bf16, 16 heads of 88) it reads
// 92.7 MB and writes 69.5 MB: 0.048 ms at 3.35 TB/s, against 29.8 GFLOP,
// 0.030 ms at 989 TFLOP/s.
//
// Design. The TPU body keeps one head's fp32 (L, L) scores whole in VMEM;
// at L = 257 they take 264 KB, more than an SM's 227 KB of shared memory.
// So the card takes the FlashAttention-2 split, two launches behind one C
// entry, each with one head's two L x D operands resident in shared memory
// (D = 88 zero-padded to 96 for the D contractions, rows past L zero-filled
// for the L contractions, keys past L masked with the finite -1e30):
//   (a) rows: grid (q-tiles of 96, H, B), 6 warps of 16 query rows, K and V
//       resident, the warp's q and g rows in registers as mma fragments.
//       Three passes over 16-key blocks recompute s (and dp): the row
//       maximum; then the row sum l and sum(dp * exp2(s - m)), whose ratio
//       is d; then p, ds and dq += ds k. m, l and d go to an fp32 (B, H, L)
//       buffer of float4.
//   (b) columns: grid (k-tiles of 96, H, B), 6 warps of 16 keys, q and g of
//       all rows resident, the warp's k and v rows in registers. One pass
//       over 16-query blocks recomputes s^T and dp^T, takes p and ds from
//       the row statistics, and accumulates dv += p^T g and dk += ds^T q.
// Scores, probabilities and ds never leave registers: they are re-packed
// from the accumulator layout as the A operand of the next product.
// wgmma, TMA and warp specialisation are left to later work.

#include "common.cuh"

namespace {
using namespace mico;

constexpr int BW = 6;          // warps per block
constexpr int BT = BW * 32;
constexpr int BR = BW * 16;    // rows (queries or keys) per block

// rows [r0, r0 + nrows) of a head's L x D operand (row stride ld, from
// `base`, the head's first column) into X with row stride KS*16 + 8,
// zero-filled past L and past D
template <int KS>
__device__ __forceinline__ void stage(bf16* X, const bf16* base, int ld,
                                      int r0, int nrows, int L, int D,
                                      int tid) {
  constexpr int KST = KS * 16 + 8, DV = KS * 2;
  const int dreal = D / 8;
  for (int i = tid; i < nrows * DV; i += BT) {
    const int r = i / DV, c = i % DV, row = r0 + r;
    const bool ok = row < L && c < dreal;
    cp_async_16(X + r * KST + c * 8, ok ? base + (size_t)row * ld + c * 8 : base,
                ok);
  }
}

// rows r0 (accumulator elements 0, 1) and r0 + 8 (elements 2, 3) of a
// 16 x D accumulator, bf16, at out + row * ld
template <int KS>
__device__ __forceinline__ void store_rows(bf16* out, int ld, int r0, int L,
                                           int NT, int t,
                                           const float (&acc)[2 * KS][4]) {
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    if (n < NT) {
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * ld + n * 8 + 2 * t) =
            pack_bf16(acc[n][0], acc[n][1]);
      if (r0 + 8 < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * ld + n * 8 +
                                     2 * t) = pack_bf16(acc[n][2], acc[n][3]);
    }
  }
}

// ------------------------------------------------------------- (a) rows
template <int KS>
__global__ void __launch_bounds__(BT)
bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ld, const bf16* __restrict__ g,
                float4* __restrict__ stats, bf16* __restrict__ dq, int ldo,
                int L, int H, int D, float scale) {
  constexpr int KST = KS * 16 + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) & ~15;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + Lp * KST;
  bf16* Ts = Vs + Lp * KST;   // staging: the q tile, then the g tile

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BR;
  const int W = H * D;
  const size_t off = (size_t)b * L * ld + (size_t)h * D;
  const bf16* gb = g + (size_t)b * L * W + (size_t)h * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage<KS>(Ts, q + off, ld, q0, BR, L, D, tid);
  stage<KS>(Ks, k + off, ld, 0, Lp, L, D, tid);
  stage<KS>(Vs, v + off, ld, 0, Lp, L, D, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
  load_a<KS>(qf, Ts, lane, warp * 16);
  __syncthreads();
  stage<KS>(Ts, gb, W, q0, BR, L, D, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t gf[KS][4];
  load_a<KS>(gf, Ts, lane, warp * 16);

  if (q0 + warp * 16 >= L) return;   // all 16 rows are padding; no barrier follows

  const int gr = lane >> 2, t = lane & 3;
  const int nkb = Lp / 16, NT = D / 8;
  const float qk2 = scale * LOG2E;

  auto scores = [&](int kb, float (&s)[2][4]) {
    mma_abt<KS>(s, qf, Ks, lane, kb * 16);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * 16 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key < L ? s[n][e] * qk2 : NEG_BIG;
      }
  };

  float m[2] = {NEG_BIG, NEG_BIG};   // rows gr and gr + 8
  for (int kb = 0; kb < nkb; ++kb) {
    float s[2][4];
    scores(kb, s);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  float l[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
  for (int kb = 0; kb < nkb; ++kb) {
    float s[2][4], dp[2][4];
    scores(kb, s);
    mma_abt<KS>(dp, gf, Vs, lane, kb * 16);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = fast_exp2(s[n][e] - m[e >> 1]);
        l[e >> 1] += ex;
        du[e >> 1] += dp[n][e] * ex;
      }
  }
  float dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    dl[i] = quad_sum(du[i]) / l[i];
  }

  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    float s[2][4], dp[2][4];
    scores(kb, s);
    mma_abt<KS>(dp, gf, Vs, lane, kb * 16);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = fast_exp2(s[n][e] - m[i]) / l[i];
        s[n][e] = p * (dp[n][e] - dl[i]) * scale;
      }
    uint32_t da[4];
    to_a(da, s);
    mma_ab<KS>(acc, da, Ks, lane, kb * 16, NT);
  }

  const int r0 = q0 + warp * 16 + gr;
  const size_t bh = (size_t)blockIdx.z * H + h;
  if (t == 0) {
    if (r0 < L) stats[bh * L + r0] = make_float4(m[0], l[0], dl[0], 0.f);
    if (r0 + 8 < L) stats[bh * L + r0 + 8] = make_float4(m[1], l[1], dl[1], 0.f);
  }
  store_rows<KS>(dq + (size_t)b * L * ldo + (size_t)h * D, ldo, r0, L, NT, t,
                 acc);
}

// ---------------------------------------------------------- (b) columns
template <int KS>
__global__ void __launch_bounds__(BT)
bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ld, const bf16* __restrict__ g,
                const float4* __restrict__ stats, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int ldo, int L, int H, int D,
                float scale) {
  constexpr int KST = KS * 16 + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + Lp * KST;
  bf16* Ts = Gs + Lp * KST;   // staging: the k tile, then the v tile
  float4* St = reinterpret_cast<float4*>(Ts + BR * KST);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BR;
  const int W = H * D;
  const size_t off = (size_t)b * L * ld + (size_t)h * D;
  const bf16* gb = g + (size_t)b * L * W + (size_t)h * D;
  const size_t bh = (size_t)b * H + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage<KS>(Ts, k + off, ld, k0, BR, L, D, tid);
  stage<KS>(Qs, q + off, ld, 0, Lp, L, D, tid);
  stage<KS>(Gs, gb, W, 0, Lp, L, D, tid);
  cp_async_commit();
  for (int i = tid; i < Lp; i += BT)
    St[i] = i < L ? stats[bh * L + i] : make_float4(0.f, 1.f, 0.f, 0.f);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[KS][4];
  load_a<KS>(kf, Ts, lane, warp * 16);
  __syncthreads();
  stage<KS>(Ts, v + off, ld, k0, BR, L, D, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t vf[KS][4];
  load_a<KS>(vf, Ts, lane, warp * 16);

  if (k0 + warp * 16 >= L) return;   // all 16 keys are padding; no barrier follows

  const int gr = lane >> 2, t = lane & 3;
  const int nqb = Lp / 16, NT = D / 8;
  const float qk2 = scale * LOG2E;
  const int j0 = k0 + warp * 16 + gr;   // this thread's keys j0 and j0 + 8

  float adk[2 * KS][4], adv[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int qb = 0; qb < nqb; ++qb) {
    float s[2][4], dp[2][4];
    mma_abt<KS>(s, kf, Qs, lane, qb * 16);    // s^T: rows keys, cols queries
    mma_abt<KS>(dp, vf, Gs, lane, qb * 16);   // dp^T
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = qb * 16 + n * 8 + 2 * t + (e & 1);
        const int j = j0 + (e >> 1) * 8;
        const float4 st = St[i];
        float p = 0.f;
        if (i < L && j < L) p = fast_exp2(s[n][e] * qk2 - st.x) / st.y;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - st.z) * scale;
      }
    uint32_t pa[4], da[4];
    to_a(pa, s);
    to_a(da, dp);
    mma_ab<KS>(adv, pa, Gs, lane, qb * 16, NT);
    mma_ab<KS>(adk, da, Qs, lane, qb * 16, NT);
  }

  const size_t ooff = (size_t)b * L * ldo + (size_t)h * D;
  store_rows<KS>(dk + ooff, ldo, j0, L, NT, t, adk);
  store_rows<KS>(dv + ooff, ldo, j0, L, NT, t, adv);
}

template <int KS>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, int ld,
                       const bf16* g, float4* stats, bf16* dq, bf16* dk,
                       bf16* dv, int ldo, int B, int L, int H, int D,
                       float scale, cudaStream_t stream) {
  constexpr int KST = KS * 16 + 8;
  const int Lp = (L + 15) & ~15;
  const size_t rows_smem = sizeof(bf16) * (size_t)(2 * Lp + BR) * KST;
  const size_t cols_smem = rows_smem + sizeof(float4) * (size_t)Lp;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_rows_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)rows_smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_cols_kernel<KS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cols_smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + BR - 1) / BR, H, B);
  bwd_rows_kernel<KS><<<grid, BT, rows_smem, stream>>>(
      q, k, v, ld, g, stats, dq, ldo, L, H, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_cols_kernel<KS><<<grid, BT, cols_smem, stream>>>(
      q, k, v, ld, g, stats, dk, dv, ldo, L, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: the head-0 columns of batch row 0, rows `ld` elements apart (the
// fused qkv: qkv, qkv + W, qkv + 2W with ld 3W); g (B, L, H*D) contiguous;
// stats (B, H, L) float4 scratch; dq, dk, dv likewise with row stride ldo.
// D a multiple of 8 up to 128; strides and pointers 16-byte aligned (the
// wrapper checks, and that one head's two L x D operands fit shared memory).
extern "C" int mico_packed_attn_bwd(const void* q, const void* k,
                                    const void* v, int ld, const void* g,
                                    void* stats, void* dq, void* dk, void* dv,
                                    int ldo, int B, int L, int H, int D,
                                    float scale, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  float4* st = static_cast<float4*>(stats);
  bf16* a = static_cast<bf16*>(dq);
  bf16* bk = static_cast<bf16*>(dk);
  bf16* c = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch_bwd<1>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    case 2: return launch_bwd<2>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    case 3: return launch_bwd<3>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    case 4: return launch_bwd<4>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    case 5: return launch_bwd<5>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    case 6: return launch_bwd<6>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    case 7: return launch_bwd<7>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    case 8: return launch_bwd<8>(qp, kp, vp, ld, gp, st, a, bk, c, ldo, B, L, H, D, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
