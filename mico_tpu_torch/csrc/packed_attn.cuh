// Packed self-attention by column offset: the device code of `_packed_body`
// (mico_tpu/ops/flash_attention.py:757), shared by K1's attention launch
// (fused_ln_qkv_attn.cu) and K3 (packed_attn.cu).
//
// Per batch row b and head h, with q/k/v rows read at column h*D of three
// base pointers that share one row stride `ld` (3W for the fused qkv of the
// projection, W for three separate (B, L, W) tensors):
//   s   = q_h k_h^T in fp32, times scale * log2e
//   p   = exp2(s - rowmax(s)) in fp32, unnormalised
//   o_h = (bf16(p) v_h, fp32 accumulate) / rowsum(p)
// written packed as (B, L, H*D) bf16 — the Pallas body's rounding points.
//
// Grid (q-tiles of 96 rows, H, B), 6 warps of 16 query rows. The block
// stages K (zero-padded from D to a multiple of 16 for the QK^T contraction)
// and V of its head in shared memory; the Q tile passes through the V region
// first and stays in registers as mma fragments. Two passes over 16-key
// blocks: the first takes the exact row maximum, the second exponentiates
// against it and feeds p (re-packed from the accumulator layout as the A
// operand) to the PV product over D/8 output tiles of 8 (88 = 11 * 8). Keys
// past L are masked with the finite -1e30.
#pragma once

#include "common.cuh"

namespace mico {
namespace packed {

constexpr int AW = 6;          // warps per block
constexpr int AT = AW * 32;
constexpr int AR = AW * 16;    // query rows per block

// KS = D rounded up to 16, in 16-wide contraction steps
template <int KS>
__global__ void __launch_bounds__(AT)
packed_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, int ld, bf16* __restrict__ out,
                   int L, int H, int D, float qk_scale) {
  constexpr int DP = KS * 16;
  constexpr int KST = DP + 8;            // Q/K row stride: conflict-free
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) & ~15;
  const int VST = ((D >> 3) & 1) ? D : D + 8;   // odd multiple of 8
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + Lp * KST;
  bf16* Qs = Vs;                          // the Q tile passes through V's room

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AR;
  const int W = H * D;
  const size_t boff = (size_t)b * L * ld + (size_t)h * D;
  const bf16* qb = q + boff;
  const bf16* kb_ = k + boff;
  const bf16* vb = v + boff;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dv = DP / 8, dreal = D / 8;  // 16-byte vectors per padded/real row

  for (int i = tid; i < AR * dv; i += AT) {
    const int r = i / dv, c = i % dv, row = q0 + r;
    const bool ok = row < L && c < dreal;
    cp_async_16(Qs + r * KST + c * 8, ok ? qb + (size_t)row * ld + c * 8 : qb,
                ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * KST + ks * 16 +
                            (lane >> 4) * 8);
  __syncthreads();   // Q's room is V's from here on

  for (int i = tid; i < Lp * dv; i += AT) {
    const int r = i / dv, c = i % dv;
    const bool ok = r < L && c < dreal;
    cp_async_16(Ks + r * KST + c * 8, ok ? kb_ + (size_t)r * ld + c * 8 : kb_,
                ok);
  }
  for (int i = tid; i < Lp * dreal; i += AT) {
    const int r = i / dreal, c = i % dreal;
    const bool ok = r < L;
    cp_async_16(Vs + r * VST + c * 8, ok ? vb + (size_t)r * ld + c * 8 : vb,
                ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (q0 + warp * 16 >= L) return;   // all 16 rows are padding; no barrier follows

  const int g = lane >> 2, t = lane & 3;
  const int nkb = Lp / 16;
  const int NT = D / 8;

  // scores of this warp's 16 rows against keys kb*16 .. kb*16+15, scaled
  // after the product and masked past L
  auto scores = [&](int kb, float (&s)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t r[4];
      ldmatrix_x4(r, Ks + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * KST +
                         ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qf[ks], r[0], r[1]);
      mma_bf16(s[1], qf[ks], r[2], r[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * 16 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key < L ? s[n][e] * qk_scale : NEG_BIG;
      }
  };

  float m0 = NEG_BIG, m1 = NEG_BIG;   // rows g and g+8
  for (int kb = 0; kb < nkb; ++kb) {
    float s[2][4];
    scores(kb, s);
    m0 = fmaxf(m0, fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
    m1 = fmaxf(m1, fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    float s[2][4];
    scores(kb, s);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = fast_exp2(s[n][0] - m0);
      s[n][1] = fast_exp2(s[n][1] - m0);
      s[n][2] = fast_exp2(s[n][2] - m1);
      s[n][3] = fast_exp2(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
    // accumulator layout of the two 8-key tiles == A fragment of one k16 step
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
    const bf16* vrow = Vs + (kb * 16 + (lane & 15)) * VST;
#pragma unroll
    for (int n = 0; n < 2 * KS; n += 2) {
      uint32_t r[4];
      if (n + 1 < NT) {
        ldmatrix_x4_trans(r, vrow + n * 8 + (lane >> 4) * 8);
        mma_bf16(o[n], pa, r[0], r[1]);
        mma_bf16(o[n + 1], pa, r[2], r[3]);
      } else if (n < NT) {
        ldmatrix_x2_trans(r, vrow + n * 8);
        mma_bf16(o[n], pa, r[0], r[1]);
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  bf16* ob = out + (size_t)b * L * W + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    if (n < NT) {
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * W + n * 8) =
            pack_bf16(o[n][0] / l0, o[n][1] / l0);
      if (r1 < L)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * W + n * 8) =
            pack_bf16(o[n][2] / l1, o[n][3] / l1);
    }
  }
}

template <int KS>
inline cudaError_t launch_attn_ks(const bf16* q, const bf16* k, const bf16* v,
                                  int ld, bf16* out, int B, int L, int H,
                                  int D, float qk_scale, cudaStream_t stream) {
  constexpr int KST = KS * 16 + 8;
  const int Lp = (L + 15) & ~15;
  const int VST = ((D >> 3) & 1) ? D : D + 8;
  const int vroom = Lp * VST > AR * KST ? Lp * VST : AR * KST;
  const size_t smem = sizeof(bf16) * (size_t)(Lp * KST + vroom);
  cudaError_t e = cudaFuncSetAttribute(
      packed_attn_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + AR - 1) / AR, H, B);
  packed_attn_kernel<KS><<<grid, AT, smem, stream>>>(q, k, v, ld, out, L, H, D,
                                                     qk_scale);
  return cudaGetLastError();
}

// q, k, v: base pointers of the head-0 columns of batch row 0, rows `ld`
// elements apart (batch rows L*ld apart); out (B, L, H*D). D a multiple of
// 8 up to 128; ld and the pointers 16-byte aligned (the wrappers check).
inline cudaError_t launch_attn(const bf16* q, const bf16* k, const bf16* v,
                               int ld, bf16* out, int B, int L, int H, int D,
                               float qk_scale, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 1: return launch_attn_ks<1>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    case 2: return launch_attn_ks<2>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    case 3: return launch_attn_ks<3>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    case 4: return launch_attn_ks<4>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    case 5: return launch_attn_ks<5>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    case 6: return launch_attn_ks<6>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    case 7: return launch_attn_ks<7>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    case 8: return launch_attn_ks<8>(q, k, v, ld, out, B, L, H, D, qk_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace packed
}  // namespace mico
