// Streamed-KV online-softmax attention on (B, H, Lq, D): the device code of
// K2 (flash_attn.cu, the resident-KV `_flash`) and K6 (kv_tiled_attn.cu, the
// KV-tiled `_flash_kv_tiled` / `_flash_kv_tiled_stats`). The two differ only
// in their rounding points, chosen by the template flag TILED:
//   K2 (TILED false): q scaled in fp32 by `qscale` and rounded to bf16, the
//       scores used as the product gives them, p = exp2((s - m) * pscale);
//   K6 (TILED true):  q unscaled, the fp32 scores times `qscale`,
//       p = exp2((s - m) * log2e), i.e. natural exp, and optionally the
//       per-row log-sum-exp m + log(l) in fp32.
// Both add the fp32 bias (broadcast through the strides the wrapper passes,
// 0 on a broadcast axis) to the scores, fill keys past Lk with the finite
// -1e30 of `_NEG_BIG`, round p to bf16 for the PV product, take the row sum
// over the unrounded p and write o / l in bf16.
//
// Grid (q-tiles of 64 rows, H, B), 4 warps of 16 query rows. K and V stream
// through shared memory in 64-key chunks, double-buffered with cp.async so
// the next chunk's copy overlaps this chunk's products; the softmax runs
// online, the accumulator rescaled by exp2(m_old - m_new). The Q tile stays
// in registers as mma fragments. Head dims up to 128 in steps of 8 are
// zero-padded to a multiple of 16 in shared memory. Output rows are written
// through the caller's strides, so the (B, Lq, H, D) layout BERT wants costs
// no copy.
#pragma once

#include "common.cuh"

namespace mico {
namespace flash {

constexpr int FW = 4;             // warps per block
constexpr int FT = FW * 32;
constexpr int FQ = FW * 16;       // query rows per block
constexpr int FK = 64;            // keys per streamed chunk

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;
  bf16* o;
  float* lse;     // TILED only: (B, H, Lq) fp32, or null
  int Lq, Lk, D;
  long long qs[3], ks[3], vs[3], os[3];   // element strides of (b, h, l)
  long long bs[4];                        // bias strides of (b, h, q, k)
  float qscale;   // K2: scale*log2e (no bias) or scale (bias); K6: scale
  float pscale;   // K2: 1 (scores already base 2) or log2e; K6: log2e
  int has_bias;
};

template <int KS, bool TILED>
__global__ void __launch_bounds__(FT) flash_kernel(const FlashArgs a) {
  constexpr int DP = KS * 16;
  constexpr int ST = DP + 8;      // row stride: conflict-free ldmatrix
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // FQ x ST
  bf16* Ks = Qs + FQ * ST;                         // 2 x FK x ST
  bf16* Vs = Ks + 2 * FK * ST;                     // 2 x FK x ST

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dv = DP / 8, dreal = a.D / 8;
  const bf16* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const bf16* kbase = a.k + b * a.ks[0] + h * a.ks[1];
  const bf16* vbase = a.v + b * a.vs[0] + h * a.vs[1];

  for (int v = tid; v < FQ * dv; v += FT) {
    const int r = v / dv, c = v % dv, row = q0 + r;
    const bool ok = row < a.Lq && c < dreal;
    cp_async_16(Qs + r * ST + c * 8, ok ? qb + row * a.qs[2] + c * 8 : qb, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t r[4];
    ldmatrix_x4(r, Qs + (warp * 16 + (lane & 15)) * ST + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (TILED) {
        qf[ks][j] = r[j];
      } else {
        const float2 f = unpack_bf16(r[j]);
        qf[ks][j] = pack_bf16(f.x * a.qscale, f.y * a.qscale);
      }
    }
  }

  auto load_kv = [&](int chunk, int buf) {
    const int k0 = chunk * FK;
    for (int v = tid; v < FK * dv; v += FT) {
      const int r = v / dv, c = v % dv, key = k0 + r;
      const bool ok = key < a.Lk && c < dreal;
      cp_async_16(Ks + (buf * FK + r) * ST + c * 8,
                  ok ? kbase + key * a.ks[2] + c * 8 : kbase, ok);
      cp_async_16(Vs + (buf * FK + r) * ST + c * 8,
                  ok ? vbase + key * a.vs[2] + c * 8 : vbase, ok);
    }
  };

  const bool active = q0 + warp * 16 < a.Lq;   // warp-uniform
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* brow0 = a.bias;
  const float* brow1 = a.bias;
  if (a.has_bias) {
    const float* bb = a.bias + b * a.bs[0] + h * a.bs[1];
    brow0 = bb + (long long)min(r0, a.Lq - 1) * a.bs[2];
    brow1 = bb + (long long)min(r1, a.Lq - 1) * a.bs[2];
  }

  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
  const int NT = a.D / 8;
  const int nc = (a.Lk + FK - 1) / FK;

  load_kv(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    if (c + 1 < nc) {
      load_kv(c + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* Kc = Ks + buf * FK * ST;
      const bf16* Vc = Vs + buf * FK * ST;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t r[4];
          ldmatrix_x4(r, Kc + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * ST +
                             ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * kb], qf[ks], r[0], r[1]);
          mma_bf16(s[2 * kb + 1], qf[ks], r[2], r[3]);
        }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c * FK + n * 8 + 2 * t + (e & 1);
          float val = s[n][e];
          if constexpr (TILED) val *= a.qscale;
          if (key < a.Lk) {
            if (a.has_bias) val += (e < 2 ? brow0 : brow1)[key * a.bs[3]];
          } else {
            val = NEG_BIG;
          }
          s[n][e] = val;
          if (e < 2) mx0 = fmaxf(mx0, val);
          else mx1 = fmaxf(mx1, val);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float al0 = fast_exp2((m0 - mx0) * a.pscale);
      const float al1 = fast_exp2((m1 - mx1) * a.pscale);
      m0 = mx0;
      m1 = mx1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* sn = s[2 * kb + half];
          const float p0 = fast_exp2((sn[0] - m0) * a.pscale);
          const float p1 = fast_exp2((sn[1] - m0) * a.pscale);
          const float p2 = fast_exp2((sn[2] - m1) * a.pscale);
          const float p3 = fast_exp2((sn[3] - m1) * a.pscale);
          l0 += p0 + p1;
          l1 += p2 + p3;
          pa[2 * half] = pack_bf16(p0, p1);
          pa[2 * half + 1] = pack_bf16(p2, p3);
        }
        const bf16* vrow = Vc + (kb * 16 + (lane & 15)) * ST;
#pragma unroll
        for (int n = 0; n < 2 * KS; n += 2) {
          if (n < NT) {   // NT even or odd: padded columns are zero
            uint32_t r[4];
            ldmatrix_x4_trans(r, vrow + n * 8 + (lane >> 4) * 8);
            mma_bf16(o[n], pa, r[0], r[1]);
            mma_bf16(o[n + 1], pa, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();   // this buffer is refilled by the next iteration's copy
  }

  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* ob = a.o + b * a.os[0] + h * a.os[1] + 2 * t;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    if (n < NT) {
      if (r0 < a.Lq)
        *reinterpret_cast<uint32_t*>(ob + r0 * a.os[2] + n * 8) =
            pack_bf16(o[n][0] / l0, o[n][1] / l0);
      if (r1 < a.Lq)
        *reinterpret_cast<uint32_t*>(ob + r1 * a.os[2] + n * 8) =
            pack_bf16(o[n][2] / l1, o[n][3] / l1);
    }
  }
  if constexpr (TILED) {
    if (a.lse != nullptr && t == 0) {
      float* lb = a.lse + ((long long)b * gridDim.y + h) * a.Lq;
      if (r0 < a.Lq) lb[r0] = m0 + logf(l0);
      if (r1 < a.Lq) lb[r1] = m1 + logf(l1);
    }
  }
}

template <int KS, bool TILED>
cudaError_t launch_ks(const FlashArgs& a, int B, int H, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(FQ + 4 * FK) * (KS * 16 + 8);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<KS, TILED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Lq + FQ - 1) / FQ, H, B);
  flash_kernel<KS, TILED><<<grid, FT, smem, stream>>>(a);
  return cudaGetLastError();
}

// the launch for head dim a.D (a multiple of 8 up to 128; the wrappers check)
template <bool TILED>
cudaError_t launch(const FlashArgs& a, int B, int H, cudaStream_t s) {
  switch ((a.D + 15) / 16) {
    case 1: return launch_ks<1, TILED>(a, B, H, s);
    case 2: return launch_ks<2, TILED>(a, B, H, s);
    case 3: return launch_ks<3, TILED>(a, B, H, s);
    case 4: return launch_ks<4, TILED>(a, B, H, s);
    case 5: return launch_ks<5, TILED>(a, B, H, s);
    case 6: return launch_ks<6, TILED>(a, B, H, s);
    case 7: return launch_ks<7, TILED>(a, B, H, s);
    case 8: return launch_ks<8, TILED>(a, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

// FlashArgs from the C entries' flat arguments: strides[0..11] the (b, h, l)
// element strides of q, k, v, o; strides[12..15] the bias's (b, h, q, k)
inline FlashArgs make_args(const void* q, const void* k, const void* v,
                           const void* bias, void* o, float* lse, int Lq,
                           int Lk, int D, const long long* strides,
                           float qscale, float pscale, int has_bias) {
  FlashArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.o = static_cast<bf16*>(o);
  a.lse = lse;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) a.bs[i] = strides[12 + i];
  a.qscale = qscale;
  a.pscale = pscale;
  a.has_bias = has_bias;
  return a;
}

}  // namespace flash
}  // namespace mico
