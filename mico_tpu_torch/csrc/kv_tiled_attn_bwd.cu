// K6b: the gradient of K6, KV-tiled flash attention backward from the saved
// log-sum-exp, with the bias replayed.
//
// Replaces the TPU kernel `_flash_kv_tiled_bwd` (mico_tpu/ops/
// flash_attention.py:486): its dQ pallas_call (:531, body
// `_kv_tiled_dq_kernel` :369) and its dK/dV pallas_call (:588, body
// `_kv_tiled_dkv_kernel` :420). Given q, k, v, the output gradient g, the
// forward's lse and delta = rowsum(g * o) (both (B, H, Lq) fp32), with the
// bodies' rounding points:
//   s  = q k^T in fp32, times scale, plus the fp32 bias (the forward's)
//   p  = exp(s - lse) in fp32 (here exp2((s - lse) log2e)); 0 on keys past
//        Lk and on query rows past Lq
//   dp = g v^T in fp32
//   ds = bf16(p * (dp - delta) * scale)
//   dq = ds k          dv = bf16(p)^T g          dk = ds^T q
// every product accumulated in fp32 (mma.sync m16n8k16), every result
// written in bf16 through the caller's (b, h, l) strides. The bias gets no
// gradient here: on this route it is a constant mask
// (`KV_TILED_BIAS_IS_MASK`, :634).
//
// What bounds it on the H100: bytes. At the long-context step's shape (q, g
// (2, 12, 128, 64), k, v (2, 12, 8224, 64) bf16) it reads k and v (51 MB)
// and writes dk and dv (51 MB) for 5 x 2 x 2 x 12 x 128 x 8224 x 64 = 16.2
// GFLOP: 0.030 ms at 3.35 TB/s against 0.016 ms at 989 TFLOP/s.
//
// Design: the FlashAttention-2 split, two launches behind one C entry, with
// the mma.sync tile products of common.cuh. Nothing is recomputed but s:
// the saved lse replaces a maximum and a row-sum pass.
//   (a) dQ: grid (q-tiles of 64, H, B), 4 warps of 16 query rows holding q
//       and g as mma fragments and lse, delta in registers; K and V stream
//       in 64-key chunks through double-buffered shared memory (cp.async,
//       rows past Lk zero-filled, so no 0 * NaN); dq accumulates in fp32
//       registers. At the long-context step's Lq = 128 this grid has 48
//       blocks on 132 SMs: splitting the keys over blocks is later work.
//   (b) dK/dV: grid (k-tiles of 64, H, B), 4 warps of 16 keys holding k and
//       v as fragments; q, g and their lse and delta stream in 64-row chunks
//       (q and g zero-filled past Lq); s^T and dp^T are recomputed with the
//       keys as rows, and p and ds, re-packed from the accumulator layout as
//       A operands, feed dv += p^T g and dk += ds^T q.

#include "common.cuh"

namespace {
using namespace mico;

constexpr int BW = 4;            // warps per block
constexpr int BT = BW * 32;
constexpr int BR = BW * 16;      // resident rows: queries (dQ) or keys (dK/dV)
constexpr int BC = 64;           // streamed rows: keys (dQ) or queries (dK/dV)

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const float* lse;     // (B, H, Lq)
  const float* delta;   // (B, H, Lq)
  const float* bias;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Lq, Lk, D;
  // element strides of (b, h, l)
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3];
  long long bs[4];      // bias strides of (b, h, q, k), 0 where broadcast
  float scale;
  int has_bias;
};

__device__ __forceinline__ const bf16* head(const bf16* p, const long long* s,
                                            int b, int h) {
  return p + b * s[0] + h * s[1];
}

// rows [r0, r0 + n) of one (b, h) slice, `rs` elements apart, into X (row
// stride KS * 16 + 8) by cp.async, zero-filled past L and past D
template <int KS>
__device__ __forceinline__ void stage(bf16* X, const bf16* base, long long rs,
                                      int r0, int n, int L, int D, int tid) {
  constexpr int KST = KS * 16 + 8, DV = KS * 2;
  const int dreal = D / 8;
  for (int i = tid; i < n * DV; i += BT) {
    const int r = i / DV, c = i % DV, row = r0 + r;
    const bool ok = row < L && c < dreal;
    cp_async_16(X + r * KST + c * 8, ok ? base + row * rs + c * 8 : base, ok);
  }
}

// rows r (accumulator elements 0, 1) and r + 8 (elements 2, 3) of a 16 x D
// fp32 accumulator, in bf16, at out + row * rs
template <int KS>
__device__ __forceinline__ void store_rows(bf16* out, long long rs, int r,
                                           int L, int NT, int t,
                                           const float (&acc)[2 * KS][4]) {
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    if (n < NT) {
      if (r < L)
        *reinterpret_cast<uint32_t*>(out + r * rs + n * 8 + 2 * t) =
            pack_bf16(acc[n][0], acc[n][1]);
      if (r + 8 < L)
        *reinterpret_cast<uint32_t*>(out + (r + 8) * rs + n * 8 + 2 * t) =
            pack_bf16(acc[n][2], acc[n][3]);
    }
  }
}

// ------------------------------------------------------------------ (a) dQ
template <int KS>
__global__ void __launch_bounds__(BT) dq_kernel(const BwdArgs a) {
  constexpr int KST = KS * 16 + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // BR x KST
  bf16* Gs = Qs + BR * KST;                        // BR x KST
  bf16* Ks = Gs + BR * KST;                        // 2 x BC x KST
  bf16* Vs = Ks + 2 * BC * KST;                    // 2 x BC x KST

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const bf16* kb = head(a.k, a.ks, b, h);
  const bf16* vb = head(a.v, a.vs, b, h);
  auto load_kv = [&](int chunk, int buf) {
    stage<KS>(Ks + buf * BC * KST, kb, a.ks[2], chunk * BC, BC, a.Lk, a.D, tid);
    stage<KS>(Vs + buf * BC * KST, vb, a.vs[2], chunk * BC, BC, a.Lk, a.D, tid);
  };

  stage<KS>(Qs, head(a.q, a.qs, b, h), a.qs[2], q0, BR, a.Lq, a.D, tid);
  stage<KS>(Gs, head(a.g, a.gs, b, h), a.gs[2], q0, BR, a.Lq, a.D, tid);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KS][4], gf[KS][4];
  load_a<KS>(qf, Qs, lane, warp * 16);
  load_a<KS>(gf, Gs, lane, warp * 16);

  const bool active = q0 + warp * 16 < a.Lq;   // warp-uniform
  const int r0 = q0 + warp * 16 + gr;          // rows r0 and r0 + 8
  const long long bh = (long long)b * gridDim.y + h;
  float lse[2], dl[2];
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse[i] = row < a.Lq ? a.lse[bh * a.Lq + row] : 0.f;
    dl[i] = row < a.Lq ? a.delta[bh * a.Lq + row] : 0.f;
    brow[i] = a.bias + b * a.bs[0] + h * a.bs[1] +
              (long long)min(row, a.Lq - 1) * a.bs[2];
  }

  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int NT = a.D / 8;
  const int nc = (a.Lk + BC - 1) / BC;

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
      const bf16* Kc = Ks + buf * BC * KST;
      const bf16* Vc = Vs + buf * BC * KST;
#pragma unroll
      for (int kq = 0; kq < BC / 16; ++kq) {
        float s[2][4], dp[2][4];
        mma_abt<KS>(s, qf, Kc, lane, kq * 16);
        mma_abt<KS>(dp, gf, Vc, lane, kq * 16);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int key = c * BC + kq * 16 + n * 8 + 2 * t + (e & 1);
            float p = 0.f;
            if (key < a.Lk) {
              float x = s[n][e] * a.scale;
              if (a.has_bias) x += brow[i][key * a.bs[3]];
              p = fast_exp2((x - lse[i]) * LOG2E);
            }
            s[n][e] = p * (dp[n][e] - dl[i]) * a.scale;
          }
        uint32_t da[4];
        to_a(da, s);
        mma_ab<KS>(acc, da, Kc, lane, kq * 16, NT);
      }
    }
    __syncthreads();   // this buffer is refilled by the next iteration's copy
  }
  if (active)
    store_rows<KS>(a.dq + b * a.dqs[0] + h * a.dqs[1], a.dqs[2], r0, a.Lq, NT,
                   t, acc);
}

// --------------------------------------------------------------- (b) dK/dV
template <int KS>
__global__ void __launch_bounds__(BT) dkv_kernel(const BwdArgs a) {
  constexpr int KST = KS * 16 + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // BR x KST
  bf16* Vs = Ks + BR * KST;                        // BR x KST
  bf16* Qs = Vs + BR * KST;                        // 2 x BC x KST
  bf16* Gs = Qs + 2 * BC * KST;                    // 2 x BC x KST
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BC * KST);   // 2 x BC lse
  float* Ds = Ls + 2 * BC;                                    // 2 x BC delta

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * gridDim.y + h;
  const bf16* qb = head(a.q, a.qs, b, h);
  const bf16* gb = head(a.g, a.gs, b, h);
  auto load_q = [&](int chunk, int buf) {
    stage<KS>(Qs + buf * BC * KST, qb, a.qs[2], chunk * BC, BC, a.Lq, a.D, tid);
    stage<KS>(Gs + buf * BC * KST, gb, a.gs[2], chunk * BC, BC, a.Lq, a.D, tid);
    // the rows' statistics by plain loads; the barrier after the wait that
    // precedes their use publishes them
    for (int i = tid; i < BC; i += BT) {
      const int row = chunk * BC + i;
      Ls[buf * BC + i] = row < a.Lq ? a.lse[bh * a.Lq + row] : 0.f;
      Ds[buf * BC + i] = row < a.Lq ? a.delta[bh * a.Lq + row] : 0.f;
    }
  };

  stage<KS>(Ks, head(a.k, a.ks, b, h), a.ks[2], k0, BR, a.Lk, a.D, tid);
  stage<KS>(Vs, head(a.v, a.vs, b, h), a.vs[2], k0, BR, a.Lk, a.D, tid);
  cp_async_commit();
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[KS][4], vf[KS][4];
  load_a<KS>(kf, Ks, lane, warp * 16);
  load_a<KS>(vf, Vs, lane, warp * 16);

  const bool active = k0 + warp * 16 < a.Lk;   // warp-uniform
  const int j0 = k0 + warp * 16 + gr;          // keys j0 and j0 + 8
  const float* bkey[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bkey[i] = a.bias + b * a.bs[0] + h * a.bs[1] +
              (long long)min(j0 + 8 * i, a.Lk - 1) * a.bs[3];

  float adk[2 * KS][4], adv[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const int NT = a.D / 8;
  const int nc = (a.Lq + BC - 1) / BC;

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    if (c + 1 < nc) {
      load_q(c + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* Qc = Qs + buf * BC * KST;
      const bf16* Gc = Gs + buf * BC * KST;
      const float* Lc = Ls + buf * BC;
      const float* Dc = Ds + buf * BC;
#pragma unroll
      for (int qq = 0; qq < BC / 16; ++qq) {
        float s[2][4], dp[2][4];
        mma_abt<KS>(s, kf, Qc, lane, qq * 16);    // s^T: rows keys, cols queries
        mma_abt<KS>(dp, vf, Gc, lane, qq * 16);   // dp^T
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = qq * 16 + n * 8 + 2 * t + (e & 1);
            const int qi = c * BC + ql;
            float p = 0.f;
            if (qi < a.Lq) {
              float x = s[n][e] * a.scale;
              if (a.has_bias) x += bkey[e >> 1][qi * a.bs[2]];
              p = fast_exp2((x - Lc[ql]) * LOG2E);
            }
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - Dc[ql]) * a.scale;
          }
        uint32_t pa[4], da[4];
        to_a(pa, s);
        to_a(da, dp);
        mma_ab<KS>(adv, pa, Gc, lane, qq * 16, NT);
        mma_ab<KS>(adk, da, Qc, lane, qq * 16, NT);
      }
    }
    __syncthreads();   // this buffer is refilled by the next iteration's copy
  }
  if (active) {
    store_rows<KS>(a.dk + b * a.dks[0] + h * a.dks[1], a.dks[2], j0, a.Lk, NT,
                   t, adk);
    store_rows<KS>(a.dv + b * a.dvs[0] + h * a.dvs[1], a.dvs[2], j0, a.Lk, NT,
                   t, adv);
  }
}

template <int KS>
cudaError_t launch_ks(const BwdArgs& a, int B, int H, cudaStream_t stream) {
  constexpr int KST = KS * 16 + 8;
  const size_t dq_smem = sizeof(bf16) * (size_t)(2 * BR + 4 * BC) * KST;
  const size_t dkv_smem = dq_smem + sizeof(float) * 4 * BC;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel<KS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_smem);
  if (e != cudaSuccess) return e;
  dq_kernel<KS><<<dim3((a.Lq + BR - 1) / BR, H, B), BT, dq_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<KS><<<dim3((a.Lk + BR - 1) / BR, H, B), BT, dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g (bf16, unit stride on D) in, dq, dk, dv (bf16) out;
// strides[0..20] the (b, h, l) element strides of q, k, v, g, dq, dk, dv;
// strides[21..24] the bias's (b, h, q, k) strides (fp32, 0 where broadcast);
// lse and delta (B, H, Lq) fp32 contiguous. D a multiple of 8 up to 128,
// rows 16-byte aligned (the wrapper checks).
extern "C" int mico_kv_tiled_attn_bwd(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      const void* bias, void* dq, void* dk,
                                      void* dv, int B, int H, int Lq, int Lk,
                                      int D, const long long* strides,
                                      float scale, int has_bias,
                                      void* stream) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.bias = static_cast<const float*>(bias);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  long long* dst[7] = {a.qs, a.ks, a.vs, a.gs, a.dqs, a.dks, a.dvs};
  for (int j = 0; j < 7; ++j)
    for (int i = 0; i < 3; ++i) dst[j][i] = strides[3 * j + i];
  for (int i = 0; i < 4; ++i) a.bs[i] = strides[21 + i];
  a.scale = scale;
  a.has_bias = has_bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch_ks<1>(a, B, H, s);
    case 2: return launch_ks<2>(a, B, H, s);
    case 3: return launch_ks<3>(a, B, H, s);
    case 4: return launch_ks<4>(a, B, H, s);
    case 5: return launch_ks<5>(a, B, H, s);
    case 6: return launch_ks<6>(a, B, H, s);
    case 7: return launch_ks<7>(a, B, H, s);
    case 8: return launch_ks<8>(a, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}
