// K9: CLS-split packed self-attention forward.
//
// Replaces the TPU kernel body `_packed_qkv_cls_kernel`
// (mico_tpu/ops/flash_attention.py:809), which `_packed_qkv_fwd` (:1135,
// pallas_call :1155) selects when PACKED_CLS_SPLIT is set and L > 128 with
// L % 128 == 1: K3's function on the fused qkv (B, L, 3W) with the CLS
// token (row 0) split from the P = L - 1 patch tokens. Its rounding points,
// which are not K3's:
//   s_pp = q_p k_p^T in fp32, times scale (natural exp, no log2e fold)
//   s_pc = sum_d q_p[d] k_cls[d], s_cp = sum_d k_p[d] q_cls[d] and s_cc:
//          fp32 elementwise products of the bf16 values summed over D,
//          times scale
//   patch rows: m = max(rowmax s_pp, s_pc), l = sum p_pp + p_pc over the
//          unrounded p; o = (bf16(p_pp) v_p, fp32 accumulate) + p_pc v_cls
//   CLS row:    m = max(max s_cp, s_cc), l likewise;
//          o = sum_j p_cp[j] v_p[j] (fp32, unrounded p) + p_cc v_cls
//   both rows divided by l after PV, rounded once to bf16.
//
// The TPU split removed lane padding (257 -> 384 lanes); here 16-row
// mma.sync tiles pad 257 only to 272, so K9 is ported for its function.
// Design: mma.sync over the patch rows and keys. Grid (patch q-tiles of 96
// rows, H, B); six warps of 16 patch query rows hold Q as mma fragments; the
// block stages its head's patch K (zero-padded to a multiple of 16 in D) and V
// in shared memory (the Q tile passes through V's room first), and the CLS q,
// k, v in fp32. Each warp takes its rows' CLS column s_pc from the staged Q
// tile before the V load, then two passes over 16-key blocks: the exact row
// maximum (with s_pc), then exponentiation and the PV product over D/8 output
// tiles, the CLS column's fp32 term added last. A seventh warp, live only in
// the blocks of q-tile 0, computes the CLS query row with fp32 CUDA-core dot
// products over the staged K and V (its P probabilities in shared memory).
// Keys past P (none when P % 16 == 0) are masked with the finite -1e30. The
// fused qkv is read by column offset with row stride 3W (16-byte rows: D % 8
// == 0).
//
// What bounds it on the H100: bytes, as K3. At ViT-g's train pass, qkv
// (32, 257, 3 x 16 x 88) bf16, it reads 69.5 MB and writes 23.2 MB: 0.028 ms
// at 3.35 TB/s against 11.9 GFLOP, 0.012 ms at 989 TFLOP/s; at CLIP-L/14's
// serving pass, (112, 257, 3 x 16 x 64), 0.069 ms by bytes.

#include "common.cuh"

namespace mico {
namespace cls {

constexpr int AW = 6;              // warps of 16 patch query rows
constexpr int AR = AW * 16;        // patch query rows per block
constexpr int AT = (AW + 1) * 32;  // and the CLS warp

// KS = D rounded up to 16, in 16-wide contraction steps
template <int KS>
__global__ void __launch_bounds__(AT)
packed_cls_attn_kernel(const bf16* __restrict__ qkv, int ld,
                       bf16* __restrict__ out, int L, int H, int D,
                       float scale) {
  constexpr int DP = KS * 16;
  constexpr int KST = DP + 8;              // Q/K row stride: conflict-free
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = L - 1;                     // patch tokens
  const int Pp = (P + 15) & ~15;
  const int VST = ((D >> 3) & 1) ? D : D + 8;   // odd multiple of 8
  const int vroom = Pp * VST > AR * KST ? Pp * VST : AR * KST;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + Pp * KST;
  bf16* Qs = Vs;                           // the Q tile passes through V's room
  float* qc = reinterpret_cast<float*>(Vs + vroom);   // CLS q, k, v in fp32
  float* kc = qc + DP;
  float* vc = kc + DP;
  float* pc = vc + DP;                     // the CLS query's p over patches

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AR;
  const int W = H * D;
  const bf16* cls = qkv + (size_t)b * L * ld + (size_t)h * D;   // token 0
  const bf16* qb = cls + ld;                                     // token 1
  const bf16* kb_ = qb + W;
  const bf16* vb = qb + 2 * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dv = DP / 8, dreal = D / 8;  // 16-byte vectors per padded/real row

  for (int i = tid; i < DP; i += AT) {
    const bool ok = i < D;
    qc[i] = ok ? __bfloat162float(cls[i]) : 0.f;
    kc[i] = ok ? __bfloat162float(cls[W + i]) : 0.f;
    vc[i] = ok ? __bfloat162float(cls[2 * W + i]) : 0.f;
  }
  for (int i = tid; i < AR * dv; i += AT) {
    const int r = i / dv, c = i % dv, row = q0 + r;
    const bool ok = row < P && c < dreal;
    cp_async_16(Qs + r * KST + c * 8, ok ? qb + (size_t)row * ld + c * 8 : qb,
                ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  uint32_t qf[KS][4];
  float spc0 = 0.f, spc1 = 0.f;          // s_pc of rows g and g + 8
  if (warp < AW) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * KST + ks * 16 +
                              (lane >> 4) * 8);
    const bf16* qr0 = Qs + (warp * 16 + g) * KST;
    const bf16* qr1 = qr0 + 8 * KST;
    for (int d = t; d < D; d += 4) {
      spc0 = fmaf(__bfloat162float(qr0[d]), kc[d], spc0);
      spc1 = fmaf(__bfloat162float(qr1[d]), kc[d], spc1);
    }
    spc0 = quad_sum(spc0) * scale;
    spc1 = quad_sum(spc1) * scale;
  }
  __syncthreads();   // Q's room is V's from here on

  for (int i = tid; i < Pp * dv; i += AT) {
    const int r = i / dv, c = i % dv;
    const bool ok = r < P && c < dreal;
    cp_async_16(Ks + r * KST + c * 8, ok ? kb_ + (size_t)r * ld + c * 8 : kb_,
                ok);
  }
  for (int i = tid; i < Pp * dreal; i += AT) {
    const int r = i / dreal, c = i % dreal;
    const bool ok = r < P;
    cp_async_16(Vs + r * VST + c * 8, ok ? vb + (size_t)r * ld + c * 8 : vb,
                ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // no barrier follows: the warps part here

  if (warp == AW) {
    if (blockIdx.x != 0) return;
    // the CLS query row: s_cp over the patch keys, s_cc, softmax, then the
    // fp32 weighted sum of the patch values with the unrounded p
    float scc = 0.f;
    for (int d = lane; d < D; d += 32) scc = fmaf(qc[d], kc[d], scc);
    scc = warp_sum(scc) * scale;
    float mc = scc;
    for (int j = lane; j < P; j += 32) {
      const bf16* kr = Ks + j * KST;
      float s = 0.f;
      for (int d = 0; d < D; d += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(w[e]);
          s = fmaf(f.x, qc[d + 2 * e], s);
          s = fmaf(f.y, qc[d + 2 * e + 1], s);
        }
      }
      s *= scale;
      pc[j] = s;
      mc = fmaxf(mc, s);
    }
    mc = warp_max(mc);
    float lc = 0.f;
    for (int j = lane; j < P; j += 32) {
      const float p = __expf(pc[j] - mc);
      pc[j] = p;
      lc += p;
    }
    const float pcc = __expf(scc - mc);
    lc = warp_sum(lc) + pcc;
    __syncwarp();
    bf16* orow = out + (size_t)b * L * W + (size_t)h * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < P; ++j)
        acc = fmaf(pc[j], __bfloat162float(Vs[j * VST + d]), acc);
      acc = fmaf(pcc, vc[d], acc);
      orow[d] = __float2bfloat16_rn(acc / lc);
    }
    return;
  }

  if (q0 + warp * 16 >= P) return;   // all 16 rows are padding

  const int nkb = Pp / 16;
  const int NT = D / 8;

  // scores of this warp's 16 patch rows against patch keys kb*16 ..
  // kb*16+15, scaled after the product and masked past P
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
        s[n][e] = key < P ? s[n][e] * scale : NEG_BIG;
      }
  };

  float m0 = spc0, m1 = spc1;   // the CLS column joins each row's maximum
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
      s[n][0] = __expf(s[n][0] - m0);
      s[n][1] = __expf(s[n][1] - m0);
      s[n][2] = __expf(s[n][2] - m1);
      s[n][3] = __expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
    uint32_t pa[4];
    to_a(pa, s);
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
  const float ppc0 = __expf(spc0 - m0), ppc1 = __expf(spc1 - m1);
  l0 = quad_sum(l0) + ppc0;
  l1 = quad_sum(l1) + ppc1;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // patch row r is token r + 1
  bf16* ob = out + (size_t)b * L * W + (size_t)W + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    if (n < NT) {
      const float v0 = vc[n * 8 + 2 * t], v1 = vc[n * 8 + 2 * t + 1];
      if (r0 < P)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * W + n * 8) =
            pack_bf16(fmaf(ppc0, v0, o[n][0]) / l0,
                      fmaf(ppc0, v1, o[n][1]) / l0);
      if (r1 < P)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * W + n * 8) =
            pack_bf16(fmaf(ppc1, v0, o[n][2]) / l1,
                      fmaf(ppc1, v1, o[n][3]) / l1);
    }
  }
}

template <int KS>
inline cudaError_t launch_ks(const bf16* qkv, int ld, bf16* out, int B,
                             int L, int H, int D, float scale,
                             cudaStream_t stream) {
  constexpr int DP = KS * 16;
  constexpr int KST = DP + 8;
  const int P = L - 1, Pp = (P + 15) & ~15;
  const int VST = ((D >> 3) & 1) ? D : D + 8;
  const int vroom = Pp * VST > AR * KST ? Pp * VST : AR * KST;
  const size_t smem = sizeof(bf16) * (size_t)(Pp * KST + vroom) +
                      sizeof(float) * (size_t)(3 * DP + Pp);
  cudaError_t e = cudaFuncSetAttribute(
      packed_cls_attn_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((P + AR - 1) / AR, H, B);
  packed_cls_attn_kernel<KS><<<grid, AT, smem, stream>>>(qkv, ld, out, L, H,
                                                          D, scale);
  return cudaGetLastError();
}

}  // namespace cls
}  // namespace mico

// qkv: the fused (B, L, 3W) projection, rows `ld` = 3W elements apart;
// out (B, L, W) bf16. D a multiple of 8 up to 128, L >= 2 (the wrapper
// checks, and that one head's patch K and V fit shared memory).
extern "C" int mico_packed_cls_attn(const void* qkv, int ld, void* out, int B,
                                    int L, int H, int D, float scale,
                                    void* stream) {
  using mico::bf16;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return mico::cls::launch_ks<1>(x, ld, o, B, L, H, D, scale, s);
    case 2: return mico::cls::launch_ks<2>(x, ld, o, B, L, H, D, scale, s);
    case 3: return mico::cls::launch_ks<3>(x, ld, o, B, L, H, D, scale, s);
    case 4: return mico::cls::launch_ks<4>(x, ld, o, B, L, H, D, scale, s);
    case 5: return mico::cls::launch_ks<5>(x, ld, o, B, L, H, D, scale, s);
    case 6: return mico::cls::launch_ks<6>(x, ld, o, B, L, H, D, scale, s);
    case 7: return mico::cls::launch_ks<7>(x, ld, o, B, L, H, D, scale, s);
    case 8: return mico::cls::launch_ks<8>(x, ld, o, B, L, H, D, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
