// The packed self-attention of K1, K3, K5 and K8 on Hopper: per batch row b
// and head h, q/k/v of the head read by column offset h*D from rows of three
// base pointers that share one row stride `ld` (3W for the column slices of
// a fused (B*L, 3W) qkv, W for three (B, L, W) tensors), and
//   s   = q_h k_h^T in fp32, times scale * log2e
//   p   = exp2(s - rowmax(s)) in fp32 against the exact full-row maximum
//   o_h = (bf16(p) v_h, fp32 accumulate) / rowsum(p), the sum over fp32 p
// written packed as (B, L, H*D) bf16: `_packed_body`'s rounding points
// (mico_tpu/ops/flash_attention.py:757), as `_fused_qkv_attn_kernel`
// (:1229) and `_fused_ln_qkv_attn_kernel` (:1567) compute them on their
// local qkv.
//
// What bounds it on the H100: tensor-core operations at bigE's pass (4 B H
// L^2 D = 53.0 GFLOP, 0.054 ms at 989 TFLOP/s, against 0.037 ms for q/k/v
// in and o out at 3.35 TB/s); bytes at ViT-g's train pass (K3, qkv (32,
// 257, 4224): 92.8 MB, 0.028 ms, against 11.9 GFLOP, 0.012 ms).
//
// Design. One block per (b, h): at L <= 272, K and V of the head are staged
// in shared memory once (one 4-D tensor map an operand over (D, H, L, B),
// rows `ld` apart: TMA fills rows past L and columns past D with zeros, so
// no copy reads another head or batch row), Q in tiles of 64 query rows,
// one tile per consumer warpgroup at a time. Two consumer warpgroups and a
// producer warpgroup (setmaxnreg moves registers to the consumers: 232 a
// thread, 40 for the producer):
//  - the producer issues both warpgroups' first Q tiles, then K, then V (K
//    and V on their own mbarriers, so QK^T starts while V is in flight), and
//    refills a warpgroup's Q buffer as soon as that warpgroup's QK^T has
//    retired;
//  - a consumer runs S = Q K^T with wgmma (Q and K from shared memory, both
//    K-major) over a key block of 272 keys (n256 + n16), keeping the whole
//    score row in registers (136 a thread), so QK^T runs once and the exact
//    row maximum comes from registers; p is rounded to bf16 into registers
//    in wgmma's A layout and O += P V runs as wgmma with A from registers
//    and V from shared memory (MN-major, N = 64 or 128 columns of D). Keys
//    past L are masked with the finite -1e30, so their p is 0. Each product
//    runs every k16 step of its 64-column chunks (the zero columns past D
//    included): a straight run of wgmmas, which ptxas does not serialise;
//  - o / l goes through a staging tile in shared memory to TMA stores,
//    which clip at L and D; the division is a reciprocal product with one
//    FMA correction (a full-precision division a value cost a quarter of
//    the kernel's time);
//  - past 272 keys (any L) the row takes several key blocks, streamed
//    through the same K and V buffers: for each round of two Q tiles a
//    first pass over K takes the row maximum, a second recomputes each
//    block's scores and exponentiates against it while V streams beside;
//    each fill waits until both warpgroups have released the last.
// D: any multiple of 8 up to 128, in 64-column chunks with the 128-byte
// swizzle. L = 257 takes 5 query tiles (the last holds one row), so the
// first warpgroup runs three and the second two.
//
// K9 (`cls_attn_kernel`) runs the same body over the P = L - 1 patch rows
// of a fused qkv (tensor maps based one row down, P rows, so 256 patch
// rows are four full tiles and one n256 key block) at
// `_packed_qkv_cls_kernel`'s rounding points: scores times `scale` and a
// natural exp (ex2 of x log2e, as __expf, flushing results below 2^-126);
// each patch row's CLS column s_pc = sum_d q_p k_cls joins its maximum and
// its sum, and p_pc v_cls is added in fp32 before the division, outside
// the bf16 PV product. At P <= 256 (mode CLS_TAIL) k_cls is loaded into
// row 256 of the key block, the n16 tail's first key, so QK^T computes
// s_pc on the tensor cores (bf16 products are exact in fp32; only the
// order of the sum changes); V's row 256 is a zero of the TMA fill, so p_pc
// adds nothing to the bf16 product. Otherwise (CLS_COLUMN) the consumers
// take s_pc on CUDA cores from the staged Q tile. The CLS query row is
// fp32 CUDA-core work of the producer warpgroup's three warps that issue
// no copies (`cls_row`): s_cp over the patch keys twice (the exact
// maximum, then p = exp(s - m) in chunks of 96 keys, each chunk's weighted
// sum of v_p), with the unrounded p, from the staged K and V (from global
// memory when the keys stream).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace mico {
namespace qattn {

constexpr int KB = 272;           // keys a key block: 256 + 16
constexpr int KBOX = KB / 2;      // K/V rows a TMA box
constexpr int QROWS = 64;         // query rows a warpgroup tile
constexpr int THREADS = 384;      // 2 consumer warpgroups + a producer one
constexpr int CHUNK = 64 * 128;   // a 64-row tile of one 64-column chunk

// K9's CLS row: the producer warpgroup's warps 1-3, and K9's fp32 scratch:
// q, k, v of the CLS token, a chunk's p, the column sums of each key
// group, the reductions, the CLS row's scores (resident keys) and each
// consumer warpgroup's CLS column
constexpr int CLS_THREADS = 96;
constexpr int CF_P = 3 * 128;
constexpr int CF_A = CF_P + CLS_THREADS;
constexpr int CF_R = CF_A + 2 * CLS_THREADS;
constexpr int CF_S = CF_R + 8;
constexpr int CF_PC = CF_S + KB;
constexpr int CLS_FLOATS = CF_PC + 2 * QROWS;

// shared memory of a launch (the wrappers mirror it: ops/flash_attention.py
// `_qkv_attn_smem_bytes`); K9 adds one mbarrier (padded to 16 bytes) and
// the CLS row's scratch
inline size_t smem_bytes(int D, bool cls = false) {
  const int nt = (D + 63) / 64;
  return (size_t)2 * nt * KB * 128 + (size_t)4 * nt * CHUNK + 8 * 8 + 1024 +
         (cls ? 16 + 4 * CLS_FLOATS : 0);
}

// what K9 adds to a launch: the fused qkv and the output whose row 0 is the
// CLS token, the whole sequence's length, the qkv's row stride (3W), W, D
// and the score scale
struct ClsArgs {
  const bf16* qkv;
  bf16* out;
  int L, ld, W, D;
  float scale;
};

// the body's modes: K1/K3/K5/K8's attention, or K9's with the CLS column
// on CUDA cores or in the key block's tail
constexpr int NO_CLS = 0, CLS_COLUMN = 1, CLS_TAIL = 2;

// K9's natural exponent: ex2.approx of x log2e, as __expf computes it, but
// flushing results below 2^-126 to zero (no denormal handling)
__device__ __forceinline__ float nat_exp(float x) {
  return fast_exp2(x * LOG2E);
}

// K3's base-2 exponent, or K9's natural one
template <bool NAT>
__device__ __forceinline__ float attn_exp(float x) {
  if constexpr (NAT)
    return nat_exp(x);
  else
    return fast_exp2(x);
}

// scores of one key block: s (256 keys) and st (16 tail keys), scaled after
// the product and masked past L (all but key `keep`, K9's CLS key in the
// tail), ready once the wgmmas have retired; KS k16 steps over D (the
// columns past them are zeros)
template <int NT, int KS = 4 * NT>
__device__ __forceinline__ void block_scores(float (&s)[128], float (&st)[8],
                                             const unsigned char* qs,
                                             const unsigned char* ks,
                                             int kch, int k0, int L,
                                             float qk_scale, int lane,
                                             int keep = -1) {
  hop::fence_regs(s);
  hop::fence_regs(st);
  hop::wgmma_fence();
  // every k16 step of the NT chunks: columns past D are zeros in shared
  // memory, and a straight run of wgmmas keeps ptxas from serialising them
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int off = (kk >> 2) * CHUNK, col = (kk & 3) * 32;
    hop::wgmma_ss_n256<0>(
        s, hop::desc_sw128(qs + off + col, 16, 1024),
        hop::desc_sw128(ks + (kk >> 2) * kch + k0 * 128 + col, 16, 1024),
        kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int off = (kk >> 2) * CHUNK, col = (kk & 3) * 32;
    hop::wgmma_ss_n16<0>(
        st, hop::desc_sw128(qs + off + col, 16, 1024),
        hop::desc_sw128(ks + (kk >> 2) * kch + (k0 + 256) * 128 + col, 16,
                        1024),
        kk > 0);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(s);
  hop::fence_regs(st);
  const int q2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int key = k0 + 8 * (i >> 2) + q2 + (i & 1);
    s[i] = key < L ? s[i] * qk_scale : NEG_BIG;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 256 + 8 * (i >> 2) + q2 + (i & 1);
    st[i] = key < L || key == keep ? st[i] * qk_scale : NEG_BIG;
  }
}

// x / l from r = 1 / l (both rounded to nearest) and one FMA correction of
// the product's residual: the quotient of fp32 division to within its last
// bit, without a division's instruction sequence a value
__device__ __forceinline__ float div_by(float x, float l, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, l, x), r, q);
}

// this thread's maxima of rows r0 (even register pairs) and r0 + 8
__device__ __forceinline__ void block_max(const float (&s)[128],
                                          const float (&st)[8], float& m0,
                                          float& m1) {
#pragma unroll
  for (int i = 0; i < 128; i += 4) {
    m0 = fmaxf(m0, fmaxf(s[i], s[i + 1]));
    m1 = fmaxf(m1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int i = 0; i < 8; i += 4) {
    m0 = fmaxf(m0, fmaxf(st[i], st[i + 1]));
    m1 = fmaxf(m1, fmaxf(st[i + 2], st[i + 3]));
  }
}

// p = exp2(s - m) (K9: exp(s - m)) in fp32, the row sums l over fp32 p,
// and bf16 p in wgmma's A layout (chunk by chunk, so that s dies as p is
// made); then
// O += P V over the block's 17 steps of 16 keys (p is 0 past L)
template <int NT, bool NAT>
__device__ __forceinline__ void block_pv(float (&s)[128], float (&st)[8],
                                         float (&o)[NT * 32],
                                         const unsigned char* vs, int kch,
                                         int k0, float m0, float m1,
                                         float& l0, float& l1) {
  uint32_t pa[16][4], pt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 32 * c; i < 32 * c + 32; i += 4) {
      s[i] = attn_exp<NAT>(s[i] - m0);
      s[i + 1] = attn_exp<NAT>(s[i + 1] - m0);
      s[i + 2] = attn_exp<NAT>(s[i + 2] - m1);
      s[i + 3] = attn_exp<NAT>(s[i + 3] - m1);
      l0 += s[i] + s[i + 1];
      l1 += s[i + 2] + s[i + 3];
    }
#pragma unroll
    for (int k = 4 * c; k < 4 * c + 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[k][e] = pack_bf16(s[8 * k + 2 * e], s[8 * k + 2 * e + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; i += 4) {
    st[i] = attn_exp<NAT>(st[i] - m0);
    st[i + 1] = attn_exp<NAT>(st[i + 1] - m0);
    st[i + 2] = attn_exp<NAT>(st[i + 2] - m1);
    st[i + 3] = attn_exp<NAT>(st[i + 3] - m1);
    l0 += st[i] + st[i + 1];
    l1 += st[i + 2] + st[i + 3];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) pt[e] = pack_bf16(st[2 * e], st[2 * e + 1]);
  hop::fence_regs(o);
  hop::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 17; ++k) {
    const uint64_t dv = hop::desc_sw128(vs + (k0 + 16 * k) * 128, kch, 1024);
    const uint32_t(&a)[4] = k < 16 ? pa[k < 16 ? k : 0] : pt;
    if constexpr (NT == 2)
      hop::wgmma_rs_n128(o, a, dv);
    else
      hop::wgmma_rs_n64(o, a, dv);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(o);
}

// K9's CLS query row (see the file's note), by the CLS_THREADS threads
// `ct` of the producer warpgroup's warps 1-3: o_c = (sum_j p_cp[j] v_p[j] +
// p_cc v_cls) / l_c in fp32 with the unrounded p, written to row 0. K and
// V come from shared memory (the resident key block: the scores are kept
// there between the passes) or, when the keys stream, from global memory
// (the scores are taken again). Stages the CLS token's q, k, v (fp32,
// zeros past D) for the consumers first and arrives on `cready`.
template <int NT, bool STREAM>
__device__ __forceinline__ void cls_row(const ClsArgs& a, int b, int h,
                                        int ct, float* cf, uint64_t* cready,
                                        uint64_t* kfull, uint64_t* vfull,
                                        const unsigned char* ks,
                                        const unsigned char* vs) {
  constexpr int kch = KB * 128;
  float* qc = cf;
  float* kc = cf + 128;
  float* vc = cf + 256;
  float* pb = cf + CF_P;      // a chunk's p
  float* ab = cf + CF_A;      // column sums by key group
  float* red = cf + CF_R;     // per-warp reductions
  float* sb = cf + CF_S;      // the scores (resident keys)
  const int P = a.L - 1, D = a.D;
  const bf16* row0 = a.qkv + (size_t)b * a.L * a.ld + (size_t)h * D;
  for (int i = ct; i < 128; i += CLS_THREADS) {
    const bool ok = i < D;
    qc[i] = ok ? __bfloat162float(row0[i]) : 0.f;
    kc[i] = ok ? __bfloat162float(row0[a.W + i]) : 0.f;
    vc[i] = ok ? __bfloat162float(row0[2 * a.W + i]) : 0.f;
  }
  hop::named_sync(3, CLS_THREADS);
  hop::mbar_arrive(cready);
  const bf16* kg = row0 + a.ld + a.W;        // patch key 0
  const bf16* vg = row0 + a.ld + 2 * a.W;
  // s_cp[j] = (sum_d k_p[j, d] q_cls[d]) * scale, 8 columns a step. These
  // warps run in the producer's 40 registers: the loops stay rolled, or
  // ptxas spills here and serialises the consumers' wgmmas (C7512)
  auto score = [&](int j) {
    float acc = 0.f;
#pragma unroll 1
    for (int c = 0; c < D; c += 8) {
      uint4 raw;
      if constexpr (STREAM)
        raw = *reinterpret_cast<const uint4*>(kg + (size_t)j * a.ld + c);
      else
        raw = *reinterpret_cast<const uint4*>(ks +
                                              hop::sw128_offset(j, c, kch));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w[e]);
        acc = fmaf(f.x, qc[c + 2 * e], acc);
        acc = fmaf(f.y, qc[c + 2 * e + 1], acc);
      }
    }
    return acc * a.scale;
  };
  const int warp = ct >> 5, lane = ct & 31;
  float scc = 0.f;
  for (int d = 0; d < D; ++d) scc = fmaf(qc[d], kc[d], scc);
  scc *= a.scale;
  if constexpr (!STREAM) hop::mbar_wait(kfull, 0);
  float m = scc;
  for (int j = ct; j < P; j += CLS_THREADS) {
    const float x = score(j);
    if constexpr (!STREAM) sb[j] = x;
    m = fmaxf(m, x);
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  hop::named_sync(3, CLS_THREADS);
  m = fmaxf(fmaxf(red[0], red[1]), red[2]);
  if constexpr (!STREAM) hop::mbar_wait(vfull, 0);
  // p over chunks of CLS_THREADS keys (thread ct's key of a chunk is the
  // one it scored); thread ct sums columns 2cp, 2cp + 1 over group grp's
  // run of each chunk's keys
  const int npair = D / 2, groups = CLS_THREADS / npair;
  const int cp = ct % npair, grp = ct / npair;
  float l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int c0 = 0; c0 < P; c0 += CLS_THREADS) {
    const int j = c0 + ct;
    float p = 0.f;
    if (j < P) {
      if constexpr (STREAM)
        p = nat_exp(score(j) - m);
      else
        p = nat_exp(sb[j] - m);
    }
    l += p;
    pb[ct] = p;
    hop::named_sync(3, CLS_THREADS);
    if (grp < groups) {
      const int n = min(CLS_THREADS, P - c0), per = (n + groups - 1) / groups;
      const int j1 = min(n, (grp + 1) * per);
#pragma unroll 1
      for (int jj = grp * per; jj < j1; ++jj) {
        uint32_t raw;
        if constexpr (STREAM)
          raw = *reinterpret_cast<const uint32_t*>(
              vg + (size_t)(c0 + jj) * a.ld + 2 * cp);
        else
          raw = *reinterpret_cast<const uint32_t*>(
              vs + hop::sw128_offset(c0 + jj, 2 * cp, kch));
        const float2 f = unpack_bf16(raw);
        acc0 = fmaf(pb[jj], f.x, acc0);
        acc1 = fmaf(pb[jj], f.y, acc1);
      }
    }
    hop::named_sync(3, CLS_THREADS);
  }
  l = warp_sum(l);
  if (grp < groups) {
    ab[2 * ct] = acc0;
    ab[2 * ct + 1] = acc1;
  }
  if (lane == 0) red[4 + warp] = l;
  hop::named_sync(3, CLS_THREADS);
  if (ct < npair) {
    const float pcc = nat_exp(scc - m);
    const float lc = red[4] + red[5] + red[6] + pcc;
    float o0 = 0.f, o1 = 0.f;
    for (int g = 0; g < groups; ++g) {
      o0 += ab[2 * (g * npair + ct)];
      o1 += ab[2 * (g * npair + ct) + 1];
    }
    o0 = fmaf(pcc, vc[2 * ct], o0);
    o1 = fmaf(pcc, vc[2 * ct + 1], o1);
    bf16* orow = a.out + (size_t)b * a.L * a.W + (size_t)h * D;
    *reinterpret_cast<uint32_t*>(orow + 2 * ct) = pack_bf16(o0 / lc, o1 / lc);
  }
}

// The body of K1/K3/K5/K8's attention (MODE NO_CLS) and K9's. STREAM: the
// rows past one key block (L > 272), a kernel of its own so that its
// longer-lived registers do not make ptxas serialise the wgmmas of the
// resident path. For K9, L is the patch rows' count and the maps are the
// patch rows'; under CLS_TAIL (resident, L <= 256) tma_k128 holds the
// unshifted K by boxes of 128 rows and tma_kcls its CLS row.
template <int NT, bool STREAM, int MODE>
__device__ __forceinline__ void attn_body(const CUtensorMap& tma_q,
                                          const CUtensorMap& tma_k,
                                          const CUtensorMap& tma_v,
                                          const CUtensorMap& tma_o, int L,
                                          int H, float qk_scale,
                                          const ClsArgs& cls,
                                          const CUtensorMap* tma_k128,
                                          const CUtensorMap* tma_kcls) {
  constexpr bool CLS = MODE != NO_CLS;
  static_assert(MODE != CLS_TAIL || !STREAM, "the tail is a resident block's");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  constexpr int kch = KB * 128;              // bytes of a 64-column chunk
  unsigned char* ks = smem;                  // [chunk] one key block of K
  unsigned char* vs = ks + NT * kch;         // ... and of V
  unsigned char* qs = vs + NT * kch;         // [warpgroup][chunk] Q tiles
  unsigned char* os = qs + 2 * NT * CHUNK;   // output staging, the same
  uint64_t* bars = reinterpret_cast<uint64_t*>(os + 2 * NT * CHUNK);
  uint64_t* kfull = bars;
  uint64_t* vfull = bars + 1;
  uint64_t* qfull = bars + 2;                // [2]
  uint64_t* qempty = bars + 4;               // [2]
  uint64_t* kempty = bars + 6;               // streamed blocks only
  uint64_t* vempty = bars + 7;
  uint64_t* cready = bars + 8;               // K9: the CLS token staged
  float* cf = reinterpret_cast<float*>(bars + 10);   // K9's scratch

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nkb = (L + KB - 1) / KB;
  const int nqt = (L + QROWS - 1) / QROWS;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(kfull, 1);
    hop::mbar_init(vfull, 1);
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&qfull[i], 1);
      hop::mbar_init(&qempty[i], 1);
    }
    hop::mbar_init(kempty, 2);
    hop::mbar_init(vempty, 2);
    if constexpr (CLS) hop::mbar_init(cready, CLS_THREADS);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    hop::setmaxnreg_dec<40>();
    if constexpr (CLS) {
      if (threadIdx.x >= 288)
        cls_row<NT, STREAM>(cls, b, h, threadIdx.x - 288, cf, cready, kfull,
                            vfull, ks, vs);
    }
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tma_q);
      hop::prefetch_map(&tma_k);
      hop::prefetch_map(&tma_v);
      auto load_q = [&](int qt) {
        const int w = qt & 1, n = qt >> 1;
        if (n > 0) hop::mbar_wait(&qempty[w], (n - 1) & 1);
        hop::mbar_expect_tx(&qfull[w], NT * CHUNK);
        for (int c = 0; c < NT; ++c)
          hop::tma_load_4d(qs + (w * NT + c) * CHUNK, &tma_q, &qfull[w],
                           64 * c, h, qt * QROWS, b);
      };
      // key block kb of K or V (`map`) into its buffer
      auto load_block = [&](unsigned char* dst, uint64_t* bar,
                            const CUtensorMap* map, int kb) {
        hop::mbar_expect_tx(bar, NT * kch);
        for (int c = 0; c < NT; ++c)
          for (int r = 0; r < KB; r += KBOX)
            hop::tma_load_4d(dst + c * kch + r * 128, map, bar, 64 * c, h,
                             kb * KB + r, b);
      };
      if constexpr (MODE == CLS_TAIL) {
        // patch keys 0..255 (zeros past P) and k_cls in row 256; rows
        // 257..271 are left as they are: their keys are masked
        load_q(0);
        if (nqt > 1) load_q(1);
        hop::mbar_expect_tx(kfull, NT * 257 * 128);
        for (int c = 0; c < NT; ++c) {
          for (int r = 0; r < 256; r += 128)
            hop::tma_load_4d(ks + c * kch + r * 128, tma_k128, kfull, 64 * c,
                             h, 1 + r, b);
          hop::tma_load_4d(ks + c * kch + 256 * 128, tma_kcls, kfull, 64 * c,
                           h, 0, b);
        }
        load_block(vs, vfull, &tma_v, 0);
        for (int qt = 2; qt < nqt; ++qt) load_q(qt);
      } else if constexpr (!STREAM) {
        load_q(0);
        if (nqt > 1) load_q(1);
        load_block(ks, kfull, &tma_k, 0);
        load_block(vs, vfull, &tma_v, 0);
        for (int qt = 2; qt < nqt; ++qt) load_q(qt);
      } else {
        // each round of two Q tiles streams K twice (the maximum, then the
        // scores again) and V once, a block at a time, each fill once both
        // warpgroups have released the last
        int kf = 0, vf = 0;
        for (int qt = 0; qt < nqt; qt += 2) {
          load_q(qt);
          if (qt + 1 < nqt) load_q(qt + 1);
          for (int pass = 0; pass < 2; ++pass)
            for (int kb = 0; kb < nkb; ++kb) {
              if (kf > 0) hop::mbar_wait(kempty, (kf - 1) & 1);
              load_block(ks, kfull, &tma_k, kb);
              ++kf;
              if (pass == 1) {
                if (vf > 0) hop::mbar_wait(vempty, (vf - 1) & 1);
                load_block(vs, vfull, &tma_v, kb);
                ++vf;
              }
            }
        }
      }
    }
    return;
  }

  hop::setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const unsigned char* qw = qs + wgi * NT * CHUNK;
  const int rl = warp * 16 + (lane >> 2);    // this thread's rows rl, rl + 8
  float s[128], st[8], o[NT * 32];
  // K9: p of the CLS column of rows rl and rl + 8, v_cls, and the CLS
  // column's scores of this warpgroup's tile (in shared memory, so that no
  // register holds them across the wgmmas)
  float ppc0 = 0.f, ppc1 = 0.f;
  const float* vcls = cf + 256;
  float* spc = cf + CF_PC + wgi * QROWS;
  if constexpr (CLS) hop::mbar_wait(cready, 0);

  // K9: s_pc = (sum_d q_p[r, d] k_cls[d]) * scale from the staged Q tile,
  // before the tile's buffer is released
  auto cls_column = [&]() {
    if constexpr (MODE == CLS_COLUMN) {
      const float* kc = cf + 128;
      float spc0 = 0.f, spc1 = 0.f;
      for (int c = 8 * (lane & 3); c < cls.D; c += 32) {
        const uint4 r0 = *reinterpret_cast<const uint4*>(
            qw + hop::sw128_offset(rl, c, CHUNK));
        const uint4 r1 = *reinterpret_cast<const uint4*>(
            qw + hop::sw128_offset(rl + 8, c, CHUNK));
        const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
        const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f0 = unpack_bf16(w0[e]), f1 = unpack_bf16(w1[e]);
          spc0 = fmaf(f0.x, kc[c + 2 * e], spc0);
          spc0 = fmaf(f0.y, kc[c + 2 * e + 1], spc0);
          spc1 = fmaf(f1.x, kc[c + 2 * e], spc1);
          spc1 = fmaf(f1.y, kc[c + 2 * e + 1], spc1);
        }
      }
      spc0 = quad_sum(spc0);
      spc1 = quad_sum(spc1);
      if ((lane & 3) == 0) {
        spc[rl] = spc0 * qk_scale;
        spc[rl + 8] = spc1 * qk_scale;
      }
      __syncwarp();
    }
  };
  // K9: the CLS column joins the row maximum; after PV, its p joins the
  // row sum. In the tail both happened in the block: p_pc is st[0] and
  // st[2] of the quad's first lane, key 256
  auto cls_max = [&](float& m0, float& m1) {
    if constexpr (MODE == CLS_COLUMN) {
      m0 = fmaxf(m0, spc[rl]);
      m1 = fmaxf(m1, spc[rl + 8]);
    }
  };
  auto cls_sum = [&](float m0, float m1, float& l0, float& l1) {
    if constexpr (MODE == CLS_COLUMN) {
      ppc0 = nat_exp(spc[rl] - m0);
      ppc1 = nat_exp(spc[rl + 8] - m1);
      l0 += ppc0;
      l1 += ppc1;
    } else if constexpr (MODE == CLS_TAIL) {
      ppc0 = __shfl_sync(0xffffffffu, st[0], lane & ~3);
      ppc1 = __shfl_sync(0xffffffffu, st[2], lane & ~3);
    }
  };

  // o / l rounded to bf16 into this warpgroup's staging tile (128-byte
  // swizzle, conflict-free), then TMA stores that clip at L and D; K9 adds
  // p_pc v_cls in fp32 first
  auto store = [&](int qt, float l0, float l1) {
    unsigned char* ow = os + wgi * NT * CHUNK;
    if (tid == 0) hop::bulk_wait_read<0>();   // the last tile's stores
    hop::named_sync(1 + wgi, 128);
    const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < NT * 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      float x0 = o[4 * j], x1 = o[4 * j + 1], x2 = o[4 * j + 2],
            x3 = o[4 * j + 3];
      if constexpr (CLS) {
        x0 = fmaf(ppc0, vcls[col], x0);
        x1 = fmaf(ppc0, vcls[col + 1], x1);
        x2 = fmaf(ppc1, vcls[col], x2);
        x3 = fmaf(ppc1, vcls[col + 1], x3);
      }
      *reinterpret_cast<uint32_t*>(ow + hop::sw128_offset(rl, col, CHUNK)) =
          pack_bf16(div_by(x0, l0, r0), div_by(x1, l0, r0));
      *reinterpret_cast<uint32_t*>(ow + hop::sw128_offset(rl + 8, col, CHUNK)) =
          pack_bf16(div_by(x2, l1, r1), div_by(x3, l1, r1));
    }
    hop::fence_proxy_async();
    hop::named_sync(1 + wgi, 128);
    if (tid == 0) {
      for (int c = 0; c < NT; ++c)
        hop::tma_store_4d(&tma_o, ow + c * CHUNK, 64 * c, h, qt * QROWS, b);
      hop::bulk_commit();
    }
  };

  if constexpr (!STREAM) {
    // the whole row in registers: QK^T once, the maximum from registers
    hop::mbar_wait(kfull, 0);
    int n = 0;
    for (int qt = wgi; qt < nqt; qt += 2, ++n) {
      hop::mbar_wait(&qfull[wgi], n & 1);
      cls_column();
      block_scores<NT>(s, st, qw, ks, kch, 0, L, qk_scale, lane,
                       MODE == CLS_TAIL ? 256 : -1);
      if (tid == 0) hop::mbar_arrive(&qempty[wgi]);
      float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
      block_max(s, st, m0, m1);
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      cls_max(m0, m1);
#pragma unroll
      for (int i = 0; i < NT * 32; ++i) o[i] = 0.f;
      hop::mbar_wait(vfull, 0);
      block_pv<NT, CLS>(s, st, o, vs, kch, 0, m0, m1, l0, l1);
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      cls_sum(m0, m1, l0, l1);
      store(qt, l0, l1);
    }
  } else {
    // streamed key blocks: a first pass takes the row maximum, a second
    // recomputes each block's scores and exponentiates against it. A
    // warpgroup with no tile in the last round still takes each fill in
    // turn and releases it. The block buffers are addressed by key (less
    // the block's first key), as the resident path's are.
    int kn = 0, vn = 0;
    for (int r = 0; 2 * r < nqt; ++r) {
      const int qt = 2 * r + wgi;
      const bool act = qt < nqt;
      if (act) {
        hop::mbar_wait(&qfull[wgi], r & 1);
        cls_column();
      }
      float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++kn) {
        hop::mbar_wait(kfull, kn & 1);
        if (act) {
          block_scores<NT>(s, st, qw, ks - kb * KB * 128, kch, kb * KB, L,
                           qk_scale, lane);
          block_max(s, st, m0, m1);
        }
        if (tid == 0) hop::mbar_arrive(kempty);
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      cls_max(m0, m1);
#pragma unroll
      for (int i = 0; i < NT * 32; ++i) o[i] = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++kn, ++vn) {
        hop::mbar_wait(kfull, kn & 1);
        if (act)
          block_scores<NT>(s, st, qw, ks - kb * KB * 128, kch, kb * KB, L,
                           qk_scale, lane);
        if (tid == 0) hop::mbar_arrive(kempty);
        hop::mbar_wait(vfull, vn & 1);
        if (act)
          block_pv<NT, CLS>(s, st, o, vs - kb * KB * 128, kch, kb * KB, m0,
                            m1, l0, l1);
        if (tid == 0) hop::mbar_arrive(vempty);
      }
      if (act) {
        if (tid == 0) hop::mbar_arrive(&qempty[wgi]);
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        cls_sum(m0, m1, l0, l1);
        store(qt, l0, l1);
      }
    }
  }
  if (tid == 0) hop::bulk_wait<0>();
}

template <int NT, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
qkv_attn_kernel(const __grid_constant__ CUtensorMap tma_q,
                const __grid_constant__ CUtensorMap tma_k,
                const __grid_constant__ CUtensorMap tma_v,
                const __grid_constant__ CUtensorMap tma_o, int L, int H,
                float qk_scale) {
  attn_body<NT, STREAM, NO_CLS>(tma_q, tma_k, tma_v, tma_o, L, H, qk_scale,
                                ClsArgs{}, nullptr, nullptr);
}

// K9: a kernel of its own name, so that profiles tell it from K3's
template <int NT, bool STREAM, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
cls_attn_kernel(const __grid_constant__ CUtensorMap tma_q,
                const __grid_constant__ CUtensorMap tma_k,
                const __grid_constant__ CUtensorMap tma_v,
                const __grid_constant__ CUtensorMap tma_o,
                const __grid_constant__ CUtensorMap tma_k128,
                const __grid_constant__ CUtensorMap tma_kcls, int P, int H,
                const __grid_constant__ ClsArgs cls) {
  attn_body<NT, STREAM, MODE>(tma_q, tma_k, tma_v, tma_o, P, H, cls.scale,
                              cls, &tma_k128, &tma_kcls);
}

// tensor maps m[0..3] of the attention's operands: q, k, v and out over
// (D, H, rows, B), `rows` of each batch row starting at the base pointers,
// rows `ld` (out: `ldo`) elements apart and batch rows `bstride`
// (`bstride_o`)
inline cudaError_t make_maps(CUtensorMap* m, const bf16* q,
                             const bf16* k, const bf16* v, int ld,
                             size_t bstride, bf16* out, int ldo,
                             size_t bstride_o, int B, int rows, int H,
                             int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ld * 2,
                                 (cuuint64_t)bstride * 2};
  const cuuint32_t qbox[4] = {64, 1, QROWS, 1};
  const cuuint32_t kvbox[4] = {64, 1, KBOX, 1};
  const cuuint64_t ostrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ldo * 2,
                                  (cuuint64_t)bstride_o * 2};
  cudaError_t e = hop::make_map(&m[0], q, 4, dims, strides, qbox);
  if (e == cudaSuccess) e = hop::make_map(&m[1], k, 4, dims, strides, kvbox);
  if (e == cudaSuccess) e = hop::make_map(&m[2], v, 4, dims, strides, kvbox);
  if (e == cudaSuccess) e = hop::make_map(&m[3], out, 4, dims, ostrides, qbox);
  return e;
}

// q, k, v: the head-0 columns of batch row 0 of three bf16 operands whose
// rows lie `ld` elements apart (batch rows L * ld apart; for a fused qkv
// (B*L, 3W): qkv, qkv + W, qkv + 2W with ld = 3W); out (B, L, H*D). D a
// multiple of 8 up to 128, ld a multiple of 8 and the pointers 16-byte
// aligned (TMA's strides and addresses; the wrappers check); any L.
inline cudaError_t launch_attn(const bf16* q, const bf16* k, const bf16* v,
                               int ld, bf16* out, int B, int L, int H, int D,
                               float qk_scale, cudaStream_t stream) {
  if (D % 8 || D > 128 || D <= 0 || L <= 0 || ld % 8)
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, k, v, ld, (size_t)ld * L, out, H * D,
                            (size_t)H * D * L, B, L, H, D);
  if (e != cudaSuccess) return e;
  int dev;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(D);
  const dim3 grid(B * H);
  const bool stream_kv = L > KB;
  if (D > 64 && stream_kv) {
    e = hop::smem_opt_in<2>((const void*)qkv_attn_kernel<2, true>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<2, true><<<grid, THREADS, smem, stream>>>(
        m[0], m[1], m[2], m[3], L, H, qk_scale);
  } else if (D > 64) {
    e = hop::smem_opt_in<3>((const void*)qkv_attn_kernel<2, false>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<2, false><<<grid, THREADS, smem, stream>>>(
        m[0], m[1], m[2], m[3], L, H, qk_scale);
  } else if (stream_kv) {
    e = hop::smem_opt_in<4>((const void*)qkv_attn_kernel<1, true>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<1, true><<<grid, THREADS, smem, stream>>>(
        m[0], m[1], m[2], m[3], L, H, qk_scale);
  } else {
    e = hop::smem_opt_in<5>((const void*)qkv_attn_kernel<1, false>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<1, false><<<grid, THREADS, smem, stream>>>(
        m[0], m[1], m[2], m[3], L, H, qk_scale);
  }
  return cudaGetLastError();
}

// one instance of K9's kernel (ID tells the instances' opt-ins apart)
template <int NT, bool STREAM, int MODE, int ID>
inline cudaError_t launch_cls_instance(const CUtensorMap (&m)[6], int B,
                                       int P, int H, const ClsArgs& cls,
                                       size_t smem, int dev,
                                       cudaStream_t stream) {
  cudaError_t e = hop::smem_opt_in<ID>(
      (const void*)cls_attn_kernel<NT, STREAM, MODE>, dev);
  if (e != cudaSuccess) return e;
  cls_attn_kernel<NT, STREAM, MODE><<<B * H, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], P, H, cls);
  return cudaGetLastError();
}

// K9: qkv the fused (B, L, 3W) projection (row 0 of each batch row the CLS
// token), out (B, L, W); D a multiple of 8 up to 128, L >= 2. The patch
// rows' maps start one row down (qkv + 3W: 16-byte aligned, as 3W % 8 ==
// 0) and span P = L - 1 rows, batch rows L rows apart; at P <= 256 two
// more maps over the unshifted K (boxes of 128 rows, and of its CLS row)
// fill the key block's tail.
inline cudaError_t launch_cls(const bf16* qkv, bf16* out, int B, int L,
                              int H, int D, float scale,
                              cudaStream_t stream) {
  const int W = H * D, ld = 3 * W, P = L - 1;
  if (D % 8 || D > 128 || D <= 0 || P <= 0) return cudaErrorInvalidValue;
  CUtensorMap m[6];
  cudaError_t e = make_maps(m, qkv + ld, qkv + ld + W, qkv + ld + 2 * W, ld,
                            (size_t)ld * L, out + W, W, (size_t)W * L, B, P,
                            H, D);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * 2 * L};
  const cuuint32_t box128[4] = {64, 1, 128, 1}, box1[4] = {64, 1, 1, 1};
  e = hop::make_map(&m[4], qkv + W, 4, dims, strides, box128);
  if (e == cudaSuccess)
    e = hop::make_map(&m[5], qkv + W, 4, dims, strides, box1);
  if (e != cudaSuccess) return e;
  int dev;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const ClsArgs cls{qkv, out, L, ld, W, D, scale};
  const size_t smem = smem_bytes(D, true);
  if (P > KB)
    return D > 64 ? launch_cls_instance<2, true, CLS_COLUMN, 6>(
                        m, B, P, H, cls, smem, dev, stream)
                  : launch_cls_instance<1, true, CLS_COLUMN, 7>(
                        m, B, P, H, cls, smem, dev, stream);
  if (P > 256)
    return D > 64 ? launch_cls_instance<2, false, CLS_COLUMN, 8>(
                        m, B, P, H, cls, smem, dev, stream)
                  : launch_cls_instance<1, false, CLS_COLUMN, 9>(
                        m, B, P, H, cls, smem, dev, stream);
  return D > 64 ? launch_cls_instance<2, false, CLS_TAIL, 10>(
                      m, B, P, H, cls, smem, dev, stream)
                : launch_cls_instance<1, false, CLS_TAIL, 11>(
                      m, B, P, H, cls, smem, dev, stream);
}

}  // namespace qattn
}  // namespace mico
