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
// every product accumulated in fp32 on wgmma, every result written in bf16
// at the q/k/v column offsets of its output rows.
//
// What bounds it on the H100: bytes. At the train step's vision pass
// (qkv (32, 257, 4224) and g (32, 257, 1408) bf16, 16 heads of 88) it reads
// 92.7 MB and writes 69.5 MB: 0.048 ms at 3.35 TB/s, against 29.8 GFLOP,
// 0.030 ms at 989 TFLOP/s.
//
// Design. The TPU body keeps one head's fp32 (L, L) scores whole in VMEM;
// an SM has 227 KB of shared memory, and L = 257 takes 264 KB. So two
// launches share the work, both on the machinery of K3's attention
// (qkv_attn.cuh): TMA loads through one 4-D tensor map an operand (base
// pointer and row stride: q/k/v at ld 3W or W, g at W; zeros past L and
// D), a producer warpgroup that issues them (setmaxnreg 40) and two
// consumer warpgroups of 64-row tiles (232 registers), mbarriers between.
//  - rows (`k4_rows_kernel`), a block per (b, h): K and V of the head
//    staged once (272 keys a block; past 272 they stream through the same
//    buffers), Q and G tiles of 64 rows refilled per warpgroup. S = Q K^T
//    runs once, with the whole row in registers, for the exact maximum and
//    sum and the fp32 p = e / l; then dP = G V^T in chunks of 64 keys (and
//    the 16-key tail) against p gives delta. Then, chunk by chunk, S and dP
//    are taken again, ds is made in registers in wgmma's A layout and
//    dQ += dS K runs with A from registers. (m, l, 1/l, delta) go to an
//    fp32 (B, H, L rounded up to 64) float4 scratch, dQ to its rows.
//  - columns (`k4_cols_kernel`), a block per (b, h, 128 keys): each
//    consumer warpgroup keeps the K and V rows of its 64 keys resident and
//    the producer streams (Q, G, statistics) tiles of 64 queries through a
//    4-stage ring shared by both. For each tile: S^T = K Q^T and dP^T =
//    V G^T on wgmma, P^T and dS^T from the statistics in registers, then
//    dV += P^T G and dK += dS^T Q with A from registers.
// Products: S twice, dP twice and dQ in the rows launch, S^T, dP^T, dV and
// dK in the columns launch: nine L x L x D products where the TPU body has
// five, none with a division in it (p = e / l as a reciprocal product and
// one FMA correction, qkv_attn.cuh `div_by`). Where the last query tile
// would hold one row (L % 64 == 1: ViT's 257), that row leaves the
// tensor cores: in the rows launch the producer warpgroup's three idle
// warps take its statistics and dq in fp32 (`tail_row`), so 257 rows are
// four tiles split 2:2 between the consumers, and the columns launch adds
// its rank-1 terms to dK and dV from its ring stage after the tiles. Any L: the rows launch
// streams key blocks past 272 keys, the columns launch streams queries.
// D: any multiple of 8 up to 128, in 64-column chunks; the products over D
// run 4 k16 steps up to D 64, 6 up to 96 (at D 88 the columns past 96 are
// zeros) and 8 past it; the accumulators over D span whole chunks.

#include "qkv_attn.cuh"

namespace mico {
namespace k4 {

using qattn::CHUNK;
using qattn::KB;
using qattn::KBOX;
using qattn::QROWS;
using qattn::THREADS;
using qattn::div_by;

constexpr int kch = KB * 128;     // bytes of a 64-column chunk of a key block
constexpr int STAGES = 4;         // the columns launch's ring of query tiles
constexpr int STATS_BYTES = QROWS * 16;   // a tile's float4 statistics

// d (64 x N) = A . B^T over D: a 64-row tile A and N = 64 or 16 rows of B,
// both K-major in 64-column chunks `a_ch` and `b_ch` bytes apart, KS k16
// steps (issued only: the caller fences, commits and waits)
template <int KS, int N>
__device__ __forceinline__ void ss_tile(float (&d)[N / 2],
                                        const unsigned char* a, int a_ch,
                                        const unsigned char* b, int b_ch) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t da =
        hop::desc_sw128(a + (kk >> 2) * a_ch + (kk & 3) * 32, 16, 1024);
    const uint64_t db =
        hop::desc_sw128(b + (kk >> 2) * b_ch + (kk & 3) * 32, 16, 1024);
    if constexpr (N == 64)
      hop::wgmma_ss_n64<0>(d, da, db, kk > 0);
    else
      hop::wgmma_ss_n16<0>(d, da, db, kk > 0);
  }
}

// o (64 x 64 NT) += A (64 x 16 KS, registers) . B, B's 16 KS rows in
// 64-column chunks `b_ch` bytes apart (MN-major; issued only)
template <int NT, int KS>
__device__ __forceinline__ void rs_acc(float (&o)[NT * 32],
                                       const uint32_t (&a)[KS][4],
                                       const unsigned char* b, int b_ch) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint64_t db = hop::desc_sw128(b + 16 * k * 128, b_ch, 1024);
    if constexpr (NT == 2)
      hop::wgmma_rs_n128(o, a[k], db);
    else
      hop::wgmma_rs_n64(o, a[k], db);
  }
}

// an accumulator of N/16 k16 steps -> bf16 A fragments (hopper.cuh)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&d)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[k][e] = pack_bf16(d[8 * k + 2 * e], d[8 * k + 2 * e + 1]);
}

// rows rl and rl + 8 of a 64-row accumulator tile (bf16, columns past D
// and rows past L dropped) at out + row * ld
template <int NT>
__device__ __forceinline__ void store_tile(bf16* out, size_t ld, int row0,
                                           int rl, int L, int D, int q2,
                                           const float (&o)[NT * 32]) {
#pragma unroll
  for (int j = 0; j < NT * 8; ++j) {
    const int col = 8 * j + q2;
    if (col < D) {
      if (row0 + rl < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + rl) * ld + col) =
            pack_bf16(o[4 * j], o[4 * j + 1]);
      if (row0 + rl + 8 < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + rl + 8) * ld +
                                     col) = pack_bf16(o[4 * j + 2],
                                                      o[4 * j + 3]);
    }
  }
}

struct Rows {
  float4* stats;   // (B, H, Lp): m, l, 1/l, delta of each query row
  bf16* dq;        // the head-0 column of batch row 0, rows ldo apart
  const bf16* q;   // q and g likewise, rows ld and H * D apart (the lone
  const bf16* g;   // last row's fp32 path)
  int ld, ldo, L, H, D, Lp;
  float qk2, scale;
};

// The lone last query row r = L - 1 of a resident head whose L % 64 == 1
// (L = 257: four full tiles, 2:2 between the consumer warpgroups, and this
// row), in fp32 on the producer warpgroup's three warps that issue no
// copies (`ct` 0..95), at `_packed_bwd_body`'s rounding points: s, m, l,
// p = e / l, dp, delta = sum dp p, ds = bf16(p (dp - delta) scale) and
// dq = sum ds k over K and V of the staged key block; its statistics go
// with the others'. bf16 products are exact in fp32, so only the order of
// the sums differs from the tensor cores'. Loops stay rolled: this runs in
// setmaxnreg's 40 registers.
constexpr int TAIL_THREADS = 96;
constexpr int TAIL_FLOATS = 256 + 2 * KB + 2 * TAIL_THREADS + 8;

__device__ __forceinline__ void tail_row(const Rows& a, int b, int h, int ct,
                                         float* tf, uint64_t* kfull,
                                         uint64_t* vfull,
                                         const unsigned char* ks,
                                         const unsigned char* vs) {
  float* qr = tf;                        // q and g of row r in fp32
  float* gr = tf + 128;
  float* sb = tf + 256;                  // s, then p, of each key
  float* db = sb + KB;                   // dp, then ds
  float* ab = db + KB;                   // dq's column sums by key group
  float* red = ab + 2 * TAIL_THREADS;    // per-warp reductions
  const int L = a.L, D = a.D, r = L - 1;
  const bf16* qrow = a.q + ((size_t)b * L + r) * a.ld + (size_t)h * D;
  const bf16* grow = a.g + ((size_t)b * L + r) * a.H * D + (size_t)h * D;
  for (int i = ct; i < 128; i += TAIL_THREADS) {
    qr[i] = i < D ? __bfloat162float(qrow[i]) : 0.f;
    gr[i] = i < D ? __bfloat162float(grow[i]) : 0.f;
  }
  hop::named_sync(3, TAIL_THREADS);
  // sum_d x[d] row j of a staged key-block buffer
  auto dot = [&](const unsigned char* buf, const float* x, int j) {
    float acc = 0.f;
#pragma unroll 1
    for (int c = 0; c < D; c += 8) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(buf + hop::sw128_offset(j, c, kch));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w[e]);
        acc = fmaf(f.x, x[c + 2 * e], acc);
        acc = fmaf(f.y, x[c + 2 * e + 1], acc);
      }
    }
    return acc;
  };
  const int warp = ct >> 5, lane = ct & 31;
  hop::mbar_wait(kfull, 0);
  float m = NEG_BIG;
  for (int j = ct; j < L; j += TAIL_THREADS) {
    const float x = dot(ks, qr, j) * a.qk2;
    sb[j] = x;
    m = fmaxf(m, x);
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  hop::named_sync(3, TAIL_THREADS);
  m = fmaxf(fmaxf(red[0], red[1]), red[2]);
  float l = 0.f;
  for (int j = ct; j < L; j += TAIL_THREADS) {
    const float e = fast_exp2(sb[j] - m);
    sb[j] = e;
    l += e;
  }
  l = warp_sum(l);
  if (lane == 0) red[4 + warp] = l;
  hop::named_sync(3, TAIL_THREADS);
  l = red[4] + red[5] + red[6];
  const float rinv = 1.f / l;
  hop::mbar_wait(vfull, 0);
  float d = 0.f;
  for (int j = ct; j < L; j += TAIL_THREADS) {
    const float p = div_by(sb[j], l, rinv);
    const float dp = dot(vs, gr, j);
    sb[j] = p;
    db[j] = dp;
    d = fmaf(dp, p, d);
  }
  d = warp_sum(d);
  if (lane == 0) red[warp] = d;   // red[0..2] were read before the last sync
  hop::named_sync(3, TAIL_THREADS);
  d = red[0] + red[1] + red[2];
  for (int j = ct; j < L; j += TAIL_THREADS)
    db[j] = __bfloat162float(
        __float2bfloat16_rn(sb[j] * (db[j] - d) * a.scale));
  hop::named_sync(3, TAIL_THREADS);
  // dq[2cp, 2cp + 1] over key group grp's run of keys
  const int npair = D / 2, groups = TAIL_THREADS / npair;
  const int cp = ct % npair, grp = ct / npair;
  if (grp < groups) {
    const int per = (L + groups - 1) / groups, j1 = min(L, (grp + 1) * per);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 1
    for (int j = grp * per; j < j1; ++j) {
      const float2 f = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          ks + hop::sw128_offset(j, 2 * cp, kch)));
      acc0 = fmaf(db[j], f.x, acc0);
      acc1 = fmaf(db[j], f.y, acc1);
    }
    ab[2 * ct] = acc0;
    ab[2 * ct + 1] = acc1;
  }
  hop::named_sync(3, TAIL_THREADS);
  if (ct < npair) {
    float o0 = 0.f, o1 = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      o0 += ab[2 * (gi * npair + ct)];
      o1 += ab[2 * (gi * npair + ct) + 1];
    }
    *reinterpret_cast<uint32_t*>(a.dq + ((size_t)b * L + r) * a.ldo +
                                 (size_t)h * D + 2 * ct) = pack_bf16(o0, o1);
  }
  if (ct == 0)
    a.stats[((size_t)b * a.H + h) * a.Lp + r] = make_float4(m, l, rinv, d);
}

// ds = bf16(p (dp - delta) scale) of one chunk (N keys from key k0) as
// wgmma A fragments, from its S (in sc, overwritten) and dP
template <int N>
__device__ __forceinline__ void chunk_ds(uint32_t (&ds)[N / 16][4],
                                         float (&sc)[N / 2],
                                         const float (&dp)[N / 2], int k0,
                                         const Rows& a, int q2, float m0,
                                         float m1, float l0, float l1,
                                         float r0, float r1, float d0,
                                         float d1) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int key = k0 + 8 * (i >> 2) + q2 + (i & 1);
    const bool hi = i & 2;
    const float p =
        key < a.L ? div_by(fast_exp2(sc[i] * a.qk2 - (hi ? m1 : m0)),
                           hi ? l1 : l0, hi ? r1 : r0)
                  : 0.f;
    sc[i] = p * (dp[i] - (hi ? d1 : d0)) * a.scale;
  }
  pack_a<N>(ds, sc);
}

// dQ += dS K over chunk c of a key block (N keys from key k0, K and V at
// kc and vc), with S and dP taken again for it
template <int NT, int KS, int N>
__device__ __forceinline__ void chunk_dq(float (&o)[NT * 32],
                                         const unsigned char* qw,
                                         const unsigned char* gw,
                                         const unsigned char* kc,
                                         const unsigned char* vc, int k0,
                                         const Rows& a, int q2, float m0,
                                         float m1, float l0, float l1,
                                         float r0, float r1, float d0,
                                         float d1) {
  float sc[N / 2], dp[N / 2];
  hop::fence_regs(sc);
  hop::fence_regs(dp);
  hop::wgmma_fence();
  ss_tile<KS, N>(sc, qw, CHUNK, kc, kch);
  ss_tile<KS, N>(dp, gw, CHUNK, vc, kch);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(sc);
  hop::fence_regs(dp);
  uint32_t ds[N / 16][4];
  chunk_ds<N>(ds, sc, dp, k0, a, q2, m0, m1, l0, l1, r0, r1, d0, d1);
  hop::fence_regs(o);
  hop::wgmma_fence();
  rs_acc<NT, N / 16>(o, ds, kc, kch);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(o);
}

// dQ += dS K over one key block (K and V at kb_ and vb; its first key k0):
// four chunks of 64 keys, then the 16-key tail
template <int NT, int KS>
__device__ __forceinline__ void block_dq(float (&o)[NT * 32],
                                         const unsigned char* qw,
                                         const unsigned char* gw,
                                         const unsigned char* kb_,
                                         const unsigned char* vb, int k0,
                                         const Rows& a, int q2, float m0,
                                         float m1, float l0, float l1,
                                         float r0, float r1, float d0,
                                         float d1) {
#pragma unroll 1
  for (int c = 0; c < 4; ++c)
    chunk_dq<NT, KS, 64>(o, qw, gw, kb_ + c * 64 * 128, vb + c * 64 * 128,
                         k0 + 64 * c, a, q2, m0, m1, l0, l1, r0, r1, d0, d1);
  chunk_dq<NT, KS, 16>(o, qw, gw, kb_ + 256 * 128, vb + 256 * 128, k0 + 256,
                       a, q2, m0, m1, l0, l1, r0, r1, d0, d1);
}

// delta += dp . p over one chunk (N keys) of the block, its p at p[OFF..]
template <int KS, int N, int OFF, int M>
__device__ __forceinline__ void chunk_delta(const float (&p)[M],
                                            const unsigned char* gw,
                                            const unsigned char* vc,
                                            float& d0, float& d1) {
  float dp[N / 2];
  hop::fence_regs(dp);
  hop::wgmma_fence();
  ss_tile<KS, N>(dp, gw, CHUNK, vc, kch);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(dp);
#pragma unroll
  for (int i = 0; i < N / 2; i += 4) {
    d0 = fmaf(dp[i + 1], p[OFF + i + 1], fmaf(dp[i], p[OFF + i], d0));
    d1 = fmaf(dp[i + 3], p[OFF + i + 3], fmaf(dp[i + 2], p[OFF + i + 2], d1));
  }
}

template <int NT, int KS, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
k4_rows_kernel(const __grid_constant__ CUtensorMap tma_q,
               const __grid_constant__ CUtensorMap tma_k,
               const __grid_constant__ CUtensorMap tma_v,
               const __grid_constant__ CUtensorMap tma_g,
               const __grid_constant__ Rows a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* ks = smem;                  // [chunk] one key block of K
  unsigned char* vs = ks + NT * kch;         // ... and of V
  unsigned char* qs = vs + NT * kch;         // [warpgroup][chunk] Q tiles
  unsigned char* gs = qs + 2 * NT * CHUNK;   // ... and G tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(gs + 2 * NT * CHUNK);
  uint64_t* kfull = bars;
  uint64_t* vfull = bars + 1;
  uint64_t* qfull = bars + 2;                // [2] Q and G
  uint64_t* qempty = bars + 4;               // [2]
  uint64_t* kempty = bars + 6;               // streamed blocks only
  uint64_t* vempty = bars + 7;
  float* tf = reinterpret_cast<float*>(bars + 8);   // the lone row's

  const int L = a.L, H = a.H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nkb = (L + KB - 1) / KB;
  // a resident head whose last tile holds one row leaves it to tail_row
  const bool tail = !STREAM && L > QROWS && L % QROWS == 1;
  const int nqt = (L + QROWS - 1) / QROWS - tail;
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
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    hop::setmaxnreg_dec<40>();
    if (tail && threadIdx.x >= 256 + 32)
      tail_row(a, b, h, threadIdx.x - 256 - 32, tf, kfull, vfull, ks, vs);
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tma_q);
      hop::prefetch_map(&tma_k);
      hop::prefetch_map(&tma_v);
      hop::prefetch_map(&tma_g);
      auto load_qg = [&](int qt) {
        const int w = qt & 1, n = qt >> 1;
        if (n > 0) hop::mbar_wait(&qempty[w], (n - 1) & 1);
        hop::mbar_expect_tx(&qfull[w], 2 * NT * CHUNK);
        for (int c = 0; c < NT; ++c) {
          hop::tma_load_4d(qs + (w * NT + c) * CHUNK, &tma_q, &qfull[w],
                           64 * c, h, qt * QROWS, b);
          hop::tma_load_4d(gs + (w * NT + c) * CHUNK, &tma_g, &qfull[w],
                           64 * c, h, qt * QROWS, b);
        }
      };
      auto load_block = [&](unsigned char* dst, uint64_t* bar,
                            const CUtensorMap* map, int kb) {
        hop::mbar_expect_tx(bar, NT * kch);
        for (int c = 0; c < NT; ++c)
          for (int r = 0; r < KB; r += KBOX)
            hop::tma_load_4d(dst + c * kch + r * 128, map, bar, 64 * c, h,
                             kb * KB + r, b);
      };
      if constexpr (!STREAM) {
        if (nqt > 0) load_qg(0);
        if (nqt > 1) load_qg(1);
        load_block(ks, kfull, &tma_k, 0);
        load_block(vs, vfull, &tma_v, 0);
        for (int qt = 2; qt < nqt; ++qt) load_qg(qt);
      } else {
        // each round of two tiles streams K four times (the maximum, the
        // sum, delta, dQ) and V twice (delta, dQ), a block at a time, each
        // fill once both warpgroups have released the last
        int kf = 0, vf = 0;
        for (int qt = 0; qt < nqt; qt += 2) {
          load_qg(qt);
          if (qt + 1 < nqt) load_qg(qt + 1);
          for (int pass = 0; pass < 4; ++pass)
            for (int kb = 0; kb < nkb; ++kb) {
              if (kf > 0) hop::mbar_wait(kempty, (kf - 1) & 1);
              load_block(ks, kfull, &tma_k, kb);
              ++kf;
              if (pass >= 2) {
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
  const unsigned char* gw = gs + wgi * NT * CHUNK;
  const int rl = warp * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  float s[128], st[8], o[NT * 32];

  // p = e / l in place, e already in s and st
  auto normalise = [&](float l0, float l1, float r0, float r1) {
#pragma unroll
    for (int i = 0; i < 128; i += 4) {
      s[i] = div_by(s[i], l0, r0);
      s[i + 1] = div_by(s[i + 1], l0, r0);
      s[i + 2] = div_by(s[i + 2], l1, r1);
      s[i + 3] = div_by(s[i + 3], l1, r1);
    }
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      st[i] = div_by(st[i], l0, r0);
      st[i + 1] = div_by(st[i + 1], l0, r0);
      st[i + 2] = div_by(st[i + 2], l1, r1);
      st[i + 3] = div_by(st[i + 3], l1, r1);
    }
  };
  // e = exp2(s - m) in place, summed into l
  auto exponentiate = [&](float m0, float m1, float& l0, float& l1) {
#pragma unroll
    for (int i = 0; i < 128; i += 4) {
      s[i] = fast_exp2(s[i] - m0);
      s[i + 1] = fast_exp2(s[i + 1] - m0);
      s[i + 2] = fast_exp2(s[i + 2] - m1);
      s[i + 3] = fast_exp2(s[i + 3] - m1);
      l0 += s[i] + s[i + 1];
      l1 += s[i + 2] + s[i + 3];
    }
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      st[i] = fast_exp2(st[i] - m0);
      st[i + 1] = fast_exp2(st[i + 1] - m0);
      st[i + 2] = fast_exp2(st[i + 2] - m1);
      st[i + 3] = fast_exp2(st[i + 3] - m1);
      l0 += st[i] + st[i + 1];
      l1 += st[i + 2] + st[i + 3];
    }
  };
  // delta's share of one key block (p in s, st; V at vb, by key)
  auto block_delta = [&](const unsigned char* vb, float& d0, float& d1) {
    chunk_delta<KS, 64, 0>(s, gw, vb, d0, d1);
    chunk_delta<KS, 64, 32>(s, gw, vb + 64 * 128, d0, d1);
    chunk_delta<KS, 64, 64>(s, gw, vb + 128 * 128, d0, d1);
    chunk_delta<KS, 64, 96>(s, gw, vb + 192 * 128, d0, d1);
    chunk_delta<KS, 16, 0>(st, gw, vb + 256 * 128, d0, d1);
  };
  auto finish = [&](int qt, float m0, float m1, float l0, float l1,
                    float r0, float r1, float d0, float d1) {
    const size_t bh = (size_t)b * H + h;
    const int row = qt * QROWS + rl;
    if ((lane & 3) == 0) {
      if (row < L) a.stats[bh * a.Lp + row] = make_float4(m0, l0, r0, d0);
      if (row + 8 < L)
        a.stats[bh * a.Lp + row + 8] = make_float4(m1, l1, r1, d1);
    }
    store_tile<NT>(a.dq + (size_t)b * L * a.ldo + (size_t)h * a.D, a.ldo,
                   qt * QROWS, rl, L, a.D, q2, o);
  };

  if constexpr (!STREAM) {
    // the whole row in registers: S once for the maximum, the sum and p
    hop::mbar_wait(kfull, 0);
    int n = 0;
    for (int qt = wgi; qt < nqt; qt += 2, ++n) {
      hop::mbar_wait(&qfull[wgi], n & 1);
      qattn::block_scores<NT, KS>(s, st, qw, ks, kch, 0, L, a.qk2, lane);
      float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
      qattn::block_max(s, st, m0, m1);
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      exponentiate(m0, m1, l0, l1);
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float r0 = 1.f / l0, r1 = 1.f / l1;
      normalise(l0, l1, r0, r1);
      if (n == 0) hop::mbar_wait(vfull, 0);
      float d0 = 0.f, d1 = 0.f;
      block_delta(vs, d0, d1);
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
#pragma unroll
      for (int i = 0; i < NT * 32; ++i) o[i] = 0.f;
      block_dq<NT, KS>(o, qw, gw, ks, vs, 0, a, q2, m0, m1, l0, l1, r0, r1,
                       d0, d1);
      if (tid == 0) hop::mbar_arrive(&qempty[wgi]);
      finish(qt, m0, m1, l0, l1, r0, r1, d0, d1);
    }
  } else {
    // streamed key blocks, four passes a round: the maximum, the sum,
    // delta, dQ. A warpgroup with no tile in the last round still takes
    // each fill in turn and releases it. The block buffers are addressed by
    // key less the block's first key, as the resident path's are.
    int kn = 0, vn = 0;
    for (int r = 0; 2 * r < nqt; ++r) {
      const int qt = 2 * r + wgi;
      const bool act = qt < nqt;
      if (act) hop::mbar_wait(&qfull[wgi], r & 1);
      float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++kn) {
        hop::mbar_wait(kfull, kn & 1);
        if (act) {
          qattn::block_scores<NT, KS>(s, st, qw, ks - kb * KB * 128, kch,
                                      kb * KB, L, a.qk2, lane);
          qattn::block_max(s, st, m0, m1);
        }
        if (tid == 0) hop::mbar_arrive(kempty);
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      for (int kb = 0; kb < nkb; ++kb, ++kn) {
        hop::mbar_wait(kfull, kn & 1);
        if (act) {
          qattn::block_scores<NT, KS>(s, st, qw, ks - kb * KB * 128, kch,
                                      kb * KB, L, a.qk2, lane);
          exponentiate(m0, m1, l0, l1);
        }
        if (tid == 0) hop::mbar_arrive(kempty);
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float r0 = 1.f / l0, r1 = 1.f / l1;
      float d0 = 0.f, d1 = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++kn, ++vn) {
        hop::mbar_wait(kfull, kn & 1);
        if (act) {
          qattn::block_scores<NT, KS>(s, st, qw, ks - kb * KB * 128, kch,
                                      kb * KB, L, a.qk2, lane);
          float z0 = 0.f, z1 = 0.f;
          exponentiate(m0, m1, z0, z1);
          normalise(l0, l1, r0, r1);
        }
        if (tid == 0) hop::mbar_arrive(kempty);
        hop::mbar_wait(vfull, vn & 1);
        if (act) block_delta(vs, d0, d1);
        if (tid == 0) hop::mbar_arrive(vempty);
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
#pragma unroll
      for (int i = 0; i < NT * 32; ++i) o[i] = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++kn, ++vn) {
        hop::mbar_wait(kfull, kn & 1);
        hop::mbar_wait(vfull, vn & 1);
        if (act)
          block_dq<NT, KS>(o, qw, gw, ks, vs, kb * KB, a, q2, m0, m1, l0, l1,
                           r0, r1, d0, d1);
        if (tid == 0) {
          hop::mbar_arrive(kempty);
          hop::mbar_arrive(vempty);
        }
      }
      if (act) {
        if (tid == 0) hop::mbar_arrive(&qempty[wgi]);
        finish(qt, m0, m1, l0, l1, r0, r1, d0, d1);
      }
    }
  }
}

struct Cols {
  const float4* stats;   // the rows launch's, (B, H, Lp)
  bf16* dk;              // head-0 columns of batch row 0, rows ldo apart
  bf16* dv;
  int ldo, L, H, D, Lp;
  float qk2, scale;
};

template <int NT, int KS>
__global__ void __launch_bounds__(THREADS, 1)
k4_cols_kernel(const __grid_constant__ CUtensorMap tma_q,
               const __grid_constant__ CUtensorMap tma_k,
               const __grid_constant__ CUtensorMap tma_v,
               const __grid_constant__ CUtensorMap tma_g,
               const __grid_constant__ Cols a) {
  constexpr int TILE = NT * CHUNK;                 // a 64-row operand tile
  constexpr int STAGE = 2 * TILE + STATS_BYTES;    // Q, G, statistics
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kt = smem;                  // [warpgroup] K rows
  unsigned char* vt = kt + 2 * TILE;         // [warpgroup] V rows
  unsigned char* ring = vt + 2 * TILE;       // [stage] Q, G, statistics
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* kvfull = bars;                   // [2]
  uint64_t* full = bars + 2;                 // [STAGES]
  uint64_t* empty = full + STAGES;           // [STAGES]

  const int L = a.L;
  const int b = blockIdx.z, h = blockIdx.y;
  // a last query tile of one row is taken in fp32 from its ring stage
  const bool tail = L > QROWS && L % QROWS == 1;
  const int nqt = (L + QROWS - 1) / QROWS;
  const int nact = (2 * blockIdx.x + 1) * QROWS < L ? 2 : 1;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) hop::mbar_init(&kvfull[i], 1);
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], nact);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    hop::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tma_q);
      hop::prefetch_map(&tma_k);
      hop::prefetch_map(&tma_v);
      hop::prefetch_map(&tma_g);
      for (int w = 0; w < nact; ++w) {
        const int j0 = (2 * blockIdx.x + w) * QROWS;
        hop::mbar_expect_tx(&kvfull[w], 2 * TILE);
        for (int c = 0; c < NT; ++c) {
          hop::tma_load_4d(kt + w * TILE + c * CHUNK, &tma_k, &kvfull[w],
                           64 * c, h, j0, b);
          hop::tma_load_4d(vt + w * TILE + c * CHUNK, &tma_v, &kvfull[w],
                           64 * c, h, j0, b);
        }
      }
      const float4* sb = a.stats + ((size_t)b * a.H + h) * a.Lp;
      for (int qt = 0; qt < nqt; ++qt) {
        const int si = qt % STAGES, n = qt / STAGES;
        unsigned char* stg = ring + si * STAGE;
        if (n > 0) hop::mbar_wait(&empty[si], (n - 1) & 1);
        hop::mbar_expect_tx(&full[si], STAGE);
        for (int c = 0; c < NT; ++c) {
          hop::tma_load_4d(stg + c * CHUNK, &tma_q, &full[si], 64 * c, h,
                           qt * QROWS, b);
          hop::tma_load_4d(stg + TILE + c * CHUNK, &tma_g, &full[si], 64 * c,
                           h, qt * QROWS, b);
        }
        hop::bulk_load(stg + 2 * TILE, sb + qt * QROWS, STATS_BYTES,
                       &full[si]);
      }
    }
    return;
  }
  if (wgi >= nact) return;   // past L: no keys, and no barrier follows

  hop::setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int rl = warp * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  const int j0 = (2 * blockIdx.x + wgi) * QROWS;   // this warpgroup's keys
  const unsigned char* kw = kt + wgi * TILE;
  const unsigned char* vw = vt + wgi * TILE;
  const bool key0 = j0 + rl < L, key1 = j0 + rl + 8 < L;
  float dk[NT * 32], dv[NT * 32];
#pragma unroll
  for (int i = 0; i < NT * 32; ++i) dk[i] = dv[i] = 0.f;
  hop::mbar_wait(&kvfull[wgi], 0);

  for (int qt = 0; qt < nqt - tail; ++qt) {
    const int si = qt % STAGES;
    const unsigned char* qn = ring + si * STAGE;
    const unsigned char* gn = qn + TILE;
    const float4* sn = reinterpret_cast<const float4*>(qn + 2 * TILE);
    hop::mbar_wait(&full[si], (qt / STAGES) & 1);
    // S^T (keys x queries) and dP^T
    float pt[32], dt[32];
    hop::fence_regs(pt);
    hop::fence_regs(dt);
    hop::wgmma_fence();
    ss_tile<KS, 64>(pt, kw, CHUNK, qn, CHUNK);
    ss_tile<KS, 64>(dt, vw, CHUNK, gn, CHUNK);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(pt);
    hop::fence_regs(dt);
    // P^T and dS^T from the rows' statistics; zero past L either way
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + q2 + (i & 1);
      const float4 sr = sn[col];
      const bool ok = qt * QROWS + col < L && ((i & 2) ? key1 : key0);
      const float p =
          ok ? div_by(fast_exp2(pt[i] * a.qk2 - sr.x), sr.y, sr.z) : 0.f;
      pt[i] = p;
      dt[i] = ok ? p * (dt[i] - sr.w) * a.scale : 0.f;
    }
    uint32_t pa[4][4], da[4][4];
    pack_a<64>(pa, pt);
    pack_a<64>(da, dt);
    hop::fence_regs(dv);
    hop::fence_regs(dk);
    hop::wgmma_fence();
    rs_acc<NT, 4>(dv, pa, gn, CHUNK);
    rs_acc<NT, 4>(dk, da, qn, CHUNK);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dv);
    hop::fence_regs(dk);
    if (tid == 0) hop::mbar_arrive(&empty[si]);
  }
  if (tail) {
    // the last stage's lone query row (row 0 of its tiles) as rank-1 terms:
    // dv += bf16(p) g_r and dk += bf16(ds) q_r for this thread's keys and
    // columns; s and dp over D in four parts across the quad
    const int qt = nqt - 1, si = qt % STAGES;
    const unsigned char* qn = ring + si * STAGE;
    const unsigned char* gn = qn + TILE;
    hop::mbar_wait(&full[si], (qt / STAGES) & 1);
    const float4 sr = reinterpret_cast<const float4*>(qn + 2 * TILE)[0];
    float sp[2] = {0.f, 0.f}, dpp[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT * 8; ++j) {
      const int col = 8 * j + q2, r0 = hop::sw128_offset(0, col, CHUNK);
      const float2 qv =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(qn + r0));
      const float2 gv =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(gn + r0));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int so = hop::sw128_offset(rl + 8 * e, col, CHUNK);
        const float2 kv =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(kw + so));
        const float2 vv =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(vw + so));
        sp[e] = fmaf(qv.y, kv.y, fmaf(qv.x, kv.x, sp[e]));
        dpp[e] = fmaf(gv.y, vv.y, fmaf(gv.x, vv.x, dpp[e]));
      }
    }
    float pb[2], db[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = quad_sum(sp[e]), dp = quad_sum(dpp[e]);
      const bool ok = e ? key1 : key0;
      const float p =
          ok ? div_by(fast_exp2(s * a.qk2 - sr.x), sr.y, sr.z) : 0.f;
      pb[e] = __bfloat162float(__float2bfloat16_rn(p));
      db[e] = __bfloat162float(
          __float2bfloat16_rn(ok ? p * (dp - sr.w) * a.scale : 0.f));
    }
#pragma unroll
    for (int j = 0; j < NT * 8; ++j) {
      const int r0 = hop::sw128_offset(0, 8 * j + q2, CHUNK);
      const float2 qv =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(qn + r0));
      const float2 gv =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(gn + r0));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dv[4 * j + 2 * e] = fmaf(pb[e], gv.x, dv[4 * j + 2 * e]);
        dv[4 * j + 2 * e + 1] = fmaf(pb[e], gv.y, dv[4 * j + 2 * e + 1]);
        dk[4 * j + 2 * e] = fmaf(db[e], qv.x, dk[4 * j + 2 * e]);
        dk[4 * j + 2 * e + 1] = fmaf(db[e], qv.y, dk[4 * j + 2 * e + 1]);
      }
    }
  }
  const size_t off = (size_t)b * L * a.ldo + (size_t)h * a.D;
  store_tile<NT>(a.dk + off, a.ldo, j0, rl, L, a.D, q2, dk);
  store_tile<NT>(a.dv + off, a.ldo, j0, rl, L, a.D, q2, dv);
}

inline size_t rows_smem(int nt) {
  return (size_t)2 * nt * kch + (size_t)4 * nt * CHUNK + 8 * 8 +
         4 * TAIL_FLOATS + 1024;
}

inline size_t cols_smem(int nt) {
  return (size_t)4 * nt * CHUNK +
         (size_t)STAGES * (2 * nt * CHUNK + STATS_BYTES) +
         (2 + 2 * STAGES) * 8 + 1024;
}

// NT 64-column chunks of D, KS k16 steps over D (6 at D 88: the columns
// past 96 are zeros); the rows launch, then the columns launch
template <int NT, int KS>
cudaError_t launch(const CUtensorMap (&m)[6], const Rows& rows,
                   const Cols& cols, int B, cudaStream_t stream) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  // maps: q, k, v and g by 64-row tiles; k and v by 136-row key boxes
  if (rows.L > KB) {
    e = hop::smem_opt_in<KS * 4>((const void*)k4_rows_kernel<NT, KS, true>,
                                 dev);
    if (e != cudaSuccess) return e;
    k4_rows_kernel<NT, KS, true><<<B * rows.H, THREADS, rows_smem(NT),
                                   stream>>>(m[0], m[4], m[5], m[3], rows);
  } else {
    e = hop::smem_opt_in<KS * 4 + 1>(
        (const void*)k4_rows_kernel<NT, KS, false>, dev);
    if (e != cudaSuccess) return e;
    k4_rows_kernel<NT, KS, false><<<B * rows.H, THREADS, rows_smem(NT),
                                    stream>>>(m[0], m[4], m[5], m[3], rows);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = hop::smem_opt_in<KS * 4 + 2>((const void*)k4_cols_kernel<NT, KS>, dev);
  if (e != cudaSuccess) return e;
  const dim3 grid((cols.L + 2 * QROWS - 1) / (2 * QROWS), cols.H, B);
  k4_cols_kernel<NT, KS><<<grid, THREADS, cols_smem(NT), stream>>>(
      m[0], m[1], m[2], m[3], cols);
  return cudaGetLastError();
}

}  // namespace k4
}  // namespace mico

// q, k, v: the head-0 columns of batch row 0, rows `ld` elements apart (the
// fused qkv: qkv, qkv + W, qkv + 2W with ld 3W); g (B, L, H*D) contiguous;
// stats a (B, H, Lp) float4 scratch with Lp = L rounded up to 64; dq, dk,
// dv likewise with row stride ldo. D a multiple of 8 up to 128; strides and
// pointers 16-byte aligned (the wrapper checks); any L.
extern "C" int mico_packed_attn_bwd(const void* q, const void* k,
                                    const void* v, int ld, const void* g,
                                    void* stats, void* dq, void* dk, void* dv,
                                    int ldo, int B, int L, int H, int D,
                                    float scale, void* stream) {
  using mico::bf16;
  using namespace mico::k4;
  if (D % 8 || D > 128 || D <= 0 || L <= 0 || ld % 8 || ldo % 8)
    return cudaErrorInvalidValue;
  const int W = H * D, Lp = (L + QROWS - 1) / QROWS * QROWS;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * 2 * L};
  const cuuint64_t gstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)W * 2,
                                  (cuuint64_t)W * 2 * L};
  const cuuint32_t tile[4] = {64, 1, QROWS, 1};
  const cuuint32_t kbox[4] = {64, 1, KBOX, 1};
  CUtensorMap m[6];   // q, k, v, g by tiles; k, v by key boxes
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t e = mico::hop::make_map(&m[i], src[i], 4, dims, strides, tile);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = mico::hop::make_map(&m[3], g, 4, dims, gstrides, tile);
  if (e == cudaSuccess)
    e = mico::hop::make_map(&m[4], k, 4, dims, strides, kbox);
  if (e == cudaSuccess)
    e = mico::hop::make_map(&m[5], v, 4, dims, strides, kbox);
  if (e != cudaSuccess) return e;
  const float qk2 = scale * mico::LOG2E;
  float4* st = static_cast<float4*>(stats);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* gp = static_cast<const bf16*>(g);
  const Rows rows{st, static_cast<bf16*>(dq), qp, gp, ld, ldo, L, H, D, Lp,
                  qk2, scale};
  const Cols cols{st, static_cast<bf16*>(dk), static_cast<bf16*>(dv), ldo,
                  L, H, D, Lp, qk2, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<1, 4>(m, rows, cols, B, s);
  if (D <= 96) return launch<2, 6>(m, rows, cols, B, s);
  return launch<2, 8>(m, rows, cols, B, s);
}
