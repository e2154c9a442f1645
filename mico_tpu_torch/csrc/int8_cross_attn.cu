// K7: dequant-fused int8 cross-attention for the KV-cached decode.
//
// Replaces the TPU kernel `_int8_cross_call` (mico_tpu/ops/int8_attention.py
// :86, pallas_call at :97; public entry `int8_cross_attention` :150) and its
// body `_int8_cross_kernel` (:56). For each batch row b and head h, q (Lq, 64)
// bf16 attends over K and V stored as int8 (Lk, 64) with one fp32 scale per
// (row, head), at the body's rounding points:
//   k = bf16(float(k8) * ks),  s = (q . k) in fp32, times `scale`;
//   p = exp(s - max_row s) in fp32, l = the row sum of the unrounded p;
//   v = bf16(float(v8) * vs),  o = bf16(p) . v in fp32;  out = bf16(o / l).
// The softmax is the body's full-row one (the exact row max over all Lk keys
// first), not an online one, which would move p's rounding point.
//
// What bounds it on the H100: memory bytes. At the captioner's beam decode
// step (B 64, Lq 6 = 2 rows x 3 beams, Lk 2056, H 768, 12 heads) one call
// reads 202.1 MB of int8 K/V, 12.6 MB of scales and 1.2 MB of q and output,
// 215.9 MB, for 2.42 GFLOP: 11 operations a byte, far below the 295 where
// the tensor cores would be the limit. Its bound is 0.0645 ms at 3.35 TB/s.
//
// Two plans, chosen by shape in Python (`k7_plan`, ops/int8_attention.py):
//
// The fast plan, `int8_cross_stream_kernel`: a persistent kernel that keeps
// the byte stream going and takes the products off the CUDA cores.
//  - About one CTA an SM walks the B * nh (batch row, head) items, item n =
//    CTA, CTA + CTAs, ...; consecutive CTAs take the heads of one batch row
//    together, so the scale sectors they share are read from L2.
//  - One producer thread streams each item's K, then its V, in stages of
//    192 key rows through a ring of `stages` (2..8) buffers on mbarriers:
//    a TMA box of one head's 64 int8 bytes x 192 rows of a 3-D map over
//    (H, Lk, B) (rows past Lk are zero fill), and a box of 4 heads' fp32
//    scales x 192 rows (TMA's inner box is 16 bytes at least, so a head's
//    4-byte column comes with 3 neighbours, from L2). The ring runs on into
//    the next item while the consumers finish the softmax and the output,
//    so the stream does not drain between passes or items.
//  - Twelve consumer warps take 16 keys of every stage each (eight left
//    the schedulers idle between dependent steps, sixteen gained nothing).
//    The products run on the tensor cores as mma.sync m16n8k16 (fp32
//    sums), the query rows as M (Lq <= 8 fills rows 0..7, the rest are
//    zero; Lq 9..16 takes all 16): S = Q K^T with K dequantised straight
//    into B fragments, then
//    O += bf16(P) V with P's A fragments made from S's accumulator layout
//    and V dequantised into B fragments. A permutation of the 64 head
//    columns, applied to q and k alike (q . k does not change), lets a lane
//    take 16 contiguous int8 bytes of a key row for all four k16 steps, and
//    one of the key rows inside a warp's 16 keeps the V pass's 8-byte reads
//    at the fewest shared-memory wavefronts. Dequantisation is exact: x + 128
//    is placed in the low byte of 2^23's mantissa and one subtraction gives
//    x, then one fp32 product with the scale and one bf16 rounding.
//  - S goes to shared memory in fp32 (each lane keeps its own slots, so no
//    other lane reads them), the row max meets across the warps once per
//    item, then the V pass makes p = exp(s - m) and l from the lane's own
//    slots. Each warp's partial O and l meet in fixed order (warp 0 first):
//    the output is deterministic.
//  - Shared memory: the ring, Lq rounded to 8 or 16 rows x Lk rounded to
//    192 fp32 scores, and the warps' partial O and statistics. Where that
//    does not fit one SM at 2 stages, or nh is not a multiple of 4 (the
//    scale map's rows must be 16-byte multiples), the plan takes the large
//    plan.
//  - The host encodes the four tensor maps once per (pointer, shape, stride)
//    of K, V and their scales (`mico_k7_maps`); the wrapper keeps them while
//    a decode's tensors stay the same, so a step pays no encoding.
// At the beam shape it takes 0.092 ms of device time on an H100 80GB HBM3
// at 700 W (0.70 of the bound; the block-per-item body below, 0.317).
// mma.sync is not what holds it: at eight warps, with every product
// replaced by two CUDA-core operations it took 13% less, without the
// dequantisation 18% less, and with no loads at all 6% less; instruction
// issue and each stage's dependent chain hold it
// (scripts/torch_int8_breakdown.py, PERF.md).
//
// The large plan, `int8_cross_kernel` (the first body, kept for the shapes
// the fast plan does not take: Lk up to what Lq x Lk fp32 scores in one
// block's shared memory allow, 9108 at Lq 6, and any nh): one block per
// (h, b), 256 threads, and every int8 byte read once with 16- and 8-byte
// loads. The products run on the CUDA cores in fp32 (a bf16 x bf16 product
// is exact in fp32, as in a tensor-core product with an fp32 sum) and the
// whole score matrix stays in shared memory:
//   1. scores: 4 lanes per key row; each takes 16 of the row's 64 int8 values
//      with one 16-byte load, dequantises them exactly, scales and rounds
//      them to bf16, and dots them with q, which sits in shared memory as
//      fp32; the 4 partial sums meet by shuffles. Each lane has 4 rows' loads
//      in flight before it uses the first.
//   2. softmax: one warp per query row: max, exp, the sum of the unrounded p;
//      p goes back into shared memory rounded to bf16, as PV takes it.
//   3. PV: 8 lanes per key row, each 8 int8 values of V (one 8-byte load),
//      with Lq x 8 fp32 sums over the lane's keys; the warps' partial sums
//      meet in shared memory, are divided by l and written as bf16.
// The Pallas kernel groups 8 batch rows per grid step (_GROUP, :50-53) to pay
// down a TPU grid step's fixed cost; that has no meaning here.

#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {
using namespace mico;

// ---------------------------------------------------------------------------
// the fast plan: persistent CTAs, a TMA ring, tensor-core products
// ---------------------------------------------------------------------------
namespace k7 {

constexpr int D = 64;                  // head dim (BERT-base: 768 / 12)
constexpr int WARPS = 12;              // consumer warps; one more produces
constexpr int THREADS = 32 * (WARPS + 1);
constexpr int STEP = 16;               // keys of a stage a warp takes
constexpr int ROWS = STEP * WARPS;     // keys a stage (the TMA box's rows)
constexpr int DATA = ROWS * D;         // int8 bytes of K or V a stage
constexpr int SCALES = ROWS * 16;      // a box of 4 heads' fp32 scales
constexpr int STAGE = DATA + SCALES;
constexpr int OSTRIDE = D + 4;         // a padded row of the partial O
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;

// shared memory of a launch (mirrored by `_k7_fast_smem_bytes` in Python):
// the 1024-byte alignment, the ring, the scores (LQT rows x nst stages of
// ROWS keys), the warps' partial O, their row maxima and sums, the
// mbarriers
__host__ __device__ constexpr int smem_bytes(int lqt, int nst, int stages) {
  return 1024 + stages * STAGE + nst * WARPS * 64 * lqt +
         WARPS * lqt * OSTRIDE * 4 + 2 * WARPS * lqt * 4 + 2 * stages * 8;
}

struct Args {
  const bf16* q;   // (B, Lq, H)
  bf16* o;         // (B, Lq, H)
  int Lq, Lk, H, nh, items, nst, stages;
  float scale;
};

// byte i of u as the int8 value it holds, u being the word with every
// byte's top bit flipped (x + 128)
__device__ __forceinline__ float byte_value(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// bf16(x_i s), bf16(x_{i+1} s) of bytes i, i + 1, packed (i in the low half)
__device__ __forceinline__ uint32_t dq2(uint32_t u, int i, float s) {
  return pack_bf16(byte_value(u, i) * s, byte_value(u, i + 1) * s);
}

// The layouts (g = lane / 4, c = lane % 4; mma.m16n8k16 in common.cuh):
//  - head columns: the k16 step s's logical columns 16s + 2c + {0, 1} and
//    16s + 8 + 2c + {0, 1} are the physical 16c + 4s + {0, 1} and
//    16c + 4s + {2, 3}: lane c's 16 bytes at 16c of a row hold its B
//    fragments of all four steps (word s), and q's A fragments are words
//    2s, 2s + 1 of its row's 16 columns from 16c;
//  - keys: a warp's 16 keys of a stage are two n8 tiles (S = Q K^T) and one
//    k16 step (O += P V). Column n of tile t is key row 8t + (n ^ (n/2 & 1))
//    of the 16, so lane c's accumulators c0, c1 of tile t are keys
//    8t + vr0, 8t + vr1 (vr0 = 2c + (c & 1), vr1 = 2c + 1 - (c & 1)), which
//    are the V rows its B fragments need; in each 8-byte read of V the
//    lanes' rows are two even and two odd, the fewest wavefronts;
//  - output columns: V's n8 tile t, column n is head column 8n + t (lane g
//    takes the 8 bytes at 8g of a row), so accumulators c0, c1 of tile t are
//    columns 16c + t and 16c + 8 + t.
template <int LQT>
__global__ void __launch_bounds__(THREADS, 1)
int8_cross_stream_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tks,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tvs,
                         const __grid_constant__ Args a) {
  constexpr int HALF = LQT / 8;   // query row blocks of 8 held by a lane
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hop::align1024(smem_raw);
  float* S = reinterpret_cast<float*>(ring + a.stages * STAGE);
  float* red_o = S + a.nst * WARPS * 16 * LQT;
  float* red_m = red_o + WARPS * LQT * OSTRIDE;
  float* red_l = red_m + WARPS * LQT;
  uint64_t* full = reinterpret_cast<uint64_t*>(red_l + WARPS * LQT);
  uint64_t* empty = full + a.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], WARPS);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == WARPS) {
    // the producer: each item's K stages, then its V stages, into the ring
    if (lane == 0) {
      hop::prefetch_map(&tk);
      hop::prefetch_map(&tks);
      hop::prefetch_map(&tv);
      hop::prefetch_map(&tvs);
      int slot = 0, phase = 0, round = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
        const int b = item / a.nh, h = item - b * a.nh;
        for (int pass = 0; pass < 2; ++pass) {
          const CUtensorMap* md = pass ? &tv : &tk;
          const CUtensorMap* ms = pass ? &tvs : &tks;
          for (int st = 0; st < a.nst; ++st) {
            if (round > 0) hop::mbar_wait(&empty[slot], phase ^ 1);
            hop::mbar_expect_tx(&full[slot], STAGE);
            unsigned char* dst = ring + slot * STAGE;
            hop::tma_load_3d(dst, md, &full[slot], h * D, st * ROWS, b);
            hop::tma_load_3d(dst + DATA, ms, &full[slot], h & ~3, st * ROWS,
                             b);
            if (++slot == a.stages) {
              slot = 0;
              phase ^= 1;
              round = 1;
            }
          }
        }
      }
    }
    return;
  }

  const int g = lane >> 2, c = lane & 3;
  const int kr = g ^ ((g >> 1) & 1);             // this lane's K row, tile 0
  const int vr0 = 2 * c + (c & 1), vr1 = 2 * c + 1 - (c & 1);
  float* s_own = S + (warp * 32 + lane) * 4;     // + st * WARPS * 128
  const int s_half = a.nst * WARPS * 128;        // rows g + 8 (LQT 16)
  int slot = 0, phase = 0;
  auto next_stage = [&]() {
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
    }
  };

  // q's words of an item: rows g (and g + 8), 16 columns from 16c, zero
  // past Lq (bf16 pairs from 2-byte loads: q needs no alignment)
  uint32_t qn[8 * HALF];
  auto fetch_q = [&](int item) {
    const int b = item / a.nh, h = item - b * a.nh;
#pragma unroll
    for (int r = 0; r < HALF; ++r) {
      const int row = g + 8 * r;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          a.q + ((long long)b * a.Lq + row) * a.H + h * D + 16 * c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t w = 0u;
        if (item < a.items && row < a.Lq)
          w = (uint32_t)__ldg(src + 2 * j) |
              ((uint32_t)__ldg(src + 2 * j + 1) << 16);
        qn[8 * r + j] = w;
      }
    }
  };

  fetch_q(blockIdx.x);
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int b = item / a.nh, h = item - b * a.nh;
    uint32_t qa[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      qa[s][0] = qn[2 * s];
      qa[s][2] = qn[2 * s + 1];
      qa[s][1] = HALF > 1 ? qn[8 + 2 * s] : 0u;
      qa[s][3] = HALF > 1 ? qn[8 + 2 * s + 1] : 0u;
    }

    // --- K pass: S = Q K^T by stage; this lane's row maxima ---
    struct KRaw {
      uint4 k0, k1;
      float s0, s1;
    };
    auto load_k = [&]() {
      hop::mbar_wait(&full[slot], phase);
      const unsigned char* kd = ring + slot * STAGE + warp * STEP * D + 16 * c;
      const float* sc = reinterpret_cast<const float*>(ring + slot * STAGE +
                                                       DATA) +
                        warp * STEP * 4 + (h & 3);
      KRaw r;
      r.k0 = *reinterpret_cast<const uint4*>(kd + kr * D);
      r.k1 = *reinterpret_cast<const uint4*>(kd + (8 + kr) * D);
      r.s0 = sc[kr * 4];
      r.s1 = sc[(8 + kr) * 4];
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[slot]);
      next_stage();
      return r;
    };
    float m0 = -INFINITY, m1 = -INFINITY;
    KRaw cur = load_k();
    for (int st = 0; st < a.nst; ++st) {
      KRaw nxt = cur;
      if (st + 1 < a.nst) nxt = load_k();
      float acc[2][4] = {};
      const uint32_t kw[2][4] = {{cur.k0.x, cur.k0.y, cur.k0.z, cur.k0.w},
                                 {cur.k1.x, cur.k1.y, cur.k1.z, cur.k1.w}};
      const float ksc[2] = {cur.s0, cur.s1};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t u = kw[t][s] ^ 0x80808080u;
          mma_bf16(acc[t], qa[s], dq2(u, 0, ksc[t]), dq2(u, 2, ksc[t]));
        }
      }
      const int key0 = st * ROWS + warp * STEP;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * t + ((e & 1) ? vr1 : vr0);
          acc[t][e] = key < a.Lk ? acc[t][e] * a.scale : -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(acc[t][0], acc[t][1]));
        m1 = fmaxf(m1, fmaxf(acc[t][2], acc[t][3]));
      }
      float* so = s_own + st * WARPS * 128;
      *reinterpret_cast<float4*>(so) =
          make_float4(acc[0][0], acc[0][1], acc[1][0], acc[1][1]);
      if (HALF > 1)
        *reinterpret_cast<float4*>(so + s_half) =
            make_float4(acc[0][2], acc[0][3], acc[1][2], acc[1][3]);
      cur = nxt;
    }

    // --- the full-row max: the quad's keys, then the warps ---
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    if (c == 0) {
      red_m[warp * LQT + g] = m0;
      if (HALF > 1) red_m[warp * LQT + g + 8] = m1;
    }
    hop::named_sync(1, WARPS * 32);
    m0 = m1 = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      m0 = fmaxf(m0, red_m[w * LQT + g]);
      if (HALF > 1) m1 = fmaxf(m1, red_m[w * LQT + g + 8]);
    }
    fetch_q(item + gridDim.x);   // the next item's q, in flight meanwhile

    // --- V pass: p from this lane's scores, O += bf16(P) V by stage ---
    struct VRaw {
      uint2 v[4];
      float s[4];
    };
    auto load_v = [&]() {
      hop::mbar_wait(&full[slot], phase);
      const unsigned char* vd = ring + slot * STAGE + warp * STEP * D + 8 * g;
      const float* sc = reinterpret_cast<const float*>(ring + slot * STAGE +
                                                       DATA) +
                        warp * STEP * 4 + (h & 3);
      const int rows[4] = {vr0, vr1, 8 + vr0, 8 + vr1};
      VRaw r;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r.v[i] = *reinterpret_cast<const uint2*>(vd + rows[i] * D);
        r.s[i] = sc[rows[i] * 4];
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[slot]);
      next_stage();
      return r;
    };
    float o[8][4] = {};
    float l0 = 0.f, l1 = 0.f;
    VRaw vcur = load_v();
    for (int st = 0; st < a.nst; ++st) {
      VRaw vnxt = vcur;
      if (st + 1 < a.nst) vnxt = load_v();
      const float* so = s_own + st * WARPS * 128;
      const float4 sa = *reinterpret_cast<const float4*>(so);
      float4 pa = make_float4(__expf(sa.x - m0), __expf(sa.y - m0),
                              __expf(sa.z - m0), __expf(sa.w - m0));
      l0 += (pa.x + pa.y) + (pa.z + pa.w);
      uint32_t pf[4] = {pack_bf16(pa.x, pa.y), 0u, pack_bf16(pa.z, pa.w), 0u};
      if (HALF > 1) {
        const float4 sb = *reinterpret_cast<const float4*>(so + s_half);
        const float4 pb = make_float4(__expf(sb.x - m1), __expf(sb.y - m1),
                                      __expf(sb.z - m1), __expf(sb.w - m1));
        l1 += (pb.x + pb.y) + (pb.z + pb.w);
        pf[1] = pack_bf16(pb.x, pb.y);
        pf[3] = pack_bf16(pb.z, pb.w);
      }
      uint32_t u[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        u[i][0] = vcur.v[i].x ^ 0x80808080u;
        u[i][1] = vcur.v[i].y ^ 0x80808080u;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int w = t >> 2, by = t & 3;
        const uint32_t b0 = pack_bf16(byte_value(u[0][w], by) * vcur.s[0],
                                      byte_value(u[1][w], by) * vcur.s[1]);
        const uint32_t b1 = pack_bf16(byte_value(u[2][w], by) * vcur.s[2],
                                      byte_value(u[3][w], by) * vcur.s[3]);
        mma_bf16(o[t], pf, b0, b1);
      }
      vcur = vnxt;
    }

    // --- the warps' partial O and l meet in fixed order; out = o / l ---
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (c == 0) {
      red_l[warp * LQT + g] = l0;
      if (HALF > 1) red_l[warp * LQT + g + 8] = l1;
    }
    float* ro = red_o + warp * LQT * OSTRIDE;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      ro[g * OSTRIDE + 16 * c + t] = o[t][0];
      ro[g * OSTRIDE + 16 * c + 8 + t] = o[t][1];
      if (HALF > 1) {
        ro[(g + 8) * OSTRIDE + 16 * c + t] = o[t][2];
        ro[(g + 8) * OSTRIDE + 16 * c + 8 + t] = o[t][3];
      }
    }
    hop::named_sync(1, WARPS * 32);
    bf16* ob = a.o + (long long)b * a.Lq * a.H + h * D;
    for (int i = threadIdx.x; i < a.Lq * D; i += WARPS * 32) {
      const int r = i >> 6, d = i & (D - 1);
      float sum = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sum += red_o[(w * LQT + r) * OSTRIDE + d];
        l += red_l[w * LQT + r];
      }
      ob[(long long)r * a.H + d] = __float2bfloat16_rn(sum / l);
    }
  }
}

template <int LQT>
cudaError_t launch(const CUtensorMap (&m)[4], const Args& a, int ctas,
                   int smem, cudaStream_t stream) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = hop::smem_opt_in<LQT>((const void*)int8_cross_stream_kernel<LQT>, dev);
  if (e != cudaSuccess) return e;
  int8_cross_stream_kernel<LQT><<<ctas, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

}  // namespace k7

// ---------------------------------------------------------------------------
// the large plan: the first body, a block per (h, b)
// ---------------------------------------------------------------------------
namespace large {

constexpr int D = 64;                   // head dim (BERT-base: 768 / 12)
constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;
constexpr int QK_LANES = D / 16;        // lanes per key row, score pass
constexpr int QK_ROWS = NT / QK_LANES;  // key rows per sweep (64)
constexpr int PV_LANES = D / 8;         // lanes per key row, PV pass
constexpr int PV_ROWS = NT / PV_LANES;  // key rows per sweep (32)
constexpr int UNROLL = 4;               // key rows in flight per lane
constexpr int MAX_LQ = 16;

struct Int8Args {
  const bf16* q;
  const int8_t* k8;
  const float* ks;
  const int8_t* v8;
  const float* vs;
  bf16* o;
  int Lq, Lk, H, nh;
  float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// four int8 values in one word -> bf16(x * s) as floats. The byte x + 128 is
// placed in the low mantissa byte of 2^23, so the float is 2^23 + 128 + x and
// one subtraction recovers x exactly.
__device__ __forceinline__ void dequant4(uint32_t w, float s, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const float x0 =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
    const float x1 =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + i)) - 8388736.f;
    const float2 r = unpack_bf16(pack_bf16(x0 * s, x1 * s));
    out[i] = r.x;
    out[i + 1] = r.y;
  }
}

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// shared memory: q (Lq x D), the warps' PV sums (NW x Lq x D), the row sums
// (Lq, padded to 4) and the scores (Lq x Lk), all fp32
__host__ __device__ inline size_t smem_floats(int Lq, int Lk) {
  return (size_t)Lq * D * (1 + NW) + pad4(Lq) + (size_t)Lq * Lk;
}

template <int LQT>
__global__ void __launch_bounds__(NT) int8_cross_kernel(const Int8Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Lq = a.Lq, Lk = a.Lk;
  float* Qs = smem;
  float* part = Qs + Lq * D;
  float* rowl = part + NW * Lq * D;
  float* S = rowl + pad4(Lq);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)b * Lk;   // first K/V row of this b

  const bf16* qb = a.q + (long long)b * Lq * a.H + h * D;
  for (int i = tid; i < Lq * D; i += NT)
    Qs[i] = __bfloat162float(qb[(i / D) * a.H + i % D]);
  __syncthreads();

  // 1. scores
  {
    const int c = tid % QK_LANES, r0 = tid / QK_LANES;
    const int8_t* kb = a.k8 + row0 * a.H + h * D + c * 16;
    const float* ksb = a.ks + row0 * a.nh + h;
    for (int base = 0; base < Lk; base += QK_ROWS * UNROLL) {
      uint4 raw[UNROLL];
      float sc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * QK_ROWS + r0;
        if (j < Lk) {
          raw[u] = __ldg(reinterpret_cast<const uint4*>(kb + (long long)j * a.H));
          sc[u] = __ldg(ksb + (long long)j * a.nh);
        } else {
          raw[u] = make_uint4(0u, 0u, 0u, 0u);
          sc[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * QK_ROWS + r0;
        float kf[16];
        dequant4(raw[u].x, sc[u], kf);
        dequant4(raw[u].y, sc[u], kf + 4);
        dequant4(raw[u].z, sc[u], kf + 8);
        dequant4(raw[u].w, sc[u], kf + 12);
#pragma unroll
        for (int r = 0; r < LQT; ++r) {
          if (r < Lq) {   // uniform over the block
            const float4* qr =
                reinterpret_cast<const float4*>(Qs + r * D + c * 16);
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 qv = qr[e];
              acc = fmaf(qv.x, kf[4 * e], acc);
              acc = fmaf(qv.y, kf[4 * e + 1], acc);
              acc = fmaf(qv.z, kf[4 * e + 2], acc);
              acc = fmaf(qv.w, kf[4 * e + 3], acc);
            }
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            if (c == (r & (QK_LANES - 1)) && j < Lk)
              S[(long long)r * Lk + j] = acc * a.scale;
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. full-row softmax, one warp per query row
  for (int r = warp; r < Lq; r += NW) {
    float* Sr = S + (long long)r * Lk;
    float m = NEG_BIG;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, Sr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float p = expf(Sr[j] - m);
      l += p;
      Sr[j] = bf16_round(p);
    }
    l = warp_sum(l);
    if (lane == 0) rowl[r] = l;
  }
  __syncthreads();

  // 3. PV
  {
    const int c = tid % PV_LANES, r0 = tid / PV_LANES;
    const int8_t* vb = a.v8 + row0 * a.H + h * D + c * 8;
    const float* vsb = a.vs + row0 * a.nh + h;
    float acc[LQT][8];
#pragma unroll
    for (int r = 0; r < LQT; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
    for (int base = 0; base < Lk; base += PV_ROWS * UNROLL) {
      uint2 raw[UNROLL];
      float sc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * PV_ROWS + r0;
        if (j < Lk) {
          raw[u] = __ldg(reinterpret_cast<const uint2*>(vb + (long long)j * a.H));
          sc[u] = __ldg(vsb + (long long)j * a.nh);
        } else {
          raw[u] = make_uint2(0u, 0u);
          sc[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * PV_ROWS + r0;
        if (j < Lk) {
          float vf[8];
          dequant4(raw[u].x, sc[u], vf);
          dequant4(raw[u].y, sc[u], vf + 4);
#pragma unroll
          for (int r = 0; r < LQT; ++r) {
            if (r < Lq) {
              const float p = S[(long long)r * Lk + j];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
            }
          }
        }
      }
    }
    // the warp's 4 key rows (lanes 8 apart) meet by shuffles
#pragma unroll
    for (int r = 0; r < LQT; ++r) {
      if (r < Lq) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 8);
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
        }
        if (lane < PV_LANES) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part[(warp * Lq + r) * D + c * 8 + e] = acc[r][e];
        }
      }
    }
  }
  __syncthreads();

  bf16* ob = a.o + (long long)b * Lq * a.H + h * D;
  for (int i = tid; i < Lq * D; i += NT) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) o += part[(w * Lq + r) * D + d];
    ob[r * a.H + d] = __float2bfloat16_rn(o / rowl[r]);
  }
}

template <int LQT>
cudaError_t launch(const Int8Args& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_cross_kernel<LQT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int8_cross_kernel<LQT><<<dim3(a.nh, B), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace large
}  // namespace

// The fast plan's four tensor maps, in the order K, K's scales, V, V's
// scales, written to `maps` (4 x 128 bytes): k8/v8 (B, Lk, H) int8, ks/vs
// (B, Lk, nh) fp32, contiguous and 16-byte aligned, H = nh * 64, nh a
// multiple of 4.
extern "C" int mico_k7_maps(const void* k8, const void* ks, const void* v8,
                            const void* vs, int B, int Lk, int H, int nh,
                            void* maps) {
  using namespace k7;
  if (H != nh * D || nh % 4 || Lk < 1 || B < 1) return cudaErrorInvalidValue;
  const cuuint64_t ddims[3] = {(cuuint64_t)H, (cuuint64_t)Lk, (cuuint64_t)B};
  const cuuint64_t dstrides[2] = {(cuuint64_t)H, (cuuint64_t)Lk * H};
  const cuuint32_t dbox[3] = {D, ROWS, 1};
  const cuuint64_t sdims[3] = {(cuuint64_t)nh, (cuuint64_t)Lk, (cuuint64_t)B};
  const cuuint64_t sstrides[2] = {(cuuint64_t)nh * 4, (cuuint64_t)Lk * nh * 4};
  const cuuint32_t sbox[3] = {4, ROWS, 1};
  const void* base[4] = {k8, ks, v8, vs};
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i) {
    const bool scales = i & 1;
    cudaError_t e = hop::make_map(
        &m[i], scales ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
        CU_TENSOR_MAP_SWIZZLE_NONE, base[i], 3, scales ? sdims : ddims,
        scales ? sstrides : dstrides, scales ? sbox : dbox);
    if (e != cudaSuccess) return e;
  }
  memcpy(maps, m, sizeof m);
  return cudaSuccess;
}

// The fast plan: q/o (B, Lq, H) bf16 contiguous, `maps` from mico_k7_maps
// for this call's K/V and scales, `ctas` persistent CTAs (at most B * nh),
// `stages` ring buffers, `lqt` 8 for Lq <= 8 and 16 above; the launch's
// shared memory must fit (k7_plan chooses all of it).
extern "C" int mico_int8_cross_attn(const void* q, void* o, const void* maps,
                                    int B, int Lq, int Lk, int H, int nh,
                                    float scale, int ctas, int stages, int lqt,
                                    void* stream) {
  using namespace k7;
  const int nst = (Lk + ROWS - 1) / ROWS;
  if (H != nh * D || nh % 4 || Lq < 1 || Lq > 16 || Lk < 1 || B < 1 ||
      stages < MIN_STAGES || stages > MAX_STAGES ||
      lqt != (Lq <= 8 ? 8 : 16) || ctas < 1 || ctas > B * nh)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(lqt, nst, stages);
  if (smem > hop::MAX_SMEM) return cudaErrorInvalidValue;
  CUtensorMap m[4];
  memcpy(m, maps, sizeof m);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.o = static_cast<bf16*>(o);
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  a.nh = nh;
  a.items = B * nh;
  a.nst = nst;
  a.stages = stages;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lqt == 8 ? launch<8>(m, a, ctas, smem, s)
                  : launch<16>(m, a, ctas, smem, s);
}

// The large plan: q/o (B, Lq, H) bf16, k8/v8 (B, Lk, H) int8, ks/vs (B, Lk,
// nh) fp32, all contiguous, K/V rows 16-byte aligned; H = nh * 64, Lq <= 16,
// and the scores must fit shared memory (the wrapper checks all of it).
extern "C" int mico_int8_cross_attn_large(const void* q, const void* k8,
                                          const void* ks, const void* v8,
                                          const void* vs, void* o, int B,
                                          int Lq, int Lk, int H, int nh,
                                          float scale, void* stream) {
  using namespace large;
  if (H != nh * D || Lq < 1 || Lq > MAX_LQ || Lk < 1 || B < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Lq, Lk);
  if (smem > 232448) return cudaErrorInvalidValue;
  Int8Args a;
  a.q = static_cast<const bf16*>(q);
  a.k8 = static_cast<const int8_t*>(k8);
  a.ks = static_cast<const float*>(ks);
  a.v8 = static_cast<const int8_t*>(v8);
  a.vs = static_cast<const float*>(vs);
  a.o = static_cast<bf16*>(o);
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  a.nh = nh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 2) return launch<2>(a, B, smem, s);
  if (Lq <= 4) return launch<4>(a, B, smem, s);
  if (Lq <= 8) return launch<8>(a, B, smem, s);
  return launch<16>(a, B, smem, s);
}
