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
// every product accumulated in fp32 and rounded once: dq is one fp32 sum
// over all keys (per-split partials summed in a fixed order), dk and dv one
// over all queries. The bias gets no gradient here: on this route it is a
// constant mask (`KV_TILED_BIAS_IS_MASK`, :634).
//
// What bounds it on the H100: bytes. At the long-context step's shape (q, g
// (2, 12, 128, 64), k, v (2, 12, 8224, 64) bf16) it reads k and v (51 MB)
// and writes dk and dv (51 MB) for 5 x 2 x 2 x 12 x 128 x 8224 x 64 = 16.2
// GFLOP: 0.030 ms at 3.35 TB/s against 0.016 ms at 989 TFLOP/s.
//
// Design: one pass over the keys, split across blocks, on wgmma + TMA
// (hopper.cuh). The TPU kernel runs two pallas_calls; because delta comes
// in, a block needs only its keys and the queries to finish dK and dV, so
// the five products run in one pass (FlashAttention's split):
//  - grid (key splits, H, B), one block an SM (`k6b_plan` in
//    ops/flash_attention.py: the splits that fill the card in one wave,
//    two 64-key chunks a split at least); a split is a run of whole
//    64-key chunks, only the last may end inside one (at Lk);
//  - a block keeps a group of up to 128 queries resident: Q and G by TMA
//    (one 4-D tensor map an operand over (D, H, L, B) with the caller's
//    strides, so BERT's strided views need no copy; zeros past Lq and D),
//    lse and delta in shared memory. Past 128 queries the groups follow one
//    another in the block, and dK and dV of each chunk are summed over the
//    groups in an fp32 scratch the block owns (no atomics);
//  - a producer thread streams the split's K and V chunks through a ring of
//    TMA stages (4 at D <= 64, 2 above); rows past Lk are TMA zero fill, so
//    no 0 * NaN;
//  - two consumer warpgroups, one 64-query tile each, take every chunk
//    together. Each computes S^T = K Q_t^T and dP^T = V G_t^T (SS wgmma,
//    keys as the 64 rows), makes P^T and dS^T in registers and stages
//    them in bf16 (128-byte swizzle) in a tile of 64 keys x 128 queries
//    (three buffers up to D 64, two above). Then warpgroup 0 runs dV =
//    P^T G and warpgroup 1 dK = dS^T Q over the group's 128 queries (A
//    K-major from the staged tile, G and Q MN-major through the
//    descriptor's transpose bit), and each adds dQ_t += dS_t K, its tile of
//    dS read from the staged dS^T as an M-major A operand. A warpgroup
//    holding S and dP for all 128 queries and dQ for 128 rows would need
//    256 fp32 registers a thread; split this way it holds 128 (D <= 64) or
//    192 (D <= 128);
//  - the products of chunk i run while the CUDA cores make P^T and dS^T of
//    chunk i + 1, and chunk i + 1's S^T and dP^T are issued before chunk
//    i's products: the elementwise work (one ex2 a score) and the tensor
//    cores overlap, and the exponent is one FMA of the fp32 score with
//    scale log2e and (bias - lse) log2e;
//  - dK and dV of a chunk are complete after its pass: written once in
//    bf16 through a staging tile and TMA stores (clipped at Lk and D; the
//    caller's strides, one more tensor map each). dQ stays in registers for
//    the split, goes out as fp32 partials (B, H, nsplit, Lq, D), and a
//    second small launch (`combine_kernel`) sums them in split order and
//    rounds once: deterministic, as fp32 atomics would not be;
//  - the bias (B|1, H|1, Lq|1, Lk): broadcast over the queries (a padding
//    mask) two loads a thread a chunk, issued a chunk ahead; otherwise
//    read from global memory at the transposed score tile's (query, key)
//    pairs.
// At the long-context step's shape it takes 0.059 ms of device time on an
// H100 80GB HBM3 at 700 W, against 0.51 for the two-launch mma.sync design
// it replaces and 0.087 for cuDNN's attention backward
// (scripts/torch_flash_bench.py --kernel K6b; PERF.md); a 64-key chunk's
// serial chain of barriers and waits, not the tensor cores or the loads,
// bounds it (scripts/torch_k6b_breakdown.py).
// D: any multiple of 8 up to 128, in 64-column chunks; S^T and dP^T run 4
// k16 steps over D up to 64, 6 up to 96 (the columns past D are zeros), 8
// past it. Any Lq and Lk.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace mico {
namespace k6b {

constexpr int THREADS = 384;       // 2 consumer warpgroups + a producer one
constexpr int ROWS = 64;           // keys a chunk, queries a tile
constexpr int GROUP = 2 * ROWS;    // resident queries: a tile a consumer
constexpr int CHUNK = 64 * 128;    // a 64-row tile of one 64-column chunk
constexpr int PDS = 4 * CHUNK;     // P^T and dS^T of a chunk over a group

// the K/V ring's stages (4 up to D 64, 2 above) and the buffers of staged
// P^T and dS^T (3 up to D 64; 2 above, with one more barrier a chunk)
template <int NT>
constexpr int STAGES = NT == 1 ? 4 : 2;
template <int NT>
constexpr int NB = NT == 1 ? 3 : 2;

// shared memory of a launch: Q and G of a group (two tiles each), the K/V
// ring, the P^T and dS^T buffers, each warpgroup's dV or dK tile for the
// TMA stores, lse and delta, the mbarriers, and the swizzle atoms'
// alignment
template <int NT>
constexpr int smem_bytes() {
  return 4 * NT * CHUNK + STAGES<NT> * 2 * NT * CHUNK + NB<NT> * PDS +
         2 * NT * CHUNK + 2 * GROUP * 4 + (2 * STAGES<NT> + 2) * 8 + 1024;
}
static_assert(smem_bytes<1>() <= hop::MAX_SMEM &&
                  smem_bytes<2>() <= hop::MAX_SMEM,
              "K6b's shared memory outgrows the SM");

struct Args {
  const float* lse;     // (B, H, Lq)
  const float* delta;   // (B, H, Lq)
  const float* bias;    // fp32 at strides bs of (b, h, q, k), 0 if broadcast
  float* dq_part;       // (B, H, nsplit, Lq, D) fp32
  float* dkv_acc;       // (2, B, H, Lk, D) fp32 (dk, dv) when Lq > GROUP
  long long bs[4];
  int H, Lq, Lk, D, per, nsplit, has_bias;
  int swap[6];          // q, k, v, g, dk, dv maps: 1 when (D, L, H, B)
  float scale;
};

// d (64 x 64) = A . B^T over D: 64-row tiles, K-major in 64-column chunks
// CHUNK bytes apart, KS k16 steps (issued only)
template <int KS>
__device__ __forceinline__ void ss_scores(float (&d)[32],
                                          const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
    hop::wgmma_ss_n64<0>(d, hop::desc_sw128(a + off, 16, 1024),
                         hop::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// o (64 x 64 NT) = A . B over the group's 128 queries: A the staged
// (64 keys x 128 queries), K-major in two 64-query chunks; B the group's
// two 64-row tiles (queries x D) of NT chunks, MN-major (issued only)
template <int NT>
__device__ __forceinline__ void ss_keys(float (&o)[NT * 32],
                                        const unsigned char* a,
                                        const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < GROUP / 16; ++kk) {
    const uint64_t da =
        hop::desc_sw128(a + (kk >> 2) * CHUNK + (kk & 3) * 32, 16, 1024);
    const uint64_t db = hop::desc_sw128(
        b + (kk >> 2) * NT * CHUNK + (kk & 3) * 2048, CHUNK, 1024);
    if constexpr (NT == 2)
      hop::wgmma_ss_n128<1>(o, da, db, kk > 0);
    else
      hop::wgmma_ss_n64<1>(o, da, db, kk > 0);
  }
}

// dq (64 x 64 NT) += dS . K over the chunk's 64 keys: A a 64-query chunk
// of the staged dS^T (keys x queries: M-major), B the chunk's K rows
// (keys x D: MN-major; issued only)
template <int NT>
__device__ __forceinline__ void ss_dq(float (&o)[NT * 32],
                                      const unsigned char* a,
                                      const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    const uint64_t da = hop::desc_sw128(a + kk * 2048, CHUNK, 1024);
    const uint64_t db = hop::desc_sw128(b + kk * 2048, CHUNK, 1024);
    if constexpr (NT == 2)
      hop::wgmma_ss_n128<1, 1>(o, da, db, 1);
    else
      hop::wgmma_ss_n64<1, 1>(o, da, db, 1);
  }
}

// the (D, H, L, B) or, swapped, (D, L, H, B) coordinates of the 64 x 64
// box at column chunk c, head h, row `row`, batch row b
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int c, int h,
                                          int row, int b, int swap) {
  if (swap)
    hop::tma_load_4d(dst, map, bar, 64 * c, row, h, b);
  else
    hop::tma_load_4d(dst, map, bar, 64 * c, h, row, b);
}

__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const unsigned char* src, int c,
                                           int h, int row, int b, int swap) {
  if (swap)
    hop::tma_store_4d(map, src, 64 * c, row, h, b);
  else
    hop::tma_store_4d(map, src, 64 * c, h, row, b);
}

// P^T and dS^T of a warpgroup's tile from its S^T and dP^T accumulators
// (keys rl, rl + 8 of the chunk x queries 8j + q2, + 1 of the tile), staged
// in bf16 (128-byte swizzle): P^T at pc, dS^T at dc. ls2 and dl: the
// tile's lse times log2e and delta; qk2 = scale log2e; rb0, rb1: the two
// keys' bias times log2e (a bias broadcast over the queries, else 0):
//   p = exp2(s qk2 + rb - lse log2e),  ds = p (dp - delta) scale.
// GENERAL masks keys past Lk (kin0, kin1) and queries from qlim on to 0,
// and adds a bias that varies over the queries (full_bias) from kb0, kb1
// (its rows at the tile's first query, bs2 apart).
template <bool GENERAL>
__device__ __forceinline__ void probs(float (&st)[32], float (&dt)[32],
                                      unsigned char* pc, unsigned char* dc,
                                      const float* ls2, const float* dl,
                                      float qk2, float scale, float rb0,
                                      float rb1, int rl, int q2, bool kin0,
                                      bool kin1, int qlim, bool full_bias,
                                      const float* kb0, const float* kb1,
                                      long long bs2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ql = 8 * j + q2;
    const float2 l = *reinterpret_cast<const float2*>(ls2 + ql);
    const float2 d = *reinterpret_cast<const float2*>(dl + ql);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      const float lse2 = (e & 1) ? l.y : l.x, dlt = (e & 1) ? d.y : d.x;
      float t = fmaf(st[x], qk2, ((e & 2) ? rb1 : rb0) - lse2);
      if constexpr (GENERAL) {
        const bool ok = ((e & 2) ? kin1 : kin0) && ql + (e & 1) < qlim;
        if (full_bias && ok)
          t = fmaf(((e & 2) ? kb1 : kb0)[(ql + (e & 1)) * bs2], LOG2E, t);
        const float p = ok ? fast_exp2(t) : 0.f;
        st[x] = p;
        dt[x] = ok ? p * (dt[x] - dlt) * scale : 0.f;
      } else {
        const float p = fast_exp2(t);
        st[x] = p;
        dt[x] = p * (dt[x] - dlt) * scale;
      }
    }
    const int o0 = hop::sw128_offset(rl, ql, CHUNK);
    const int o1 = hop::sw128_offset(rl + 8, ql, CHUNK);
    *reinterpret_cast<uint32_t*>(pc + o0) = pack_bf16(st[4 * j], st[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(pc + o1) =
        pack_bf16(st[4 * j + 2], st[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(dc + o0) = pack_bf16(dt[4 * j], dt[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dc + o1) =
        pack_bf16(dt[4 * j + 2], dt[4 * j + 3]);
  }
}

template <int NT, int KS>
__global__ void __launch_bounds__(THREADS, 1)
k6b_kernel(const __grid_constant__ CUtensorMap tma_q,
           const __grid_constant__ CUtensorMap tma_k,
           const __grid_constant__ CUtensorMap tma_v,
           const __grid_constant__ CUtensorMap tma_g,
           const __grid_constant__ CUtensorMap tma_dk,
           const __grid_constant__ CUtensorMap tma_dv,
           const __grid_constant__ Args a) {
  constexpr int TILE = NT * CHUNK;   // a 64-row operand tile
  constexpr int ST = STAGES<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* qs = smem;                   // [tile] Q of the group
  unsigned char* gs = qs + 2 * TILE;          // [tile] G
  unsigned char* ring = gs + 2 * TILE;        // [stage] K, V of a chunk
  unsigned char* pds = ring + ST * 2 * TILE;  // [buffer] P^T, dS^T
  unsigned char* outs = pds + NB<NT> * PDS;   // [warpgroup] dV, dK tile
  float* lse_s = reinterpret_cast<float*>(outs + 2 * TILE);
  float* dl_s = lse_s + GROUP;
  uint64_t* full = reinterpret_cast<uint64_t*>(dl_s + GROUP);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + 1;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = split * a.per;
  const int nch = min(a.per, (a.Lk + ROWS - 1) / ROWS - c0);
  const int ngroups = (a.Lq + GROUP - 1) / GROUP;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 2);
    }
    hop::mbar_init(qfull, 1);
    hop::mbar_init(qempty, 2);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // producer warpgroup: one thread issues every load
    hop::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tma_q);
      hop::prefetch_map(&tma_k);
      hop::prefetch_map(&tma_v);
      hop::prefetch_map(&tma_g);
      int it = 0;
      for (int g = 0; g < ngroups; ++g) {
        // the group's Q and G once the last group's products are done; a
        // tile wholly past Lq is not loaded (the consumers zero it)
        if (g > 0) hop::mbar_wait(qempty, (g - 1) & 1);
        const int nt = g * GROUP + ROWS < a.Lq ? 2 : 1;
        hop::mbar_expect_tx(qfull, 2 * nt * TILE);
        for (int t = 0; t < nt; ++t)
          for (int c = 0; c < NT; ++c) {
            const int row = g * GROUP + t * ROWS;
            load_tile(qs + t * TILE + c * CHUNK, &tma_q, qfull, c, h, row, b,
                      a.swap[0]);
            load_tile(gs + t * TILE + c * CHUNK, &tma_g, qfull, c, h, row, b,
                      a.swap[3]);
          }
        for (int i = 0; i < nch; ++i, ++it) {
          const int st = it % ST, n = it / ST;
          if (n > 0) hop::mbar_wait(&empty[st], (n - 1) & 1);
          hop::mbar_expect_tx(&full[st], 2 * TILE);
          unsigned char* kv = ring + st * 2 * TILE;
          const int row = (c0 + i) * ROWS;
          for (int c = 0; c < NT; ++c) {
            load_tile(kv + c * CHUNK, &tma_k, &full[st], c, h, row, b,
                      a.swap[1]);
            load_tile(kv + TILE + c * CHUNK, &tma_v, &full[st], c, h, row, b,
                      a.swap[2]);
          }
        }
      }
    }
    return;
  }

  // the pool: 384 x 168 registers = 2 x 128 x 232 + 128 x 40
  hop::setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int rl = warp * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  const long long bh = (long long)b * a.H + h;
  // warpgroup 0 makes dV, 1 dK; past one query group each chunk's sum over
  // the groups so far waits in the fp32 scratch, (B, H, Lk, D) each
  const CUtensorMap* omap = wgi ? &tma_dk : &tma_dv;
  const int oswap = a.swap[wgi ? 4 : 5];
  unsigned char* ot = outs + wgi * TILE;
  float* wsum = a.dkv_acc == nullptr
                    ? nullptr
                    : a.dkv_acc + ((wgi ? 0 : (long long)gridDim.z * a.H) +
                                   bh) * a.Lk * a.D;
  const float* bias_bh = a.bias + b * a.bs[0] + h * a.bs[1];
  const bool row_bias = a.has_bias && a.bs[2] == 0;   // broadcast over q
  const bool full_bias = a.has_bias && !row_bias;
  const float qk2 = a.scale * LOG2E;
  const unsigned char* qw = qs + wgi * TILE;   // this warpgroup's query tile
  const unsigned char* gw = gs + wgi * TILE;
  float st[32], dt[32], acc[NT * 32], dq[NT * 32];
  int it = 0;

  for (int g = 0; g < ngroups; ++g) {
    const int q0 = g * GROUP;
    const int qlim = a.Lq - q0 - wgi * ROWS;   // this tile's queries < Lq
    // the group's lse log2e and delta (0 past Lq); a second tile wholly
    // past Lq is zeroed, so its products are finite (its p is masked to 0)
    hop::named_sync(1, 256);   // the last group's readers are done
    for (int i = threadIdx.x; i < GROUP; i += 256) {
      const int q = q0 + i;
      lse_s[i] = q < a.Lq ? a.lse[bh * a.Lq + q] * LOG2E : 0.f;
      dl_s[i] = q < a.Lq ? a.delta[bh * a.Lq + q] : 0.f;
    }
    if (q0 + ROWS >= a.Lq) {
      for (int i = threadIdx.x; i < TILE / 16; i += 256) {
        reinterpret_cast<uint4*>(qs + TILE)[i] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(gs + TILE)[i] = make_uint4(0, 0, 0, 0);
      }
      hop::fence_proxy_async();
    }
    hop::named_sync(1, 256);
    hop::mbar_wait(qfull, g & 1);
#pragma unroll
    for (int i = 0; i < NT * 32; ++i) dq[i] = 0.f;

    // chunk i's S^T and dP^T (keys x this tile's queries)
    auto issue_scores = [&](int i) {
      const int stg = (it + i) % ST;
      hop::mbar_wait(&full[stg], ((it + i) / ST) & 1);
      const unsigned char* kv = ring + stg * 2 * TILE;
      hop::fence_regs(st);
      hop::fence_regs(dt);
      hop::wgmma_fence();
      ss_scores<KS>(st, kv, qw);
      ss_scores<KS>(dt, kv + TILE, gw);
      hop::wgmma_commit();
    };
    // chunk i's dV or dK from acc (its products retired): added to the
    // scratch's sum over the earlier groups; at the last group written in
    // bf16 through this warpgroup's tile and TMA stores (clipped at Lk and
    // D), which run on while the next chunks are computed
    auto store_keys = [&](int i) {
      const int key0 = (c0 + i) * ROWS;
      if (wsum != nullptr) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int key = key0 + rl + 8 * e2;
          if (key < a.Lk) {
#pragma unroll
            for (int j = 0; j < NT * 8; ++j) {
              const int col = 8 * j + q2;
              if (col < a.D) {
                float2* w = reinterpret_cast<float2*>(
                    wsum + (long long)key * a.D + col);
                if (g > 0) {
                  const float2 prev = *w;
                  acc[4 * j + 2 * e2] += prev.x;
                  acc[4 * j + 2 * e2 + 1] += prev.y;
                }
                if (g + 1 < ngroups)
                  *w = make_float2(acc[4 * j + 2 * e2],
                                   acc[4 * j + 2 * e2 + 1]);
              }
            }
          }
        }
        if (g + 1 < ngroups) return;
      }
      if (tid == 0) hop::bulk_wait_read<0>();   // the last tile's stores
      hop::named_sync(3 + wgi, 128);
#pragma unroll
      for (int j = 0; j < NT * 8; ++j) {
        const int col = 8 * j + q2;
        *reinterpret_cast<uint32_t*>(ot + hop::sw128_offset(rl, col, CHUNK)) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(
            ot + hop::sw128_offset(rl + 8, col, CHUNK)) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hop::fence_proxy_async();
      hop::named_sync(3 + wgi, 128);
      if (tid == 0) {
        for (int c = 0; c < NT; ++c)
          store_tile(omap, ot + c * CHUNK, c, h, key0, b, oswap);
        hop::bulk_commit();
      }
    };

    // this thread's two keys' bias in chunk i where it is broadcast over
    // the queries (0 otherwise), loaded a chunk ahead of its use
    auto key_bias = [&](int i, float& r0, float& r1) {
      const int k0 = (c0 + i) * ROWS + rl;
      r0 = row_bias ? bias_bh[(long long)min(k0, a.Lk - 1) * a.bs[3]] : 0.f;
      r1 = row_bias ? bias_bh[(long long)min(k0 + 8, a.Lk - 1) * a.bs[3]]
                    : 0.f;
    };
    float rb0, rb1;
    // chunk i: P^T and dS^T (while chunk i - 1's products run), then chunk
    // i + 1's scores (NEXT), chunk i - 1's stores (not FIRST), chunk i's
    // products. Compile-time FIRST and NEXT keep every wgmma group and wait
    // out of branches: ptxas serialises the wgmmas of a kernel where it
    // cannot tell which groups a wait retires (C7514)
    auto step = [&](int i, auto first, auto next) {
      constexpr bool FIRST = decltype(first)::value;
      constexpr bool NEXT = decltype(next)::value;
      const int stg = (it + i) % ST;
      const unsigned char* kv = ring + stg * 2 * TILE;
      unsigned char* pb = pds + (i % NB<NT>) * PDS;
      const int key0 = (c0 + i) * ROWS;
      const int k0 = key0 + rl, k1 = k0 + 8;   // this thread's keys
      const bool kin0 = k0 < a.Lk, kin1 = k1 < a.Lk;
      const float* kb0 = bias_bh + (long long)min(k0, a.Lk - 1) * a.bs[3] +
                         (long long)(q0 + wgi * ROWS) * a.bs[2];
      const float* kb1 = kb0 + (long long)(min(k1, a.Lk - 1) -
                                           min(k0, a.Lk - 1)) * a.bs[3];
      float next0 = 0.f, next1 = 0.f;
      if constexpr (NEXT) key_bias(i + 1, next0, next1);
      if (full_bias || key0 + ROWS > a.Lk || qlim < ROWS)
        probs<true>(st, dt, pb + wgi * CHUNK, pb + (2 + wgi) * CHUNK,
                    lse_s + wgi * ROWS, dl_s + wgi * ROWS, qk2, a.scale,
                    rb0 * LOG2E, rb1 * LOG2E, rl, q2, kin0, kin1, qlim,
                    full_bias, kb0, kb1, a.bs[2]);
      else
        probs<false>(st, dt, pb + wgi * CHUNK, pb + (2 + wgi) * CHUNK,
                     lse_s + wgi * ROWS, dl_s + wgi * ROWS, qk2, a.scale,
                     rb0 * LOG2E, rb1 * LOG2E, rl, q2, true, true, ROWS,
                     false, kb0, kb1, 0);
      rb0 = next0;
      rb1 = next1;
      hop::fence_proxy_async();
      hop::named_sync(2, 256);   // both tiles of chunk i staged
      if constexpr (!FIRST) {
        hop::wgmma_wait<0>();    // chunk i - 1's products
        hop::fence_regs(acc);
        hop::fence_regs(dq);
        if (tid == 0) hop::mbar_arrive(&empty[(it + i - 1) % ST]);
        // two buffers: both warpgroups' products of chunk i - 1 have read
        // the buffer that chunk i + 1 fills
        if constexpr (NB<NT> == 2) hop::named_sync(5, 256);
      }
      if constexpr (NEXT) issue_scores(i + 1);
      if constexpr (!FIRST) store_keys(i - 1);
      // dV = P^T G (warpgroup 0) or dK = dS^T Q (1) over the group, and
      // this tile's dQ += dS K
      hop::fence_regs(acc);
      hop::fence_regs(dq);
      hop::wgmma_fence();
      ss_keys<NT>(acc, pb + wgi * 2 * CHUNK, wgi ? qs : gs);
      ss_dq<NT>(dq, pb + (2 + wgi) * CHUNK, kv);
      hop::wgmma_commit();
      if constexpr (NEXT) {
        hop::wgmma_wait<1>();    // chunk i + 1's scores
        hop::fence_regs(st);
        hop::fence_regs(dt);
      }
    };
    using yes = std::true_type;
    using no = std::false_type;
    key_bias(0, rb0, rb1);
    issue_scores(0);
    hop::wgmma_wait<0>();
    hop::fence_regs(st);
    hop::fence_regs(dt);
    if (nch == 1) {
      step(0, yes{}, no{});
    } else {
      step(0, yes{}, yes{});
      for (int i = 1; i + 1 < nch; ++i) step(i, no{}, yes{});
      step(nch - 1, no{}, no{});
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::fence_regs(dq);
    if (tid == 0) hop::mbar_arrive(&empty[(it + nch - 1) % ST]);
    store_keys(nch - 1);
    it += nch;
    // this tile's dQ over the split, fp32
    float* dqp = a.dq_part + (bh * a.nsplit + split) * a.Lq * (long long)a.D;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int q = q0 + wgi * ROWS + rl + 8 * e2;
      if (q < a.Lq) {
#pragma unroll
        for (int j = 0; j < NT * 8; ++j) {
          const int col = 8 * j + q2;
          if (col < a.D)
            *reinterpret_cast<float2*>(dqp + (long long)q * a.D + col) =
                make_float2(dq[4 * j + 2 * e2], dq[4 * j + 2 * e2 + 1]);
        }
      }
    }
    if (tid == 0) hop::mbar_arrive(qempty);
  }
  if (tid == 0) hop::bulk_wait<0>();   // the last stores have landed
}

// dq = bf16(sum over the splits, in order, of the fp32 partials): a thread
// a pair of columns
__global__ void combine_kernel(const float* __restrict__ part, bf16* dq,
                               long long s0, long long s1, long long s2,
                               int H, int Lq, int D, int nsplit,
                               long long pairs) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int c = 2 * (int)(i % (D / 2));
  const long long r = i / (D / 2);   // (b, h, q)
  const int q = (int)(r % Lq);
  const long long bh = r / Lq;
  const float* p = part + (bh * nsplit * Lq + q) * D + c;
  float2 sum = make_float2(0.f, 0.f);
  for (int s = 0; s < nsplit; ++s) {
    const float2 v =
        *reinterpret_cast<const float2*>(p + (long long)s * Lq * D);
    sum.x += v.x;
    sum.y += v.y;
  }
  *reinterpret_cast<uint32_t*>(dq + (bh / H) * s0 + (bh % H) * s1 + q * s2 +
                               c) = pack_bf16(sum.x, sum.y);
}

// NT 64-column chunks of D, KS k16 steps over D: the pass, then the combine
template <int NT, int KS>
cudaError_t launch(const CUtensorMap (&m)[6], const Args& a, int B, bf16* dq,
                   const long long* dqs, cudaStream_t stream) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = hop::smem_opt_in<KS>((const void*)k6b_kernel<NT, KS>, dev);
  if (e != cudaSuccess) return e;
  k6b_kernel<NT, KS><<<dim3(a.nsplit, a.H, B), THREADS, smem_bytes<NT>(),
                       stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long pairs = (long long)B * a.H * a.Lq * (a.D / 2);
  combine_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      a.dq_part, dq, dqs[0], dqs[1], dqs[2], a.H, a.Lq, a.D, a.nsplit, pairs);
  return cudaGetLastError();
}

}  // namespace k6b
}  // namespace mico

// q, k, v, g (bf16, unit stride on D) in, dq, dk, dv (bf16) out;
// strides[0..20] the (b, h, l) element strides of q, k, v, g, dq, dk, dv;
// strides[21..24] the bias's (b, h, q, k) strides (fp32, 0 where
// broadcast); lse and delta (B, H, Lq) fp32 contiguous; dq_part (B, H,
// nsplit, Lq, D) fp32 scratch; dkv_acc (2, B, H, Lk, D) fp32 scratch when
// Lq > 128, else null. The keys split into nsplit runs of `per` 64-key
// chunks (the last may be shorter). D a multiple of 8 up to 128, strides and
// pointers 16-byte aligned (the wrapper checks).
extern "C" int mico_kv_tiled_attn_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, const void* bias, void* dq, void* dk,
    void* dv, void* dq_part, void* dkv_acc, int B, int H, int Lq, int Lk,
    int D, int nsplit, int per, const long long* strides, float scale,
    int has_bias, void* stream) {
  using mico::bf16;
  using namespace mico::k6b;
  if (D % 8 || D > 128 || D <= 0 || Lq <= 0 || Lk <= 0 || nsplit <= 0 ||
      per <= 0 || (long long)(nsplit - 1) * per * ROWS >= Lk ||
      (long long)nsplit * per * ROWS < Lk || (Lq > GROUP && !dkv_acc))
    return cudaErrorInvalidValue;
  Args a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.bias = static_cast<const float*>(bias);
  a.dq_part = static_cast<float*>(dq_part);
  a.dkv_acc = Lq > GROUP ? static_cast<float*>(dkv_acc) : nullptr;
  for (int i = 0; i < 4; ++i) a.bs[i] = strides[21 + i];
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.per = per;
  a.nsplit = nsplit;
  a.has_bias = has_bias;
  a.scale = scale;
  // one 4-D map an operand, boxes of 64 columns x 64 rows of one (b, h):
  // dims (D, H, L, B), or (D, L, H, B) where the head stride is the larger
  // (contiguous (B, H, L, D) tensors), so the strides rise
  const void* base[6] = {q, k, v, g, dk, dv};
  const int lens[6] = {Lq, Lk, Lk, Lq, Lk, Lk};
  const int which[6] = {0, 1, 2, 3, 5, 6};   // in `strides`, dq is 4
  CUtensorMap m[6];
  for (int i = 0; i < 6; ++i) {
    const long long* s = strides + 3 * which[i];
    a.swap[i] = s[1] > s[2];
    const cuuint64_t dims[4] = {
        (cuuint64_t)D, (cuuint64_t)(a.swap[i] ? lens[i] : H),
        (cuuint64_t)(a.swap[i] ? H : lens[i]), (cuuint64_t)B};
    const cuuint64_t bytes[3] = {
        (cuuint64_t)(a.swap[i] ? s[2] : s[1]) * 2,
        (cuuint64_t)(a.swap[i] ? s[1] : s[2]) * 2, (cuuint64_t)s[0] * 2};
    const cuuint32_t box[4] = {64, a.swap[i] ? (cuuint32_t)ROWS : 1u,
                               a.swap[i] ? 1u : (cuuint32_t)ROWS, 1};
    cudaError_t e = mico::hop::make_map(&m[i], base[i], 4, dims, bytes, box);
    if (e != cudaSuccess) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* dqp = static_cast<bf16*>(dq);
  const long long* dqs = strides + 12;
  if (D <= 64) return launch<1, 4>(m, a, B, dqp, dqs, s);
  if (D <= 96) return launch<2, 6>(m, a, B, dqp, dqs, s);
  return launch<2, 8>(m, a, B, dqp, dqs, s);
}
