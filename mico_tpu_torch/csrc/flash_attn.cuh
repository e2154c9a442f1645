// Streamed-KV online-softmax attention on (B, H, Lq, D), split over the keys:
// the device code of K2 (flash_attn.cu, the resident-KV `_flash`) and K6
// (kv_tiled_attn.cu, the KV-tiled `_flash_kv_tiled` /
// `_flash_kv_tiled_stats`). The two differ only in their rounding points,
// chosen by the template flag TILED:
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
// What bounds it on the H100: bytes. Each key row meets at most a few
// hundred query rows (30 at ITM, 10 in the recompute decode, 128 in the
// long-context step), far below the 295 op/byte where the tensor cores
// would take over. K6's (2, 12, 128, 64) over 8,224 keys reads 51 MB of K
// and V for 6.5 GFLOP: 0.0153 ms at 3.35 TB/s. At 3.35 TB/s and ~1 us of
// memory latency the card needs ~3 MB of copies in flight, ~25 KB an SM.
// Below a few hundred blocks' work (ITM, the decode) the time is latency:
// one warp takes ~2 us a 64-key chunk, so the chain of chunks a warp walks
// in series sets it.
//
// Design. The wrapper plans every launch (`flash_plan`); this code takes the
// plan as it comes.
// - Row warps: a block holds rw warps of 16 query rows, every query row of
//   a head up to 128 (rw = 1 at the decode's 10 rows, 2 at ITM's 30, 8 at
//   the long-context 128), so K and V are read once per head and split;
//   past 128 rows, q-tiles of 128.
// - Split-KV across blocks: the grid is (q-tiles x splits, H, B); split s
//   takes the contiguous chunks [s * split_chunks, (s + 1) * split_chunks)
//   of 64 keys; none is empty. With one split the block writes o (and the
//   LSE) itself. With more it writes its partial (the unnormalised fp32
//   accumulator, its running max m and row sum l) to an fp32 workspace the
//   wrapper allocates, and `combine_kernel` rescales the partials by
//   exp(m_i - m) and writes o = sum acc_i w_i / sum l_i w_i in bf16 and
//   lse = m + log(sum l_i w_i). A second kernel, and not a last-block
//   counter, which would need zeroed memory on every call (a memset launch
//   of its own) or a buffer shared by streams, nor a thread-block cluster
//   whose split 0 merges the others over distributed shared memory: that
//   was built and measured no faster at ITM (PERF.md §6).
// - Key warps inside a block: where the grid has under two blocks an SM,
//   kw warps walk the split's chunks for the same rows (warp kw takes
//   chunks kw, kw + KW, ...), each with its own online softmax, and merge
//   through shared memory at the end with the same rescale.
// - Copy ring: K, V and the bias chunk stream through R rounds of kw slots
//   with cp.async, R = 4 where it fits (fewer where kw slots are large or
//   the split has fewer rounds), the Q tile's copy issued with the first
//   rounds (round 0 even when R = 1); one __syncthreads a round. K6's plan
//   (kw = 1) has 4 chunks in the ring, three (48 KB at D = 64) in flight
//   while one is computed.
// - Bias: its chunk is copied with the K/V chunk into the ring (16-byte
//   copies when its rows are aligned, 4-byte ones otherwise), one row when
//   it broadcasts over the queries, else a row per query row of the block.
// - Output rows go through the caller's strides, so the (B, Lq, H, D)
//   layout BERT wants costs no copy. Head dims up to 128 in steps of 8 are
//   zero-padded to a multiple of 16 in shared memory.
// - cudaFuncSetAttribute (the 227 KB dynamic shared memory opt-in) runs
//   once per kernel instance and device, not per launch.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mico {
namespace flash {

constexpr int FK = 64;            // keys per streamed chunk
constexpr int BST = FK + 8;       // row stride (floats) of a staged bias chunk
constexpr int MAX_SMEM = 232448;  // dynamic shared memory of one block
constexpr int MAX_DEVICES = 64;

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;
  bf16* o;
  float* lse;     // TILED only: (B, H, Lq) fp32, or null
  float* ws;      // nsplit > 1: acc (nsplit, B*H*Lq, D), then m and l
                  // (nsplit, B*H*Lq)
  int B, H, Lq, Lk, D;
  int rw, kw;         // row warps (16 query rows each) and key warps a block
  int nsplit;         // splits of the keys
  int split_chunks;   // 64-key chunks a split (the last may have fewer)
  int rounds;         // rounds of kw chunks in the copy ring, 1 to 4
  int bias_rows;      // staged bias rows a chunk: 0 (none), 1 or the block's
  int bias_vec;       // bias rows 16-byte aligned with unit key stride
  long long qs[3], ks[3], vs[3], os[3];   // element strides of (b, h, l)
  long long bs[4];                        // bias strides of (b, h, q, k)
  float qscale;   // K2: scale*log2e (no bias) or scale (bias); K6: scale
  float pscale;   // K2: 1 (scores already base 2) or log2e; K6: log2e
};

// The C entries' packed arguments, every field 8 bytes (the wrappers'
// struct.pack("<7q11q16q2d")).
struct FlashCall {
  long long q, k, v, bias, o, lse, ws;   // device pointers, 0 for none
  long long B, H, Lq, Lk, D, rw, kw, nsplit, split_chunks, has_bias, stream;
  long long strides[16];   // (b, h, l) of q, k, v, o; the bias's (b, h, q, k)
  double qscale, pscale;
};

__device__ __forceinline__ void cp_async_bytes(void* smem, const void* gmem,
                                               int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0));
}

// at most n (0 to 3) copy groups still pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// a ring slot: one chunk of K and V, and its bias rows
__host__ __device__ constexpr size_t slot_bytes(int KS, int bias_rows) {
  return sizeof(bf16) * 2 * FK * (KS * 16 + 8) +
         sizeof(float) * (size_t)bias_rows * BST;
}

// threads a block at most: 16 warps where 128 registers a thread do
constexpr int max_threads(int KS) { return KS <= 4 ? 512 : 256; }

template <int KS, bool TILED>
__global__ void __launch_bounds__(max_threads(KS))
    flash_kernel(const FlashArgs a) {
  constexpr int DP = KS * 16;
  constexpr int ST = DP + 8;      // row stride: conflict-free ldmatrix
  constexpr int NE = 8 * KS + 4;  // a warp's partial: o, m0, m1, l0, l1
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RW = a.rw, KW = a.kw, R = a.rounds;
  const int QR = RW * 16, NTH = RW * KW * 32;
  const size_t sbytes = slot_bytes(KS, a.bias_rows);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // QR x ST, then the ring
  unsigned char* ring = smem_raw + sizeof(bf16) * QR * ST;
  auto Ks = [&](int slot) {
    return reinterpret_cast<bf16*>(ring + slot * sbytes);
  };
  auto Bs = [&](int slot) {
    return reinterpret_cast<float*>(ring + slot * sbytes +
                                    sizeof(bf16) * 2 * FK * ST);
  };

  const int split = blockIdx.x % a.nsplit;
  const int q0 = (blockIdx.x / a.nsplit) * QR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp % RW, kw = warp / RW;
  const int g = lane >> 2, t = lane & 3;
  const int dv = DP / 8, dreal = a.D / 8;
  const bf16* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const bf16* kbase = a.k + b * a.ks[0] + h * a.ks[1];
  const bf16* vbase = a.v + b * a.vs[0] + h * a.vs[1];
  const float* bbase =
      a.bias_rows ? a.bias + b * a.bs[0] + h * a.bs[1] : nullptr;

  const int nc = (a.Lk + FK - 1) / FK;
  const int c0 = split * a.split_chunks;
  const int n = min(nc - c0, a.split_chunks);   // >= 1: no split is empty
  const int nr = (n + KW - 1) / KW;             // rounds of KW chunks

  // chunk i of this split (all threads copy) into ring slot `slot`
  auto load_chunk = [&](int i, int slot) {
    const int k0 = (c0 + i) * FK;
    bf16* Kd = Ks(slot);
    bf16* Vd = Kd + FK * ST;
    for (int v = tid; v < FK * dv; v += NTH) {
      const int r = v / dv, c = v % dv, key = k0 + r;
      const bool ok = key < a.Lk && c < dreal;
      cp_async_16(Kd + r * ST + c * 8,
                  ok ? kbase + key * a.ks[2] + c * 8 : kbase, ok);
      cp_async_16(Vd + r * ST + c * 8,
                  ok ? vbase + key * a.vs[2] + c * 8 : vbase, ok);
    }
    if (a.bias_rows) {
      float* Bd = Bs(slot);
      if (a.bias_vec) {
        for (int v = tid; v < a.bias_rows * (FK / 4); v += NTH) {
          const int r = v / (FK / 4), key = k0 + (v % (FK / 4)) * 4;
          const bool ok = q0 + r < a.Lq && key < a.Lk;
          const int bytes = ok ? 4 * min(4, a.Lk - key) : 0;
          cp_async_bytes(Bd + r * BST + key - k0,
                         ok ? bbase + (q0 + r) * a.bs[2] + key : bbase, bytes);
        }
      } else {
        for (int v = tid; v < a.bias_rows * FK; v += NTH) {
          const int r = v / FK, key = k0 + v % FK;
          const bool ok = q0 + r < a.Lq && key < a.Lk;
          cp_async_4(Bd + r * BST + key - k0,
                     ok ? bbase + (q0 + r) * a.bs[2] + key * a.bs[3] : bbase,
                     ok);
        }
      }
    }
  };
  // round r: chunks r*KW .. r*KW + KW - 1 into slots (r % R)*KW + ...
  auto load_round = [&](int r) {
    for (int j = 0; j < KW; ++j)
      if (r * KW + j < n) load_chunk(r * KW + j, (r % R) * KW + j);
    cp_async_commit();
  };

  // the Q tile and the ring's first R - 1 rounds in flight together
  for (int v = tid; v < QR * dv; v += NTH) {
    const int r = v / dv, c = v % dv, row = q0 + r;
    const bool ok = row < a.Lq && c < dreal;
    cp_async_16(Qs + r * ST + c * 8, ok ? qb + row * a.qs[2] + c * 8 : qb,
                ok);
  }
  cp_async_commit();
  const int pre = max(R - 1, 1);   // with one round of slots, round 0 too
  for (int r = 0; r < pre; ++r) load_round(r);
  cp_async_wait_n(pre);            // the Q tile landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t r[4];
    ldmatrix_x4(r, Qs + (rw * 16 + (lane & 15)) * ST + ks * 16 +
                       (lane >> 4) * 8);
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

  const bool active = q0 + rw * 16 < a.Lq;   // warp-uniform
  const int r0 = q0 + rw * 16 + g, r1 = r0 + 8;
  // this lane's two staged bias rows (one shared row when broadcast)
  const int br0 = a.bias_rows > 1 ? (rw * 16 + g) * BST : 0;
  const int br1 = a.bias_rows > 1 ? br0 + 8 * BST : 0;

  float o[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
  const int NT = a.D / 8;

  for (int r = 0; r < nr; ++r) {
    if (R == 1) {        // one round resident at a time
      if (r > 0) {
        __syncthreads();            // round r - 1's slots are free
        load_round(r);
      }
      cp_async_wait<0>();
    } else {
      cp_async_wait_n(R - 2);       // round r landed (this thread's copies)
    }
    __syncthreads();                // ... everyone's; round r - 1 is done
    if (R > 1) load_round(r + R - 1);
    const int i = r * KW + kw;
    if (!active || i >= n) continue;
    const int slot = (r % R) * KW + kw;
    const bf16* Kc = Ks(slot);
    const bf16* Vc = Kc + FK * ST;
    const float* Bc = Bs(slot);
    const int k0 = (c0 + i) * FK;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t rr[4];
        ldmatrix_x4(rr, Kc + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * ST +
                            ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * kb], qf[ks], rr[0], rr[1]);
        mma_bf16(s[2 * kb + 1], qf[ks], rr[2], rr[3]);
      }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = j * 8 + 2 * t;   // this lane's first key in the chunk
      float2 b0 = make_float2(0.f, 0.f), b1 = b0;
      if (a.bias_rows) {
        b0 = *reinterpret_cast<const float2*>(Bc + br0 + kc);
        b1 = *reinterpret_cast<const float2*>(Bc + br1 + kc);
      }
      const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e];
        if constexpr (TILED) val *= a.qscale;
        val = k0 + kc + (e & 1) < a.Lk ? val + bv[e] : NEG_BIG;
        s[j][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val);
        else mx1 = fmaxf(mx1, val);
      }
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
    for (int j = 0; j < 2 * KS; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
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
      for (int j = 0; j < 2 * KS; j += 2) {
        if (j < NT) {   // NT even or odd: padded columns are zero
          uint32_t rr[4];
          ldmatrix_x4_trans(rr, vrow + j * 8 + (lane >> 4) * 8);
          mma_bf16(o[j], pa, rr[0], rr[1]);
          mma_bf16(o[j + 1], pa, rr[2], rr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // nothing may land after the ring is reused or left
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  if (KW > 1) {
    // key warps 1.. hand their partials to key warp 0 of their rows through
    // the Q tile's and the ring's memory (it fits: launch_ks), lane-major
    float* ex = reinterpret_cast<float*>(smem_raw) + lane;
    __syncthreads();
    if (kw > 0 && active) {
      float* p = ex + ((kw - 1) * RW + rw) * 32 * NE;
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[(j * 4 + e) * 32] = o[j][e];
      p[(NE - 4) * 32] = m0;
      p[(NE - 3) * 32] = m1;
      p[(NE - 2) * 32] = l0;
      p[(NE - 1) * 32] = l1;
    }
    __syncthreads();
    if (kw > 0 || !active) return;
    for (int w = 1; w < KW; ++w) {
      const float* p = ex + ((w - 1) * RW + rw) * 32 * NE;
      const float pm0 = p[(NE - 4) * 32], pm1 = p[(NE - 3) * 32];
      const float mn0 = fmaxf(m0, pm0), mn1 = fmaxf(m1, pm1);
      const float a0 = fast_exp2((m0 - mn0) * a.pscale);
      const float a1 = fast_exp2((m1 - mn1) * a.pscale);
      const float b0 = fast_exp2((pm0 - mn0) * a.pscale);
      const float b1 = fast_exp2((pm1 - mn1) * a.pscale);
      l0 = l0 * a0 + p[(NE - 2) * 32] * b0;
      l1 = l1 * a1 + p[(NE - 1) * 32] * b1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j) {
        o[j][0] = o[j][0] * a0 + p[(j * 4) * 32] * b0;
        o[j][1] = o[j][1] * a0 + p[(j * 4 + 1) * 32] * b0;
        o[j][2] = o[j][2] * a1 + p[(j * 4 + 2) * 32] * b1;
        o[j][3] = o[j][3] * a1 + p[(j * 4 + 3) * 32] * b1;
      }
    }
  }
  if (!active) return;
  if (a.nsplit == 1) {
    bf16* ob = a.o + b * a.os[0] + h * a.os[1] + 2 * t;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      if (j < NT) {
        if (r0 < a.Lq)
          *reinterpret_cast<uint32_t*>(ob + r0 * a.os[2] + j * 8) =
              pack_bf16(o[j][0] / l0, o[j][1] / l0);
        if (r1 < a.Lq)
          *reinterpret_cast<uint32_t*>(ob + r1 * a.os[2] + j * 8) =
              pack_bf16(o[j][2] / l1, o[j][3] / l1);
      }
    }
    if constexpr (TILED) {
      if (a.lse != nullptr && t == 0) {
        float* lb = a.lse + ((long long)b * a.H + h) * a.Lq;
        if (r0 < a.Lq) lb[r0] = m0 + logf(l0);
        if (r1 < a.Lq) lb[r1] = m1 + logf(l1);
      }
    }
    return;
  }
  // this split's partial: acc unnormalised, and m, l of each row
  const long long rows = (long long)a.B * a.H * a.Lq;
  const long long row0 = ((long long)b * a.H + h) * a.Lq;
  float* acc = a.ws + (split * rows + row0) * a.D + 2 * t;
  float* wm = a.ws + a.nsplit * rows * a.D + split * rows + row0;
  float* wl = wm + a.nsplit * rows;
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    if (j < NT) {
      if (r0 < a.Lq)
        *reinterpret_cast<float2*>(acc + r0 * a.D + j * 8) =
            make_float2(o[j][0], o[j][1]);
      if (r1 < a.Lq)
        *reinterpret_cast<float2*>(acc + r1 * a.D + j * 8) =
            make_float2(o[j][2], o[j][3]);
    }
  }
  if (t == 0) {
    if (r0 < a.Lq) {
      wm[r0] = m0;
      wl[r0] = l0;
    }
    if (r1 < a.Lq) {
      wm[r1] = m1;
      wl[r1] = l1;
    }
  }
}

// One warp a query row: o = sum_i acc_i w_i / sum_i l_i w_i with
// w_i = exp2((m_i - max_i m_i) * pscale), and lse = m + log(sum l_i w_i).
// Lane s holds split s's m and l (32 splits a pass), so the statistics
// cost one memory round trip and the accumulators, whose loads do not wait
// on them, a second.
template <bool TILED>
__global__ void __launch_bounds__(128) combine_kernel(const FlashArgs a) {
  const long long rows = (long long)a.B * a.H * a.Lq;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* wm = a.ws + a.nsplit * rows * a.D + row;
  const float* wl = wm + a.nsplit * rows;
  float m = NEG_BIG;
  for (int s = lane; s < a.nsplit; s += 32) m = fmaxf(m, wm[s * rows]);
  m = warp_max(m);
  float l = 0.f;
  float2 acc[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  const float* src = a.ws + row * a.D + 2 * lane;
  for (int s0 = 0; s0 < a.nsplit; s0 += 32) {
    const int s = s0 + lane;
    const float w = s < a.nsplit ? fast_exp2((wm[s * rows] - m) * a.pscale)
                                 : 0.f;
    l += s < a.nsplit ? wl[s * rows] * w : 0.f;
    const int n = min(32, a.nsplit - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* x = src + (s0 + j) * rows * a.D;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (2 * lane + 64 * c < a.D) {
          const float2 v = *reinterpret_cast<const float2*>(x + 64 * c);
          acc[c].x += v.x * wj;
          acc[c].y += v.y * wj;
        }
      }
    }
  }
  l = warp_sum(l);
  const int r = (int)(row % a.Lq);
  const int bh = (int)(row / a.Lq);
  bf16* ob = a.o + (bh / a.H) * a.os[0] + (bh % a.H) * a.os[1] +
             r * a.os[2] + 2 * lane;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (2 * lane + 64 * c < a.D)
      *reinterpret_cast<uint32_t*>(ob + 64 * c) =
          pack_bf16(acc[c].x / l, acc[c].y / l);
  if constexpr (TILED) {
    if (a.lse != nullptr && lane == 0) a.lse[row] = m + logf(l);
  }
}

template <int KS, bool TILED>
cudaError_t launch_ks(FlashArgs a, cudaStream_t stream) {
  const int QR = a.rw * 16;
  a.bias_rows = a.bias == nullptr ? 0 : (a.bs[2] == 0 ? 1 : QR);
  a.bias_vec = a.bias != nullptr &&
               (reinterpret_cast<uintptr_t>(a.bias) & 15) == 0 &&
               a.bs[3] == 1 && a.bs[0] % 4 == 0 && a.bs[1] % 4 == 0 &&
               a.bs[2] % 4 == 0;
  const int nc = (a.Lk + FK - 1) / FK;
  if (a.rw < 1 || a.rw > 8 || a.kw < 1 ||
      a.rw * a.kw * 32 > max_threads(KS) || a.nsplit < 1 ||
      a.split_chunks < 1 || (a.nsplit - 1) * a.split_chunks >= nc ||
      a.nsplit * a.split_chunks < nc || (a.nsplit > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;   // every split holds at least one key
  // R rounds of kw slots after the Q tile: as many as fit, up to 4, and no
  // more than the split's rounds
  const size_t qbytes = sizeof(bf16) * QR * (KS * 16 + 8);
  const size_t round = a.kw * slot_bytes(KS, a.bias_rows);
  const int rounds = (a.split_chunks + a.kw - 1) / a.kw;
  a.rounds = std::min(std::min(4, rounds), (int)((MAX_SMEM - qbytes) / round));
  const size_t handoff = sizeof(float) * 32 * (8 * KS + 4) * a.rw * (a.kw - 1);
  if (a.rounds < 1 || handoff > qbytes + a.rounds * round)
    return cudaErrorInvalidValue;
  // the 227 KB opt-in, once per kernel instance and device
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !allowed[dev]) {
    e = cudaFuncSetAttribute(flash_kernel<KS, TILED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) allowed[dev] = true;
  }
  dim3 grid(((a.Lq + QR - 1) / QR) * a.nsplit, a.H, a.B);
  flash_kernel<KS, TILED><<<grid, a.rw * a.kw * 32,
                            qbytes + a.rounds * round, stream>>>(a);
  if (a.nsplit > 1) {
    const long long rows = (long long)a.B * a.H * a.Lq;
    combine_kernel<TILED><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// The launch of a packed call: head dim D a multiple of 8 up to 128, the
// plan (row and key warps, splits) chosen by the wrapper.
template <bool TILED>
cudaError_t launch(const FlashCall* c) {
  FlashArgs a;
  a.q = reinterpret_cast<const bf16*>(c->q);
  a.k = reinterpret_cast<const bf16*>(c->k);
  a.v = reinterpret_cast<const bf16*>(c->v);
  a.bias = c->has_bias ? reinterpret_cast<const float*>(c->bias) : nullptr;
  a.o = reinterpret_cast<bf16*>(c->o);
  a.lse = TILED ? reinterpret_cast<float*>(c->lse) : nullptr;
  a.ws = reinterpret_cast<float*>(c->ws);
  a.B = (int)c->B;
  a.H = (int)c->H;
  a.Lq = (int)c->Lq;
  a.Lk = (int)c->Lk;
  a.D = (int)c->D;
  a.rw = (int)c->rw;
  a.kw = (int)c->kw;
  a.nsplit = (int)c->nsplit;
  a.split_chunks = (int)c->split_chunks;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = c->strides[i];
    a.ks[i] = c->strides[3 + i];
    a.vs[i] = c->strides[6 + i];
    a.os[i] = c->strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) a.bs[i] = c->strides[12 + i];
  a.qscale = (float)c->qscale;
  a.pscale = (float)c->pscale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(c->stream);
  switch ((a.D + 15) / 16) {
    case 1: return launch_ks<1, TILED>(a, s);
    case 2: return launch_ks<2, TILED>(a, s);
    case 3: return launch_ks<3, TILED>(a, s);
    case 4: return launch_ks<4, TILED>(a, s);
    case 5: return launch_ks<5, TILED>(a, s);
    case 6: return launch_ks<6, TILED>(a, s);
    case 7: return launch_ks<7, TILED>(a, s);
    case 8: return launch_ks<8, TILED>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace mico
