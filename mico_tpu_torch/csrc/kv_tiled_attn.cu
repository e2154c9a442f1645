// K6: KV-tiled flash attention on (B, H, Lq, D), an optional additive bias
// and an optional per-row log-sum-exp.
//
// Replaces the TPU kernels `_flash_kv_tiled` (mico_tpu/ops/flash_attention.py
// :218, pallas_call :260) and `_flash_kv_tiled_stats` (:286, pallas_call
// :329), both over the body `_kv_tiled_kernel` (:160), which the JAX package
// runs past MAX_RESIDENT_KV = 8192 keys with at least KV_TILED_MIN_Q = 128
// query rows (`_flash_diff`, :637-662): long-context caption training over
// a 32-frame video's 8,224 condition tokens. The body's rounding points:
//   s   = q k^T in fp32 (q not prescaled, not rounded again), times scale,
//         plus the fp32 bias; keys past Lk filled with -1e30 (`_NEG_BIG`)
//   p   = exp(s - m), m the running row maximum; here exp2((s - m) log2e)
//   o   = (bf16(p) v, fp32 accumulate, rescaled online) / l, l the row sum
//         of the unrounded p, written in bf16
//   lse = m + log(l) in fp32, (B, H, Lq), when asked for (the stats form).
//
// What bounds it on the H100: bytes. At the long-context step's shape (q
// (2, 12, 128, 64), k/v (2, 12, 8224, 64) bf16) it must read 51 MB for 6.5
// GFLOP: 0.0153 ms at 3.35 TB/s against 0.0065 ms at 989 TFLOP/s; each key
// row meets only 128 query rows. Keeping 3.35 TB/s busy at ~1 us of memory
// latency takes ~3 MB of copies in flight, ~25 KB an SM.
//
// Design. The device code is K2's (flash_attn.cuh) with `TILED` true: the
// TPU's (q-tile, k-tile) grid with its running statistics carried across
// sequential KV grid steps in VMEM scratch becomes blocks that each run the
// online softmax over one contiguous range of 64-key chunks (split-KV),
// then a combine kernel that rescales the partials by exp(m_i - m) and
// writes o and the LSE. One block holds all 128 query rows (8 warps), so
// each head's K and V cross from memory once (51 MB, not the 101 MB of two
// 64-row q-tiles); the wrapper's plan gives 11 splits of 12 chunks, 264
// blocks on 132 SMs, each with a 4-stage cp.async ring (48 KB in flight a
// block at D = 64). The TPU's 512 x 2048 production tiles and the splits
// change the arithmetic only in where p is rounded relative to the running
// maximum and in the fp32 order of the sums.

#include "flash_attn.cuh"

// As mico_flash_attn, with lse (B, H, Lq) fp32 written when the call's lse
// is not 0; the scores are scaled by `qscale` in fp32 and exponentiated in
// base e (pscale = log2e).
extern "C" int mico_kv_tiled_attn(const void* call) {
  return mico::flash::launch<true>(
      static_cast<const mico::flash::FlashCall*>(call));
}
