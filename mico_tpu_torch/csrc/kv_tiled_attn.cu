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
// GFLOP: 0.015 ms at 3.35 TB/s against 0.0065 ms at 989 TFLOP/s; each key
// row meets only 128 query rows.
//
// Design. The device code is K2's (flash_attn.cuh) with `TILED` true: the
// TPU's (q-tile, k-tile) grid with its running statistics carried across
// sequential KV grid steps in VMEM scratch becomes one block per q-tile of
// 64 rows whose loop streams 64-key chunks through double-buffered shared
// memory, the statistics in registers. The TPU's 512 x 2048 production tiles
// do not change the arithmetic beyond where p is rounded relative to the
// running maximum. At Lq = 128 the grid is 2 x 12 x 2 = 48 blocks on 132
// SMs, and each q-tile reads K and V once: splitting the keys over more
// blocks is speed work for later.

#include "flash_attn.cuh"

// As mico_flash_attn, with lse (B, H, Lq) fp32 written when not null; the
// scores are scaled by `scale` in fp32 and exponentiated in base e.
extern "C" int mico_kv_tiled_attn(const void* q, const void* k, const void* v,
                                  const void* bias, void* o, void* lse, int B,
                                  int H, int Lq, int Lk, int D,
                                  const long long* strides, float scale,
                                  int has_bias, void* stream) {
  const mico::flash::FlashArgs a = mico::flash::make_args(
      q, k, v, bias, o, static_cast<float*>(lse), Lq, Lk, D, strides, scale,
      mico::LOG2E, has_bias);
  return mico::flash::launch<true>(a, B, H, static_cast<cudaStream_t>(stream));
}
