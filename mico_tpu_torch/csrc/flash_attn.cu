// K2: flash attention on (B, H, Lq, D) with an optional additive bias.
//
// Replaces the TPU kernel `_flash` (mico_tpu/ops/flash_attention.py:93,
// pallas_call at :127; public entry `flash_attention` :703) and both of its
// bodies:
//   _kernel (:49)      no bias: q scaled in fp32 by scale*log2e, rounded to
//                      bf16, s = q'k^T in fp32, p = exp2(s - max);
//   _kernel_bias (:71) bias:    q scaled in fp32 by scale, rounded to bf16,
//                      s = q'k^T + bias in fp32, p = exp(s - max).
// p is rounded to bf16 for the PV product, the row sum is taken over the
// unrounded fp32 p, and the output is o / l in bf16. The bias broadcasts over
// any of (B|1, H|1, Lq|1, Lk) through the strides the wrapper passes (0 on a
// broadcast axis).
//
// What bounds it on the H100: memory bytes, and below a few microseconds of
// work the launch itself. At the ITM cross-attention shape (q (N, 12, 30,
// 64), k/v (N, 12, 257*n, 64)) each key row is used by only 30 query rows:
// 4*Lq*D = 7.7 kFLOP per 256 bytes of K and V, 30 op/byte, a tenth of the
// 295 op/byte where the tensor cores would take over; its bound is 0.00079
// ms at N = 3, the recompute decode's (1, 12, 10, 64) over 1028 keys
// 0.00095 ms. Both are far below a launch, so the wrapper's host time and
// the device's latency chain (load Q, then each key chunk) set the time.
//
// Design (flash_attn.cuh, shared with K6: `TILED` false keeps K2's rounding
// points). The TPU kernel keeps the whole K/V of a head resident in VMEM;
// Lk reaches 8192 here and a head's K/V (2 MB at D = 128) does not fit the
// SM's 227 KB. So K and V stream through a cp.async ring of 64-key chunks
// with an online softmax, the bias chunk staged beside them. One block
// holds all of a head's query rows (1 warp of rows at the decode's 10, 2 at
// ITM's 30), so K and V are read once. At these shapes one warp walking
// the chunks in series (~2 us a chunk) is what takes the time, so the
// wrapper's plan shortens that chain: ITM's 5 chunks go to 3 splits
// across blocks of 2 key warps each, the decode's 17 to 9 splits of 2 key
// warps, each with a combine kernel; the causal 128 x 128 self-attention
// to 2 key warps of one block. The result differs from the
// full-row softmax of the plain twin by fp32 reassociation and by where p
// is rounded relative to a running maximum. The wrapper packs every
// argument into one struct (one ctypes argument) to keep its host time
// down.

#include "flash_attn.cuh"

// `call` points to a FlashCall (flash_attn.cuh): q/k/v/o bf16 with unit
// stride on D, the bias fp32 (0 strides where broadcast), D a multiple of 8
// up to 128, the plan (row and key warps, splits) chosen by the wrapper.
extern "C" int mico_flash_attn(const void* call) {
  return mico::flash::launch<false>(
      static_cast<const mico::flash::FlashCall*>(call));
}
