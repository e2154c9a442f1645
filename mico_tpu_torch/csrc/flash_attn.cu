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
// What bounds it on the H100: memory bytes. At the ITM cross-attention shape
// (q (N, 12, 30, 64), k/v (N, 12, 257*n, 64)) each key row is used by only
// 30 query rows: 4*Lq*D = 7.7 kFLOP per 256 bytes of K and V, 30 op/byte,
// a tenth of the 295 op/byte where the tensor cores would take over.
//
// Design. The TPU kernel keeps the whole K/V of a head resident in VMEM;
// Lk reaches 8192 here and a head's K/V (2 MB at D = 128) does not fit the
// SM's 227 KB. So K and V stream through shared memory in 64-key chunks
// with an online softmax (flash_attn.cuh, shared with K6: `TILED` false
// keeps K2's rounding points). The result differs from the full-row softmax
// of the plain twin by fp32 reassociation only. The Q tile is scaled and
// rounded once into mma fragments held in registers. Each K/V byte is read
// once per q-tile of 64 rows, so at Lq <= 64 the kernel reads the
// compulsory bytes once.

#include "flash_attn.cuh"

// q/k/v/o bf16 with unit stride on D; strides[0..11] the (b, h, l) element
// strides of q, k, v, o; strides[12..15] the bias's (b, h, q, k) strides (fp32,
// 0 where broadcast). D a multiple of 8 up to 128 (the wrapper checks).
extern "C" int mico_flash_attn(const void* q, const void* k, const void* v,
                               const void* bias, void* o, int B, int H, int Lq,
                               int Lk, int D, const long long* strides,
                               float qscale, float pscale, int has_bias,
                               void* stream) {
  const mico::flash::FlashArgs a = mico::flash::make_args(
      q, k, v, bias, o, nullptr, Lq, Lk, D, strides, qscale, pscale, has_bias);
  return mico::flash::launch<false>(a, B, H, static_cast<cudaStream_t>(stream));
}
