// K3: packed self-attention forward for ViT training.
//
// Replaces the TPU kernels `_packed_qkv_fwd` (mico_tpu/ops/flash_attention.py
// :1135, pallas_call :1155, kernel `_packed_qkv_kernel` :803) and
// `_packed_fwd` (:885, pallas_call :897, kernel `_packed_kernel` :799), both
// over the body `_packed_body` (:757): per batch row and head, base-2
// softmax attention with the unnormalised p rounded to bf16 for the PV
// product and the output divided by the fp32 row sum.
//
// The device code is the attention of K1, K5 and K8 (qkv_attn.cuh): one
// launch serves the fused qkv (three column offsets into (B, L, 3W) rows,
// row stride 3W) and the three-input form (three (B, L, W) tensors, row
// stride W), because it takes three base pointers and one row stride, each
// addressed through a tensor map of its own.
//
// What bounds it on the H100: bytes. At the train step's vision pass
// (qkv (32, 257, 4224) bf16, 16 heads of 88) it reads 69.5 MB and writes
// 23.2 MB: 0.028 ms at 3.35 TB/s, against 4*32*16*257^2*88 = 11.9 GFLOP,
// 0.012 ms at 989 TFLOP/s. One block per (b, h) reads its head's q, k and v
// once (TMA, K/V staged whole at L <= 272 and streamed past it), keeps each
// score row in registers and runs both products on wgmma.

#include "qkv_attn.cuh"

// q, k, v: pointers to the head-0 columns of batch row 0 (for the fused qkv:
// qkv, qkv + W, qkv + 2W); rows `ld` elements apart; out (B, L, H*D) bf16.
extern "C" int mico_packed_attn(const void* q, const void* k, const void* v,
                                int ld, void* out, int B, int L, int H, int D,
                                float qk_scale, void* stream) {
  return mico::qattn::launch_attn(
      static_cast<const mico::bf16*>(q), static_cast<const mico::bf16*>(k),
      static_cast<const mico::bf16*>(v), ld, static_cast<mico::bf16*>(out), B,
      L, H, D, qk_scale, static_cast<cudaStream_t>(stream));
}
