// K5: projection-fused packed self-attention for the post-norm EVA block.
//
// Replaces the TPU kernel `_fused_qkv_attn_fwd`
// (mico_tpu/ops/flash_attention.py:1277, pallas_call at :1292, body
// `_fused_qkv_attn_kernel` :1229, public entry `fused_qkv_self_attention`
// :1329). It is K1 without the LayerNorm: the block input x is not
// normalised before the projection (a post-norm block normalises after the
// branch). Per batch row,
//   qkv = x . W_qkv (fp32 accumulate) + bias (fp32), rounded to bf16
//   o_h = softmax2(q_h k_h^T * scale * log2e) v_h  for every head h,
// written packed as (B, L, H*D) bf16, at the Pallas body's rounding points:
// scores in fp32 scaled after the product with log2(e) folded in, the
// unnormalised exp2 p rounded to bf16 for the PV product while the row sum
// is taken over the unrounded p, then o / l.
//
// What bounds it on the H100: tensor-core operations. At the bigE omni
// step's ViT pass (B = 112 frames, L = 257, W = 1792, H = 16, D = 112) the
// projection is 2*28784*1792*5376 = 554.6 GFLOP and the attention
// 4*112*16*257^2*112 = 53.0 GFLOP: 607.6 GFLOP, 0.614 ms at 989 TFLOP/s
// bf16, against 225 MB of compulsory bytes (x in, o out, W once; 0.067 ms
// at 3.35 TB/s).
//
// Design. The TPU kernel kept the 19.3 MB W_qkv resident in VMEM across the
// batch grid and computed qkv in VMEM, so qkv never reached HBM. A Hopper SM
// has 227 KB of shared memory, so here qkv makes one round trip through
// HBM/L2 (2 x 309 MB at this shape) between two launches behind one C entry:
//   (a) the qkv GEMM of qkv_gemm.cuh without the LN prologue: x and W tiles
//       by cp.async, 128x128 tiles, mma.sync, the bias in fp32 in the
//       epilogue, one rounding to bf16 into a (B*L, 3W) scratch;
//   (b) the packed attention of packed_attn.cuh (shared with K1 and K3),
//       reading q/k/v of one head by column offset from the qkv rows (row
//       stride 3W). D = 112 takes its KS = 7 instance: 130,560 bytes of
//       shared memory at L = 257.
// wgmma, TMA and warp specialisation are left to later work.

#include "common.cuh"
#include "packed_attn.cuh"
#include "qkv_gemm.cuh"

// x (B*L, W) bf16; w (W, 3W) bf16; bias (3W) fp32; qkv (B*L, 3W) bf16 is
// scratch; out (B, L, W) bf16. Needs W % 32 == 0, 3W % 128 == 0 and
// D = W / H a multiple of 8 up to 128 (the wrapper checks).
extern "C" int mico_fused_qkv_attn(const void* x, const void* w,
                                   const void* bias, void* qkv, void* out,
                                   int B, int L, int W, int H, float qk_scale,
                                   void* stream) {
  using mico::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, N = 3 * W, D = W / H;
  cudaError_t e = mico::gemm::launch_gemm<false>(
      static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(qkv), M, W, N, 0, s);
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(qkv);
  return mico::packed::launch_attn(q, q + W, q + 2 * W, N,
                                   static_cast<bf16*>(out), B, L, H, D,
                                   qk_scale, s);
}
