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
//   (a) the persistent, warp-specialised GEMM of wgmma_gemm.cuh: clusters
//       of two CTAs that share each W tile by TMA multicast, a 3-stage
//       ring, two consumer warpgroups of wgmma m64n256k16, the bias in fp32
//       in the epilogue, one rounding to bf16, TMA stores into a (B*L, 3W)
//       scratch;
//   (b) the packed attention of qkv_attn.cuh: one block per (b, h) stages
//       the head's K and V once by TMA, takes Q in 64-row tiles, keeps each
//       score row in registers (QK^T once, the exact maximum from
//       registers) and runs both products as wgmma.
// At bigE's pass the two take about 0.72 and 0.24 ms of device time on an
// H100 80GB HBM3 at 700 W (scripts/torch_qkv_bench.py; PERF.md). K1
// (fused_ln_qkv_attn.cu) runs the same two stages, its GEMM in the
// LayerNorm-prologue instance, after a statistics pass; K3 (packed_attn.cu)
// runs the attention alone.

#include "common.cuh"
#include "qkv_attn.cuh"
#include "wgmma_gemm.cuh"

// x (B*L, W) bf16; w (W, 3*H*D) bf16; bias (3*H*D) fp32; qkv (B*L,
// 3*H*D) bf16 is scratch; out (B, L, H*D) bf16. H heads of D: all of them
// (H*D = W), or a tensor-parallel rank's share, whose packed columns are
// [q_h | k_h | v_h] of its heads. Needs W % 8 == 0 and D a multiple of 8
// up to 128 (the wrapper checks); any L.
extern "C" int mico_fused_qkv_attn(const void* x, const void* w,
                                   const void* bias, void* qkv, void* out,
                                   int B, int L, int W, int H, int D,
                                   float qk_scale, void* stream) {
  using mico::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HD = H * D;
  cudaError_t e = mico::wg::launch_gemm(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(qkv), B * L, W,
      3 * HD, s);
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(qkv);
  return mico::qattn::launch_attn(q, q + HD, q + 2 * HD, 3 * HD,
                                  static_cast<bf16*>(out), B, L, H, D,
                                  qk_scale, s);
}

// The GEMM stage alone, for checks and timing (no model path calls it):
// out (M, N) = a (M, K) . w (K, N) + bias, bf16 with fp32 bias, rounded
// once. K % 8 == 0 and N % 8 == 0.
extern "C" int mico_bf16_gemm_bias(const void* a, const void* w,
                                   const void* bias, void* out, int M, int K,
                                   int N, void* stream) {
  using mico::bf16;
  return mico::wg::launch_gemm(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), M, K, N,
      static_cast<cudaStream_t>(stream));
}
