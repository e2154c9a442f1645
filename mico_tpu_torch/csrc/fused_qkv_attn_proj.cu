// K8: K5 followed by the attention's output projection.
//
// Replaces the TPU kernel `_fused_qkv_attn_proj_fwd`
// (mico_tpu/ops/flash_attention.py:1443, pallas_call at :1459, body
// `_fused_qkv_attn_proj_kernel` :1388, public entry `fused_qkv_attn_proj`
// :1501), the route of a post-norm block when `FUSED_ATTN_PROJ` (:1385) is
// on. Per batch row,
//   o   = K5(x, W_qkv, bias)               (B, L, W) bf16, K5's rounding
//   out = o . W_p (fp32 accumulate) + b_p (fp32), rounded to bf16
// — the Pallas body stages o in bf16 and takes the product from there.
//
// What bounds it on the H100: tensor-core operations. At the bigE omni
// step's ViT pass (B = 112, L = 257, W = 1792, H = 16, D = 112): K5's 607.6
// GFLOP plus 2*28784*1792*1792 = 184.9 GFLOP for the projection, 792.5
// GFLOP, 0.801 ms at 989 TFLOP/s bf16, against 232 MB of compulsory bytes
// (x in, out out, both weights once).
//
// Design. The TPU kernel kept W_qkv and W_p resident in VMEM, so neither
// qkv nor o reached HBM. Here both make one round trip through HBM/L2
// (qkv 2 x 309 MB, o 2 x 103 MB at this shape) between three launches
// behind one C entry: K5's two (the wgmma + TMA GEMM of wgmma_gemm.cuh, the
// packed attention of qkv_attn.cuh), then the same GEMM over o with W_p,
// the bias b_p added in fp32 in its epilogue. No library GEMM is called.
// On a tensor-parallel rank (`partial`) the out-projection is row-parallel:
// the last GEMM writes its fp32 accumulators without b_p (`EPI_F32`), the
// caller sums them over the model group in fp32, adds b_p once and rounds
// once to bf16, as the whole-width K8 rounds once.

#include "common.cuh"
#include "qkv_attn.cuh"
#include "wgmma_gemm.cuh"

// x (B*L, W) bf16; w (W, 3*H*D) bf16; bias (3*H*D) fp32; wp (H*D, W) bf16;
// bp (W) fp32; qkv (B*L, 3*H*D) and o (B*L, H*D) bf16 are scratch; out
// (B, L, W): bf16 with bp, or with `partial` (a tensor-parallel rank's
// heads, its out-projection row-parallel) the fp32 product o . wp without
// bp, which the caller sums over the ranks before it adds bp and rounds
// once. Needs what K5 needs (the wrapper checks).
extern "C" int mico_fused_qkv_attn_proj(const void* x, const void* w,
                                        const void* bias, const void* wp,
                                        const void* bp, void* qkv, void* o,
                                        void* out, int B, int L, int W, int H,
                                        int D, int partial, float qk_scale,
                                        void* stream) {
  using mico::bf16;
  using namespace mico::wg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, HD = H * D;
  cudaError_t e = launch_gemm(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(qkv), M, W, 3 * HD,
      s);
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(qkv);
  e = mico::qattn::launch_attn(q, q + HD, q + 2 * HD, 3 * HD,
                               static_cast<bf16*>(o), B, L, H, D, qk_scale,
                               s);
  if (e != cudaSuccess) return e;
  if (partial)
    return launch_epi_gemm<EPI_F32>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(wp),
        static_cast<const bf16*>(out), static_cast<bf16*>(out), M, HD, W, s);
  return launch_gemm(static_cast<const bf16*>(o),
                     static_cast<const bf16*>(wp),
                     static_cast<const float*>(bp), static_cast<bf16*>(out), M,
                     HD, W, s);
}
