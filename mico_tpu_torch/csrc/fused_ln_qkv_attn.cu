// K1: LayerNorm-fused packed self-attention for the EVA ViT block.
//
// Replaces the TPU kernel `_fused_ln_qkv_attn_kernel`
// (mico_tpu/ops/flash_attention.py:1567, pallas_call at :1641, public entry
// `fused_ln_qkv_self_attention` :1678). It computes, per batch row,
//   xn  = LN(x) in fp32 (biased variance, optional affine), rounded to bf16
//   qkv = xn . W_qkv (fp32 accumulate) + bias (fp32), rounded to bf16
//   o_h = softmax2(q_h k_h^T * scale * log2e) v_h  for every head h,
// written packed as (B, L, H*D) bf16 — the same rounding points as the
// Pallas body: scores in fp32 scaled after the product, base-2 softmax over
// the full row, p rounded to bf16 for the PV product while the row sum is
// taken over the unrounded fp32 p, then o / l.
//
// What bounds it on the H100: tensor-core operations. At the ViT-g bench
// shape (B = 112 frames, L = 257, W = 1408, H = 16, D = 88) the projection is
// 2*28784*1408*4224 = 342 GFLOP and the attention 4*112*16*257^2*88 = 42
// GFLOP: 384 GFLOP, 0.39 ms at 989 TFLOP/s bf16, against 0.33 MB/frame of
// compulsory bytes (x in, o out, W once) — far above the card's 295 op/byte.
//
// Design. On the TPU the 11.9 MB W_qkv sits resident in VMEM and qkv never
// reaches HBM; a Hopper SM has 227 KB, so neither holds here. Three launches
// behind one C entry instead, the last two K5's (fused_qkv_attn.cu):
//   (a) ln_stats: one warp per row takes fp32 mean and rstd (two passes over
//       the row held in registers), 8 bytes per row to global memory;
//   (b) the LN-prologue instance of the wgmma + TMA GEMM (wgmma_gemm.cuh,
//       `ln_gemm_kernel`): TMA brings the raw x and W tiles, each consumer
//       warp loads its rows of x into wgmma's A-fragment registers,
//       normalises them (and applies the affine) in fp32 and rounds to bf16
//       there, and wgmma takes A from registers and W from shared memory,
//       so the normalised tensor never exists in global (or shared) memory;
//       the bias is added in fp32 in the epilogue, one rounding, TMA stores
//       into a (B*L, 3W) scratch;
//   (c) the packed attention of qkv_attn.cuh over the scratch's column
//       slices (one block per (b, h), K/V staged once by TMA, the score row
//       in registers, both products on wgmma).

#include "common.cuh"
#include "qkv_attn.cuh"
#include "wgmma_gemm.cuh"

namespace {
using namespace mico;

// ---------------------------------------------------------------- (a) stats
constexpr int ST_ROWS = 8;   // rows (warps) per block
constexpr int ST_VEC = 8;    // 16-byte vectors per lane: K <= 2048

__global__ void __launch_bounds__(ST_ROWS * 32)
ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int M,
                int K, float eps) {
  const int row = blockIdx.x * ST_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const int nv = K / 8;
  float v[ST_VEC * 8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < ST_VEC; ++i) {
    const int c = lane + i * 32;
    const uint4 u = c < nv ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16(w[j]);
      v[i * 8 + 2 * j] = f.x;
      v[i * 8 + 2 * j + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < ST_VEC; ++i) {
    if (lane + i * 32 < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dv = v[i * 8 + j] - mean;
        q += dv * dv;
      }
    }
  }
  const float var = warp_sum(q) / K;
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(var + eps));
}

}  // namespace

// x (B*L, W) bf16; gamma/beta (W) fp32 (read when affine); w (W, 3*H*D)
// bf16; bias (3*H*D) fp32; stats (B*L, 2) fp32 and qkv (B*L, 3*H*D) bf16
// are scratch; out (B, L, H*D) bf16. The LayerNorm runs over all W columns
// of x (whole on every tensor-parallel rank); the GEMM and the attention
// over the H heads of D given: all of them (H*D = W), or a rank's share,
// packed [q_h | k_h | v_h]. Needs W % 8 == 0, W <= 2048 and D a multiple
// of 8 up to 128 (the wrapper checks); any L.
extern "C" int mico_fused_ln_qkv_attn(const void* x, const void* gamma,
                                      const void* beta, const void* w,
                                      const void* bias, void* stats, void* qkv,
                                      void* out, int B, int L, int W, int H,
                                      int D, float eps, int affine,
                                      float qk_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, HD = H * D, N = 3 * HD;
  ln_stats_kernel<<<(M + ST_ROWS - 1) / ST_ROWS, ST_ROWS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(stats), M, W, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = mico::wg::launch_ln_gemm(
      static_cast<const bf16*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      affine, static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(qkv), M, W, N, s);
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(qkv);
  return mico::qattn::launch_attn(q, q + HD, q + 2 * HD, N,
                                  static_cast<bf16*>(out), B, L, H, D,
                                  qk_scale, s);
}

// Stages (a) and (b) alone, for checks and timing (no model path calls
// them): out (M, N) = LN(x) . w + bias; stats (M, 2) fp32 is scratch.
// K % 8 == 0, K <= 2048, N % 8 == 0.
extern "C" int mico_ln_gemm_bias(const void* x, const void* gamma,
                                 const void* beta, const void* w,
                                 const void* bias, void* stats, void* out,
                                 int M, int K, int N, float eps, int affine,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ln_stats_kernel<<<(M + ST_ROWS - 1) / ST_ROWS, ST_ROWS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(stats), M, K, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return mico::wg::launch_ln_gemm(
      static_cast<const bf16*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      affine, static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), M, K, N, s);
}
