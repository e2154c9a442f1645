// K9: CLS-split packed self-attention forward.
//
// Replaces the TPU kernel body `_packed_qkv_cls_kernel`
// (mico_tpu/ops/flash_attention.py:809), which `_packed_qkv_fwd` (:1135,
// pallas_call :1155) selects when PACKED_CLS_SPLIT is set and L > 128 with
// L % 128 == 1: K3's function on the fused qkv (B, L, 3W) with the CLS
// token (row 0) split from the P = L - 1 patch tokens. Its rounding points,
// which are not K3's:
//   s_pp = q_p k_p^T in fp32, times scale (natural exp, no log2e fold)
//   s_pc = sum_d q_p[d] k_cls[d], s_cp = sum_d k_p[d] q_cls[d] and s_cc:
//          fp32 elementwise products of the bf16 values summed over D,
//          times scale
//   patch rows: m = max(rowmax s_pp, s_pc), l = sum p_pp + p_pc over the
//          unrounded p; o = (bf16(p_pp) v_p, fp32 accumulate) + p_pc v_cls
//   CLS row:    m = max(max s_cp, s_cc), l likewise;
//          o = sum_j p_cp[j] v_p[j] (fp32, unrounded p) + p_cc v_cls
//   both rows divided by l after PV, rounded once to bf16.
//
// The device code is `cls_attn_kernel` of qkv_attn.cuh, the attention of
// K1, K3, K5 and K8 run over the patch rows: one block per (b, h), TMA
// loads through tensor maps based one row down (P rows, row stride 3W), a
// producer warpgroup and two consumer warpgroups of 64-row Q tiles, the
// score row in registers and both products on wgmma. What the TPU split was
// written for holds here too: at L = 257 the 256 patch rows are four full
// query tiles, two for each consumer warpgroup (K3 runs five, the last
// holding one row), and the 256 patch keys one n256 key block, whose n16
// tail takes k_cls, so that the tensor cores compute the CLS column too.
// The CLS row is fp32 CUDA-core work of the producer warpgroup's three
// warps that issue no copies. Past 257 tokens the CLS column moves to the
// consumers' CUDA cores, and past 273 the patch keys stream, as K3's do:
// any L >= 2.
//
// What bounds it on the H100: bytes, as K3. At CLIP-L/14's serving pass,
// qkv (112, 257, 3 x 16 x 64) bf16, it reads 177 MB and writes 59 MB:
// 0.070 ms at 3.35 TB/s, against 30.3 GFLOP, 0.031 ms at 989 TFLOP/s; at
// ViT-g's train pass, (32, 257, 3 x 16 x 88), 0.028 ms by bytes.

#include "qkv_attn.cuh"

// qkv: the fused (B, L, 3W) projection, rows 3W elements apart; out (B, L,
// W) bf16. D a multiple of 8 up to 128, L >= 2 (the wrapper checks).
extern "C" int mico_packed_cls_attn(const void* qkv, int ld, void* out, int B,
                                    int L, int H, int D, float scale,
                                    void* stream) {
  if (ld != 3 * H * D) return cudaErrorInvalidValue;
  return mico::qattn::launch_cls(static_cast<const mico::bf16*>(qkv),
                                 static_cast<mico::bf16*>(out), B, L, H, D,
                                 scale, static_cast<cudaStream_t>(stream));
}
