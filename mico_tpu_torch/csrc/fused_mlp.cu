// P1: the fused ViT MLP probe, out = x + bf16(bf16(gelu_tanh(x W1)) W2).
//
// Replaces the TPU kernel `pallas_mlp` (scripts/pallas_matmul_probe.py:33,
// pallas_call :35, body `mlp_kernel` :24), with its rounding points:
//   h   = x W1 with fp32 accumulation over K, gelu (tanh form) applied to
//         the fp32 product, rounded to bf16;
//   y   = h W2 with fp32 accumulation over all N hidden columns, rounded
//         once to bf16;
//   out = bf16(y) + x, a bf16 add.
// No biases and no LayerNorm. x (M, K), W1 (K, N), W2 (N, K) bf16, row-major.
//
// What bounds it on the H100: tensor-core operations. At the probe's M, K,
// N = 28784, 1408, 6144 (ViT-g's MLP over 112 frames) the two products are
// 2 x 498 GFLOP: 1.007 ms at 989 TFLOP/s bf16, against 0.05 ms for x, both
// weights and out at 3.35 TB/s.
//
// Design. The TPU kernel keeps both weights (17.3 MB each) resident in VMEM
// and h on chip. An SM has 227 KB of shared memory, and fc2's fp32
// accumulator over all N hidden columns would hold a row tile of R rows x K:
// keeping it on chip forces R = 16 or 32, and each such block streams both
// weights from L2 again (31 GB of L2 traffic a call; the first design did
// that and took 14.85 ms). Because `mlp_kernel` rounds h to bf16 before fc2
// anyway, writing h to HBM in bf16 and reading it back changes nothing
// numerically: 2 x 354 MB at the probe's shape, about 0.21 ms at 3.35 TB/s,
// carried by TMA under about 1 ms of tensor-core work. So P1 is two
// launches of the persistent cluster GEMM of wgmma_gemm.cuh (TMA ring, W
// tiles multicast to a cluster of two, 128 x 256 tiles, two consumer
// warpgroups of wgmma, TMA-store epilogues), behind one C entry:
//   (1) h (M, N) = bf16(gelu_tanh(x W1)): the GELU epilogue on the fp32
//       accumulator (tanh.approx.f32), one rounding;
//   (2) out (M, K) = bf16(bf16(h W2) + x): W2 (N, K) row-major is already
//       the (K, N) layout the GEMM takes for its W; the epilogue rounds the
//       product, adds x (read from global memory, two columns a 4-byte
//       load) as a bf16 add and rounds again.
// h is scratch the wrapper allocates. fc2's last column tile is half empty
// at K 1408 = 5.5 x 256 (about 8% of fc2's tensor-core work); the TMA
// stores clip it. At the probe's shape the two take 0.71 and 0.73 ms of
// device time on an H100 80GB HBM3 at 700 W (1.44 ms, a 0.70 share of the
// bound), against 14.8 ms for the narrow-row-tile design this replaces and
// 1.62 for cuBLAS's two products with PyTorch's GELU and add
// (scripts/torch_mlp_probe.py; PERF.md).

#include "wgmma_gemm.cuh"

// x (M, K), w1 (K, N), w2 (N, K), out (M, K): contiguous bf16; h (M, N) bf16
// scratch; K and N multiples of 8 (the wrapper checks).
extern "C" int mico_fused_mlp(const void* x, const void* w1, const void* w2,
                              void* h, void* out, int M, int K, int N,
                              void* stream) {
  using mico::bf16;
  using namespace mico::wg;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* hp = static_cast<bf16*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_epi_gemm<EPI_GELU>(
      xp, static_cast<const bf16*>(w1), nullptr, hp, M, K, N, s);
  if (e != cudaSuccess) return e;
  return launch_epi_gemm<EPI_RESIDUAL>(hp, static_cast<const bf16*>(w2), xp,
                                       static_cast<bf16*>(out), M, N, K, s);
}
