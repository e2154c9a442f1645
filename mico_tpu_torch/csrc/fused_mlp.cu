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
// What is hard on the H100: the TPU design keeps both weights (17.3 MB each
// at K 1408, N 6144) resident in VMEM. An SM has 228 KB of shared memory, so
// the weights stream through it in tiles and each hidden chunk is consumed
// on chip as it is made. fc2's fp32 accumulator must span every hidden
// chunk (rounding partial sums would change the function), and a row tile
// of R rows holds R x K of it: 360 KB at R = 64, more than an SM has.
// Design (the narrow row tile): one block of 8 warps owns R = 16 * MT rows
// (MT = 1 or 2, the wrapper's `rows_per_block` 16 or 32) and keeps fc2's
// whole R x K accumulator in registers (K / 8 columns per warp: 88 or 176
// fp32 a thread at K 1408). The x tile stays in shared memory. Per hidden
// chunk of 64 columns: fc1 over K in 64-row W1 slices (each warp one
// 8-column tile of the chunk, all R rows), GELU and the bf16 rounding into a
// shared h tile, then fc2 over the chunk in four 16-row W2 slices (each
// warp its K / 8 output columns). W1 and W2 slices are double-buffered with
// cp.async, one slice ahead; the epilogue adds x from shared memory.
// mma.sync m16n8k16 bf16 products with fp32 accumulators throughout.
//
// Its cost: each block streams both weights once (34.6 MB), so the weights
// cross from L2 M / R times (31 GB at M 28784, R 32): the design is bound
// by L2 bandwidth, not by the card's 1.007 ms operations bound
// (9.96e11 FLOP at 989 TFLOP/s). A split of the output columns over a
// thread-block cluster sharing each h chunk through distributed shared
// memory would allow R = 64 or more; that is later work.

#include "common.cuh"

namespace mico {
namespace mlp {

constexpr int NW = 8;             // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int BN = 64;            // hidden columns per chunk
constexpr int BK1 = 64;           // W1 rows (K) per fc1 slice
constexpr int BK2 = 16;           // W2 rows (hidden) per fc2 slice
constexpr int NK2 = BN / BK2;     // fc2 slices per chunk
constexpr int HST = BN + 8;       // h tile and W1 slice row stride

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): 0.5 x (1 + tanh(sqrt(2/pi)(x + 0.044715 x^3)))
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f *
                                 (x + 0.044715f * (x * x * x))));
}

// MT row tiles of 16; NTW >= K / 64, the 8-column output tiles per warp
template <int MT, int NTW>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ w2, bf16* __restrict__ out, int M,
                 int K, int N) {
  constexpr int R = MT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XST = K + 8;                // x tile and W2 slice row stride
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* W1s = Xs + R * XST;             // 2 x (BK1 x HST)
  bf16* W2s = W1s + 2 * BK1 * HST;      // 2 x (BK2 x XST)
  bf16* Hs = W2s + 2 * BK2 * XST;       // R x HST

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * R;
  const int kv = K / 8;                 // 16-byte vectors per row of K
  const int nk1 = K / BK1;
  const int per_chunk = nk1 + NK2;
  const int stages = (N / BN) * per_chunk;
  const int nt = K / 64;                // output tiles of 8 per warp
  const int wcol = warp * (K / 8);      // this warp's first output column

  // the x tile, zero past M (those rows are never stored)
  for (int i = tid; i < R * kv; i += NTHREADS) {
    const int r = i / kv, c = i % kv;
    const bool ok = m0 + r < M;
    cp_async_16(Xs + r * XST + c * 8,
                ok ? x + (size_t)(m0 + r) * K + c * 8 : x, ok);
  }

  auto issue = [&](int s) {
    const int chunk = s / per_chunk, j = s % per_chunk;
    if (j < nk1) {                      // W1[j*64 .. +64, chunk*64 .. +64]
      bf16* dst = W1s + (j & 1) * BK1 * HST;
      const bf16* src = w1 + (size_t)j * BK1 * N + chunk * BN;
      for (int i = tid; i < BK1 * (BN / 8); i += NTHREADS) {
        const int r = i / (BN / 8), c = i % (BN / 8);
        cp_async_16(dst + r * HST + c * 8, src + (size_t)r * N + c * 8, true);
      }
    } else {                            // W2[chunk*64 + q*16 .. +16, :]
      const int q = j - nk1;
      bf16* dst = W2s + (q & 1) * BK2 * XST;
      const bf16* src = w2 + (size_t)(chunk * BN + q * BK2) * K;
      for (int i = tid; i < BK2 * kv; i += NTHREADS) {
        const int r = i / kv, c = i % kv;
        cp_async_16(dst + r * XST + c * 8, src + (size_t)r * K + c * 8, true);
      }
    }
  };

  float acc1[MT][4];                    // fc1: 8 hidden columns of the chunk
  float acc2[MT][NTW][4];               // fc2: all K / 8 output columns
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[mt][n][e] = 0.f;

  issue(0);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // stage s (and the x tile) landed
    __syncthreads();
    const int j = s % per_chunk;
    if (j < nk1) {
      if (j == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[mt][e] = 0.f;
      }
      const bf16* wb = W1s + (j & 1) * BK1 * HST;
#pragma unroll
      for (int ks = 0; ks < BK1 / 16; ++ks) {
        uint32_t bfr[2];
        ldmatrix_x2_trans(bfr, wb + (ks * 16 + (lane & 15)) * HST + warp * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, Xs + (mt * 16 + (lane & 15)) * XST + j * BK1 +
                             ks * 16 + (lane >> 4) * 8);
          mma_bf16(acc1[mt], a, bfr[0], bfr[1]);
        }
      }
      if (j == nk1 - 1) {               // the chunk's h: GELU, bf16, shared
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          bf16* hr = Hs + (mt * 16 + g) * HST + warp * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(hr) =
              pack_bf16(gelu_tanh(acc1[mt][0]), gelu_tanh(acc1[mt][1]));
          *reinterpret_cast<uint32_t*>(hr + 8 * HST) =
              pack_bf16(gelu_tanh(acc1[mt][2]), gelu_tanh(acc1[mt][3]));
        }
      }
    } else {
      const int q = j - nk1;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], Hs + (mt * 16 + (lane & 15)) * HST + q * BK2 +
                               (lane >> 4) * 8);
      const bf16* row = W2s + (q & 1) * BK2 * XST + (lane & 15) * XST + wcol;
#pragma unroll
      for (int n = 0; n < NTW; n += 2) {
        uint32_t r[4];
        if (n + 1 < nt) {
          ldmatrix_x4_trans(r, row + n * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc2[mt][n], a[mt], r[0], r[1]);
            mma_bf16(acc2[mt][n + 1], a[mt], r[2], r[3]);
          }
        } else if (n < nt) {
          ldmatrix_x2_trans(r, row + n * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(acc2[mt][n], a[mt], r[0], r[1]);
        }
      }
    }
    __syncthreads();                    // stage s's buffer is free again
  }
  cp_async_wait<0>();

  // out = bf16(y) + x, rounded as a bf16 add
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (m0 + r >= M) continue;
      bf16* orow = out + (size_t)(m0 + r) * K + wcol + 2 * t;
      const bf16* xrow = Xs + r * XST + wcol + 2 * t;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        if (n < nt) {
          const float2 xv =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(xrow + n * 8));
          const float2 yv = unpack_bf16(pack_bf16(acc2[mt][n][2 * half],
                                                  acc2[mt][n][2 * half + 1]));
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(yv.x + xv.x, yv.y + xv.y);
        }
      }
    }
  }
}

template <int MT, int NTW>
inline cudaError_t launch(const bf16* x, const bf16* w1, const bf16* w2,
                          bf16* out, int M, int K, int N, cudaStream_t s) {
  constexpr int R = MT * 16;
  const int XST = K + 8;
  const size_t smem =
      sizeof(bf16) * (size_t)(R * XST + 2 * BK1 * HST + 2 * BK2 * XST + R * HST);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_kernel<MT, NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  fused_mlp_kernel<MT, NTW><<<(M + R - 1) / R, NTHREADS, smem, s>>>(
      x, w1, w2, out, M, K, N);
  return cudaGetLastError();
}

template <int MT>
inline cudaError_t launch_mt(const bf16* x, const bf16* w1, const bf16* w2,
                             bf16* out, int M, int K, int N, cudaStream_t s) {
  const int nt = K / 64;
  if (nt <= 2) return launch<MT, 2>(x, w1, w2, out, M, K, N, s);
  if (nt <= 8) return launch<MT, 8>(x, w1, w2, out, M, K, N, s);
  if (nt <= 22) return launch<MT, 22>(x, w1, w2, out, M, K, N, s);
  if (nt <= 24) return launch<MT, 24>(x, w1, w2, out, M, K, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace mlp
}  // namespace mico

// x (M, K), w1 (K, N), w2 (N, K), out (M, K): contiguous bf16; K a multiple
// of 64 up to 1536, N a multiple of 64; rows_per_block 16 or 32 (the
// wrapper checks).
extern "C" int mico_fused_mlp(const void* x, const void* w1, const void* w2,
                              void* out, int M, int K, int N,
                              int rows_per_block, void* stream) {
  using mico::bf16;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block == 16)
    return mico::mlp::launch_mt<1>(xp, w1p, w2p, op, M, K, N, s);
  if (rows_per_block == 32)
    return mico::mlp::launch_mt<2>(xp, w1p, w2p, op, M, K, N, s);
  return cudaErrorInvalidValue;
}
