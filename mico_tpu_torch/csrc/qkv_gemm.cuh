// The tiled bf16 GEMM of K1 (fused_ln_qkv_attn.cu) with its LayerNorm
// prologue: out = LN(A) . W + bias, A (M, K) and W (K, N) bf16 row-major,
// bias (N) fp32, out (M, N) bf16. (K5 and K8 left it for the wgmma + TMA
// GEMM of wgmma_gemm.cuh; this header now serves K1 alone, its code as
// before.)
//
// 128x128 output tiles, BK = 32, a two-stage pipeline, 8 warps of 64x32
// running mma.sync m16n8k16 with fp32 accumulators; the bias is added in
// fp32 in the epilogue and each output rounded once to bf16. W tiles arrive
// by cp.async. A tiles are loaded to registers one step ahead, normalised
// with the per-row (mean, rstd) from `stats` (and the affine when `affine`)
// in fp32 and rounded to bf16 on their way into shared memory, so the
// normalised tensor never exists in global memory.
// The grid walks the column tiles fastest, so the blocks that share a row
// tile read A from L2 and W stays L2-resident.
//
// Needs K % 32 == 0 and N % 128 == 0; rows past M are masked.
#pragma once

#include "common.cuh"

namespace mico {
namespace gemm {

constexpr int GM = 128, GN = 128, GK = 32, GT = 256;
constexpr int AST = GK + 8;   // A tile row stride (bf16): conflict-free ldmatrix
constexpr int BST = GN + 8;   // B tile row stride

__global__ void __launch_bounds__(GT, 2)
tile_gemm_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
                 const float* __restrict__ gam, const float* __restrict__ bet,
                 const bf16* __restrict__ w, const float* __restrict__ bias,
                 bf16* __restrict__ out, int M, int K, int N, int affine) {
  __shared__ __align__(16) bf16 As[2][GM * AST];
  __shared__ __align__(16) bf16 Bs[2][GK * BST];
  __shared__ float2 s_stats[GM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: rows wm*64, cols wn*32

  for (int r = tid; r < GM; r += GT)
    s_stats[r] = (m0 + r < M) ? stats[m0 + r] : make_float2(0.f, 0.f);

  uint4 xr[2];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GT, r = v >> 2, cv = v & 3;
      const int row = m0 + r;
      xr[i] = row < M ? *reinterpret_cast<const uint4*>(
                            x + (size_t)row * K + kt * GK + cv * 8)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_a = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GT, r = v >> 2, cv = v & 3;
      const float2 st = s_stats[r];
      const int k0 = kt * GK + cv * 8;
      const uint32_t in[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16(in[j]);
        float a = (f.x - st.x) * st.y, b = (f.y - st.x) * st.y;
        if (affine) {
          a = a * gam[k0 + 2 * j] + bet[k0 + 2 * j];
          b = b * gam[k0 + 2 * j + 1] + bet[k0 + 2 * j + 1];
        }
        o[j] = pack_bf16(a, b);
      }
      *reinterpret_cast<uint4*>(&As[buf][r * AST + cv * 8]) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  };
  auto load_b = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GT, r = v >> 4, cv = v & 15;
      cp_async_16(&Bs[buf][r * BST + cv * 8],
                  w + (size_t)(kt * GK + r) * N + n0 + cv * 8, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = K / GK;
  load_x(0);
  load_b(0, 0);
  cp_async_commit();
  __syncthreads();   // s_stats visible
  store_a(0, 0);
  cp_async_wait<0>();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_b(kt + 1, buf ^ 1);
      cp_async_commit();
      load_x(kt + 1);
    }
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &As[buf][(wm * 64 + i * 16 + (lane & 15)) * AST +
                                   ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[buf][(ks * 16 + (lane & 15)) * BST +
                                      wn * 32 + j * 16 + (lane >> 4) * 8]);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (kt + 1 < nk) {
      store_a(kt + 1, buf ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            pack_bf16(acc[i][j][0] + b0, acc[i][j][1] + b1);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * N + col) =
            pack_bf16(acc[i][j][2] + b0, acc[i][j][3] + b1);
    }
  }
}

// out (M, N) = LN(A) (M, K) . w (K, N) + bias: stats (M) of (mean, rstd);
// gam/bet (K) read when affine.
inline cudaError_t launch_gemm(const bf16* x, const float2* stats,
                               const float* gam, const float* bet,
                               const bf16* w, const float* bias, bf16* out,
                               int M, int K, int N, int affine,
                               cudaStream_t s) {
  dim3 grid(N / GN, (M + GM - 1) / GM);
  tile_gemm_kernel<<<grid, GT, 0, s>>>(x, stats, gam, bet, w, bias, out,
                                           M, K, N, affine);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace mico
