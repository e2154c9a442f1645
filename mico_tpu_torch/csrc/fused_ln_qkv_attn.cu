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
// behind one C entry instead:
//   (a) ln_stats: one warp per row takes fp32 mean and rstd (two passes over
//       the row held in registers), 8 bytes per row to global memory;
//   (b) ln_gemm: 128x128 output tiles, BK = 32, two-stage pipeline. W tiles
//       arrive by cp.async; x tiles are loaded to registers one step ahead,
//       normalised (and affine-transformed) in fp32 and rounded to bf16 on
//       their way into shared memory, so the normalised tensor never exists
//       in global memory. 8 warps of 64x32 each run mma.sync m16n8k16 with
//       fp32 accumulators; the bias is added in fp32 in the epilogue. The
//       grid walks the column tiles fastest so the 33 blocks sharing a row
//       tile read x from L2 and W stays L2-resident (11.9 MB of 50 MB).
//   (c) packed_attn (packed_attn.cuh, shared with K3): grid (q-tiles of 96
//       rows, H, B), 6 warps of 16 query rows; q/k/v of one head are read by
//       column offset from the packed qkv rows (row stride 3W, no
//       transposes), K and V staged in shared memory, two passes over
//       16-key blocks (exact row maximum, then exp2 and the PV product).
// wgmma, TMA and warp specialisation are left to later work.

#include "common.cuh"
#include "packed_attn.cuh"

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

// ------------------------------------------------------------ (b) LN GEMM
constexpr int GM = 128, GN = 128, GK = 32, GT = 256;
constexpr int AST = GK + 8;   // A tile row stride (bf16): conflict-free ldmatrix
constexpr int BST = GN + 8;   // B tile row stride

__global__ void __launch_bounds__(GT, 2)
ln_gemm_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
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

}  // namespace

// x (B*L, W) bf16; gamma/beta (W) fp32 (read when affine); w (W, 3W) bf16;
// bias (3W) fp32; stats (B*L, 2) fp32 and qkv (B*L, 3W) bf16 are scratch;
// out (B, L, W) bf16. Needs W % 32 == 0, 3W % 128 == 0, W <= 2048,
// D = W / H a multiple of 8 up to 128 (the wrapper checks).
extern "C" int mico_fused_ln_qkv_attn(const void* x, const void* gamma,
                                      const void* beta, const void* w,
                                      const void* bias, void* stats, void* qkv,
                                      void* out, int B, int L, int W, int H,
                                      float eps, int affine, float qk_scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, N = 3 * W, D = W / H;
  ln_stats_kernel<<<(M + ST_ROWS - 1) / ST_ROWS, ST_ROWS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(stats), M, W, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 ggrid(N / GN, (M + GM - 1) / GM);
  ln_gemm_kernel<<<ggrid, GT, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(qkv), M, W, N, affine);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(qkv);
  return mico::packed::launch_attn(q, q + W, q + 2 * W, N,
                                   static_cast<bf16*>(out), B, L, H, D,
                                   qk_scale, s);
}
