// K7: dequant-fused int8 cross-attention for the KV-cached decode.
//
// Replaces the TPU kernel `_int8_cross_call` (mico_tpu/ops/int8_attention.py
// :86, pallas_call at :97; public entry `int8_cross_attention` :150) and its
// body `_int8_cross_kernel` (:56). For each batch row b and head h, q (Lq, 64)
// bf16 attends over K and V stored as int8 (Lk, 64) with one fp32 scale per
// (row, head), at the body's rounding points:
//   k = bf16(float(k8) * ks),  s = (q . k) in fp32, times `scale`;
//   p = exp(s - max_row s) in fp32, l = the row sum of the unrounded p;
//   v = bf16(float(v8) * vs),  o = bf16(p) . v in fp32;  out = bf16(o / l).
//
// What bounds it on the H100: memory bytes. At the beam deployment shape (B
// 64, Lq 6 = 2 rows x 3 beams, Lk 2056, H 768) one call reads 202 MB of int8
// K/V and 12.6 MB of scales and does 2.4 GFLOP, 11 operations per byte, far
// below the 295 where the tensor cores would become the limit: its bound is
// 0.064 ms at 3.35 TB/s. The bf16 route (plain torch) reads twice the K/V.
//
// Design: one block per (h, b), 256 threads, and every int8 byte is read
// once. Decode has few query rows (Lq <= 16), so the products run on the CUDA
// cores in fp32 (a bf16 x bf16 product is exact in fp32, as in a tensor-core
// product with an fp32 sum), and the whole Lq x Lk fp32 score matrix stays in
// shared memory (6 x 2056 x 4 B = 49 KB at the beam shape): the row max is
// exact and the softmax is the body's full-row one, not an online one.
//   1. scores: 4 lanes per key row; each takes 16 of the row's 64 int8 values
//      with one 16-byte load (a warp covers 8 rows of 64 contiguous bytes),
//      dequantises them exactly (x + 128 put into the mantissa of 2^23), scales
//      and rounds them to bf16, and dots them with q, which sits in shared
//      memory as fp32; the 4 partial sums meet by shuffles. Each lane has 4
//      rows' loads in flight before it uses the first.
//   2. softmax: one warp per query row: max, exp, the sum of the unrounded p;
//      p goes back into shared memory rounded to bf16, as PV takes it.
//   3. PV: 8 lanes per key row, each 8 int8 values of V (one 8-byte load),
//      with Lq x 8 fp32 sums over the lane's keys; the warps' partial sums
//      meet in shared memory, are divided by l and written as bf16.
// The Pallas kernel groups 8 batch rows per grid step (_GROUP, :50-53) to pay
// down a TPU grid step's fixed cost; that has no meaning here. Splitting Lk
// across blocks for a small B (B * 12 < 132 SMs) is later speed work.

#include "common.cuh"

namespace {
using namespace mico;

constexpr int D = 64;                   // head dim (BERT-base: 768 / 12)
constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;
constexpr int QK_LANES = D / 16;        // lanes per key row, score pass
constexpr int QK_ROWS = NT / QK_LANES;  // key rows per sweep (64)
constexpr int PV_LANES = D / 8;         // lanes per key row, PV pass
constexpr int PV_ROWS = NT / PV_LANES;  // key rows per sweep (32)
constexpr int UNROLL = 4;               // key rows in flight per lane
constexpr int MAX_LQ = 16;

struct Int8Args {
  const bf16* q;
  const int8_t* k8;
  const float* ks;
  const int8_t* v8;
  const float* vs;
  bf16* o;
  int Lq, Lk, H, nh;
  float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// four int8 values in one word -> bf16(x * s) as floats. The byte x + 128 is
// placed in the low mantissa byte of 2^23, so the float is 2^23 + 128 + x and
// one subtraction recovers x exactly.
__device__ __forceinline__ void dequant4(uint32_t w, float s, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const float x0 =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
    const float x1 =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + i)) - 8388736.f;
    const float2 r = unpack_bf16(pack_bf16(x0 * s, x1 * s));
    out[i] = r.x;
    out[i + 1] = r.y;
  }
}

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// shared memory: q (Lq x D), the warps' PV sums (NW x Lq x D), the row sums
// (Lq, padded to 4) and the scores (Lq x Lk), all fp32
__host__ __device__ inline size_t smem_floats(int Lq, int Lk) {
  return (size_t)Lq * D * (1 + NW) + pad4(Lq) + (size_t)Lq * Lk;
}

template <int LQT>
__global__ void __launch_bounds__(NT) int8_cross_kernel(const Int8Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Lq = a.Lq, Lk = a.Lk;
  float* Qs = smem;
  float* part = Qs + Lq * D;
  float* rowl = part + NW * Lq * D;
  float* S = rowl + pad4(Lq);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)b * Lk;   // first K/V row of this b

  const bf16* qb = a.q + (long long)b * Lq * a.H + h * D;
  for (int i = tid; i < Lq * D; i += NT)
    Qs[i] = __bfloat162float(qb[(i / D) * a.H + i % D]);
  __syncthreads();

  // 1. scores
  {
    const int c = tid % QK_LANES, r0 = tid / QK_LANES;
    const int8_t* kb = a.k8 + row0 * a.H + h * D + c * 16;
    const float* ksb = a.ks + row0 * a.nh + h;
    for (int base = 0; base < Lk; base += QK_ROWS * UNROLL) {
      uint4 raw[UNROLL];
      float sc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * QK_ROWS + r0;
        if (j < Lk) {
          raw[u] = __ldg(reinterpret_cast<const uint4*>(kb + (long long)j * a.H));
          sc[u] = __ldg(ksb + (long long)j * a.nh);
        } else {
          raw[u] = make_uint4(0u, 0u, 0u, 0u);
          sc[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * QK_ROWS + r0;
        float kf[16];
        dequant4(raw[u].x, sc[u], kf);
        dequant4(raw[u].y, sc[u], kf + 4);
        dequant4(raw[u].z, sc[u], kf + 8);
        dequant4(raw[u].w, sc[u], kf + 12);
#pragma unroll
        for (int r = 0; r < LQT; ++r) {
          if (r < Lq) {   // uniform over the block
            const float4* qr =
                reinterpret_cast<const float4*>(Qs + r * D + c * 16);
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 qv = qr[e];
              acc = fmaf(qv.x, kf[4 * e], acc);
              acc = fmaf(qv.y, kf[4 * e + 1], acc);
              acc = fmaf(qv.z, kf[4 * e + 2], acc);
              acc = fmaf(qv.w, kf[4 * e + 3], acc);
            }
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            if (c == (r & (QK_LANES - 1)) && j < Lk)
              S[(long long)r * Lk + j] = acc * a.scale;
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. full-row softmax, one warp per query row
  for (int r = warp; r < Lq; r += NW) {
    float* Sr = S + (long long)r * Lk;
    float m = NEG_BIG;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, Sr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float p = expf(Sr[j] - m);
      l += p;
      Sr[j] = bf16_round(p);
    }
    l = warp_sum(l);
    if (lane == 0) rowl[r] = l;
  }
  __syncthreads();

  // 3. PV
  {
    const int c = tid % PV_LANES, r0 = tid / PV_LANES;
    const int8_t* vb = a.v8 + row0 * a.H + h * D + c * 8;
    const float* vsb = a.vs + row0 * a.nh + h;
    float acc[LQT][8];
#pragma unroll
    for (int r = 0; r < LQT; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
    for (int base = 0; base < Lk; base += PV_ROWS * UNROLL) {
      uint2 raw[UNROLL];
      float sc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * PV_ROWS + r0;
        if (j < Lk) {
          raw[u] = __ldg(reinterpret_cast<const uint2*>(vb + (long long)j * a.H));
          sc[u] = __ldg(vsb + (long long)j * a.nh);
        } else {
          raw[u] = make_uint2(0u, 0u);
          sc[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * PV_ROWS + r0;
        if (j < Lk) {
          float vf[8];
          dequant4(raw[u].x, sc[u], vf);
          dequant4(raw[u].y, sc[u], vf + 4);
#pragma unroll
          for (int r = 0; r < LQT; ++r) {
            if (r < Lq) {
              const float p = S[(long long)r * Lk + j];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
            }
          }
        }
      }
    }
    // the warp's 4 key rows (lanes 8 apart) meet by shuffles
#pragma unroll
    for (int r = 0; r < LQT; ++r) {
      if (r < Lq) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 8);
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
        }
        if (lane < PV_LANES) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part[(warp * Lq + r) * D + c * 8 + e] = acc[r][e];
        }
      }
    }
  }
  __syncthreads();

  bf16* ob = a.o + (long long)b * Lq * a.H + h * D;
  for (int i = tid; i < Lq * D; i += NT) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) o += part[(w * Lq + r) * D + d];
    ob[r * a.H + d] = __float2bfloat16_rn(o / rowl[r]);
  }
}

template <int LQT>
cudaError_t launch(const Int8Args& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_cross_kernel<LQT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int8_cross_kernel<LQT><<<dim3(a.nh, B), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q/o (B, Lq, H) bf16, k8/v8 (B, Lk, H) int8, ks/vs (B, Lk, nh) fp32, all
// contiguous, K/V rows 16-byte aligned; H = nh * 64, Lq <= 16, and the scores
// must fit shared memory (the wrapper checks all of it).
extern "C" int mico_int8_cross_attn(const void* q, const void* k8,
                                    const void* ks, const void* v8,
                                    const void* vs, void* o, int B, int Lq,
                                    int Lk, int H, int nh, float scale,
                                    void* stream) {
  if (H != nh * D || Lq < 1 || Lq > MAX_LQ || Lk < 1 || B < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Lq, Lk);
  if (smem > 232448) return cudaErrorInvalidValue;
  Int8Args a;
  a.q = static_cast<const bf16*>(q);
  a.k8 = static_cast<const int8_t*>(k8);
  a.ks = static_cast<const float*>(ks);
  a.v8 = static_cast<const int8_t*>(v8);
  a.vs = static_cast<const float*>(vs);
  a.o = static_cast<bf16*>(o);
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  a.nh = nh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 2) return launch<2>(a, B, smem, s);
  if (Lq <= 4) return launch<4>(a, B, smem, s);
  if (Lq <= 8) return launch<8>(a, B, smem, s);
  return launch<16>(a, B, smem, s);
}
