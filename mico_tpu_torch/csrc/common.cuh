// Shared device helpers for the port's Hopper kernels: warp-level bf16
// tensor-core products (mma.sync m16n8k16, fp32 accumulate), ldmatrix
// fragment loads from shared memory, and cp.async copies with zero fill.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                         a3 (g+8, 2t+8..)
//   B (16x8, "col"):      b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8):             c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mico {

typedef __nv_bfloat16 bf16;

// finite "-inf" (flash_attention.py _NEG_BIG): exp2(NEG_BIG - m) is 0 and a
// fully masked row never computes -inf minus -inf
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a . b  (bf16 inputs, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; when !pred the destination is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool pred) {
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (lo in the low half), RN rounding
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Tile products over bf16 operands staged in shared memory with row stride
// KST = KS * 16 + 8 (DP = KS * 16 columns, zero-padded past D; the +8
// makes ldmatrix conflict-free). K6b's.

// A fragments of the 16 rows r0.. of X (all DP columns)
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&f)[KS][4], const bf16* X,
                                       int lane, int r0) {
  constexpr int KST = KS * 16 + 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(f[ks], X + (r0 + (lane & 15)) * KST + ks * 16 + (lane >> 4) * 8);
}

// c (16 x 16) = A (16 x DP) . X[n0 .. n0 + 15, :]^T
template <int KS>
__device__ __forceinline__ void mma_abt(float (&c)[2][4],
                                        const uint32_t (&a)[KS][4],
                                        const bf16* X, int lane, int n0) {
  constexpr int KST = KS * 16 + 8;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t r[4];
    ldmatrix_x4(r, X + (n0 + (lane & 7) + ((lane >> 4) << 3)) * KST + ks * 16 +
                       ((lane >> 3) & 1) * 8);
    mma_bf16(c[0], a[ks], r[0], r[1]);
    mma_bf16(c[1], a[ks], r[2], r[3]);
  }
}

// acc (16 x D, NT tiles of 8) += pa (16 x 16) . X[k0 .. k0 + 15, 0 .. D)
template <int KS>
__device__ __forceinline__ void mma_ab(float (&acc)[2 * KS][4],
                                       const uint32_t (&pa)[4], const bf16* X,
                                       int lane, int k0, int NT) {
  constexpr int KST = KS * 16 + 8;
  const bf16* row = X + (k0 + (lane & 15)) * KST;
#pragma unroll
  for (int n = 0; n < 2 * KS; n += 2) {
    uint32_t r[4];
    if (n + 1 < NT) {
      ldmatrix_x4_trans(r, row + n * 8 + (lane >> 4) * 8);
      mma_bf16(acc[n], pa, r[0], r[1]);
      mma_bf16(acc[n + 1], pa, r[2], r[3]);
    } else if (n < NT) {
      ldmatrix_x2_trans(r, row + n * 8);
      mma_bf16(acc[n], pa, r[0], r[1]);
    }
  }
}

// the accumulator layout of two 8-column tiles == the A fragment of one
// k16 step; rounds to bf16 (RN)
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&s)[2][4]) {
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

}  // namespace mico
