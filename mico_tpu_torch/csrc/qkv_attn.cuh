// The packed self-attention of K1, K3, K5 and K8 on Hopper: per batch row b
// and head h, q/k/v of the head read by column offset h*D from rows of three
// base pointers that share one row stride `ld` (3W for the column slices of
// a fused (B*L, 3W) qkv, W for three (B, L, W) tensors), and
//   s   = q_h k_h^T in fp32, times scale * log2e
//   p   = exp2(s - rowmax(s)) in fp32 against the exact full-row maximum
//   o_h = (bf16(p) v_h, fp32 accumulate) / rowsum(p), the sum over fp32 p
// written packed as (B, L, H*D) bf16: `_packed_body`'s rounding points
// (mico_tpu/ops/flash_attention.py:757), as `_fused_qkv_attn_kernel`
// (:1229) and `_fused_ln_qkv_attn_kernel` (:1567) compute them on their
// local qkv.
//
// What bounds it on the H100: tensor-core operations at bigE's pass (4 B H
// L^2 D = 53.0 GFLOP, 0.054 ms at 989 TFLOP/s, against 0.037 ms for q/k/v
// in and o out at 3.35 TB/s); bytes at ViT-g's train pass (K3, qkv (32,
// 257, 4224): 92.8 MB, 0.028 ms, against 11.9 GFLOP, 0.012 ms).
//
// Design. One block per (b, h): at L <= 272, K and V of the head are staged
// in shared memory once (one 4-D tensor map an operand over (D, H, L, B),
// rows `ld` apart: TMA fills rows past L and columns past D with zeros, so
// no copy reads another head or batch row), Q in tiles of 64 query rows,
// one tile per consumer warpgroup at a time. Two consumer warpgroups and a
// producer warpgroup (setmaxnreg moves registers to the consumers: 232 a
// thread, 40 for the producer):
//  - the producer issues both warpgroups' first Q tiles, then K, then V (K
//    and V on their own mbarriers, so QK^T starts while V is in flight), and
//    refills a warpgroup's Q buffer as soon as that warpgroup's QK^T has
//    retired;
//  - a consumer runs S = Q K^T with wgmma (Q and K from shared memory, both
//    K-major) over a key block of 272 keys (n256 + n16), keeping the whole
//    score row in registers (136 a thread), so QK^T runs once and the exact
//    row maximum comes from registers; p is rounded to bf16 into registers
//    in wgmma's A layout and O += P V runs as wgmma with A from registers
//    and V from shared memory (MN-major, N = 64 or 128 columns of D). Keys
//    past L are masked with the finite -1e30, so their p is 0. Each product
//    runs every k16 step of its 64-column chunks (the zero columns past D
//    included): a straight run of wgmmas, which ptxas does not serialise;
//  - o / l goes through a staging tile in shared memory to TMA stores,
//    which clip at L and D; the division is a reciprocal product with one
//    FMA correction (a full-precision division a value cost a quarter of
//    the kernel's time);
//  - past 272 keys (any L) the row takes several key blocks, streamed
//    through the same K and V buffers: for each round of two Q tiles a
//    first pass over K takes the row maximum, a second recomputes each
//    block's scores and exponentiates against it while V streams beside;
//    each fill waits until both warpgroups have released the last.
// D: any multiple of 8 up to 128, in 64-column chunks with the 128-byte
// swizzle. L = 257 takes 5 query tiles (the last holds one row), so the
// first warpgroup runs three and the second two.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace mico {
namespace qattn {

constexpr int KB = 272;           // keys a key block: 256 + 16
constexpr int KBOX = KB / 2;      // K/V rows a TMA box
constexpr int QROWS = 64;         // query rows a warpgroup tile
constexpr int THREADS = 384;      // 2 consumer warpgroups + a producer one
constexpr int CHUNK = 64 * 128;   // a 64-row tile of one 64-column chunk

// shared memory of a launch (the wrappers mirror it: ops/flash_attention.py
// `_qkv_attn_smem_bytes`)
inline size_t smem_bytes(int D) {
  const int nt = (D + 63) / 64;
  return (size_t)2 * nt * KB * 128 + (size_t)4 * nt * CHUNK + 8 * 8 + 1024;
}

// scores of one key block: s (256 keys) and st (16 tail keys), scaled after
// the product and masked past L, ready once the wgmmas have retired
template <int NT>
__device__ __forceinline__ void block_scores(float (&s)[128], float (&st)[8],
                                             const unsigned char* qs,
                                             const unsigned char* ks,
                                             int kch, int k0, int L,
                                             float qk_scale, int lane) {
  hop::fence_regs(s);
  hop::fence_regs(st);
  hop::wgmma_fence();
  // every k16 step of the NT chunks: columns past D are zeros in shared
  // memory, and a straight run of wgmmas keeps ptxas from serialising them
#pragma unroll
  for (int kk = 0; kk < 4 * NT; ++kk) {
    const int off = (kk >> 2) * CHUNK, col = (kk & 3) * 32;
    hop::wgmma_ss_n256<0>(
        s, hop::desc_sw128(qs + off + col, 16, 1024),
        hop::desc_sw128(ks + (kk >> 2) * kch + k0 * 128 + col, 16, 1024),
        kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4 * NT; ++kk) {
    const int off = (kk >> 2) * CHUNK, col = (kk & 3) * 32;
    hop::wgmma_ss_n16<0>(
        st, hop::desc_sw128(qs + off + col, 16, 1024),
        hop::desc_sw128(ks + (kk >> 2) * kch + (k0 + 256) * 128 + col, 16,
                        1024),
        kk > 0);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(s);
  hop::fence_regs(st);
  const int q2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int key = k0 + 8 * (i >> 2) + q2 + (i & 1);
    s[i] = key < L ? s[i] * qk_scale : NEG_BIG;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 256 + 8 * (i >> 2) + q2 + (i & 1);
    st[i] = key < L ? st[i] * qk_scale : NEG_BIG;
  }
}

// x / l from r = 1 / l (both rounded to nearest) and one FMA correction of
// the product's residual: the quotient of fp32 division to within its last
// bit, without a division's instruction sequence a value
__device__ __forceinline__ float div_by(float x, float l, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, l, x), r, q);
}

// this thread's maxima of rows r0 (even register pairs) and r0 + 8
__device__ __forceinline__ void block_max(const float (&s)[128],
                                          const float (&st)[8], float& m0,
                                          float& m1) {
#pragma unroll
  for (int i = 0; i < 128; i += 4) {
    m0 = fmaxf(m0, fmaxf(s[i], s[i + 1]));
    m1 = fmaxf(m1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int i = 0; i < 8; i += 4) {
    m0 = fmaxf(m0, fmaxf(st[i], st[i + 1]));
    m1 = fmaxf(m1, fmaxf(st[i + 2], st[i + 3]));
  }
}

// p = exp2(s - m) in fp32, the row sums l over fp32 p, and bf16 p in
// wgmma's A layout (chunk by chunk, so that s dies as p is made); then
// O += P V over the block's 17 steps of 16 keys (p is 0 past L)
template <int NT>
__device__ __forceinline__ void block_pv(float (&s)[128], float (&st)[8],
                                         float (&o)[NT * 32],
                                         const unsigned char* vs, int kch,
                                         int k0, float m0, float m1,
                                         float& l0, float& l1) {
  uint32_t pa[16][4], pt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 32 * c; i < 32 * c + 32; i += 4) {
      s[i] = fast_exp2(s[i] - m0);
      s[i + 1] = fast_exp2(s[i + 1] - m0);
      s[i + 2] = fast_exp2(s[i + 2] - m1);
      s[i + 3] = fast_exp2(s[i + 3] - m1);
      l0 += s[i] + s[i + 1];
      l1 += s[i + 2] + s[i + 3];
    }
#pragma unroll
    for (int k = 4 * c; k < 4 * c + 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[k][e] = pack_bf16(s[8 * k + 2 * e], s[8 * k + 2 * e + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; i += 4) {
    st[i] = fast_exp2(st[i] - m0);
    st[i + 1] = fast_exp2(st[i + 1] - m0);
    st[i + 2] = fast_exp2(st[i + 2] - m1);
    st[i + 3] = fast_exp2(st[i + 3] - m1);
    l0 += st[i] + st[i + 1];
    l1 += st[i + 2] + st[i + 3];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) pt[e] = pack_bf16(st[2 * e], st[2 * e + 1]);
  hop::fence_regs(o);
  hop::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 17; ++k) {
    const uint64_t dv = hop::desc_sw128(vs + (k0 + 16 * k) * 128, kch, 1024);
    const uint32_t(&a)[4] = k < 16 ? pa[k < 16 ? k : 0] : pt;
    if constexpr (NT == 2)
      hop::wgmma_rs_n128(o, a, dv);
    else
      hop::wgmma_rs_n64(o, a, dv);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(o);
}

// STREAM: the rows past one key block (L > 272), a kernel of its own so
// that its longer-lived registers do not make ptxas serialise the wgmmas of
// the resident path
template <int NT, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
qkv_attn_kernel(const __grid_constant__ CUtensorMap tma_q,
                const __grid_constant__ CUtensorMap tma_k,
                const __grid_constant__ CUtensorMap tma_v,
                const __grid_constant__ CUtensorMap tma_o, int L, int H,
                float qk_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  constexpr int kch = KB * 128;              // bytes of a 64-column chunk
  unsigned char* ks = smem;                  // [chunk] one key block of K
  unsigned char* vs = ks + NT * kch;         // ... and of V
  unsigned char* qs = vs + NT * kch;         // [warpgroup][chunk] Q tiles
  unsigned char* os = qs + 2 * NT * CHUNK;   // output staging, the same
  uint64_t* bars = reinterpret_cast<uint64_t*>(os + 2 * NT * CHUNK);
  uint64_t* kfull = bars;
  uint64_t* vfull = bars + 1;
  uint64_t* qfull = bars + 2;                // [2]
  uint64_t* qempty = bars + 4;               // [2]
  uint64_t* kempty = bars + 6;               // streamed blocks only
  uint64_t* vempty = bars + 7;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nkb = (L + KB - 1) / KB;
  const int nqt = (L + QROWS - 1) / QROWS;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(kfull, 1);
    hop::mbar_init(vfull, 1);
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&qfull[i], 1);
      hop::mbar_init(&qempty[i], 1);
    }
    hop::mbar_init(kempty, 2);
    hop::mbar_init(vempty, 2);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    hop::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tma_q);
      hop::prefetch_map(&tma_k);
      hop::prefetch_map(&tma_v);
      auto load_q = [&](int qt) {
        const int w = qt & 1, n = qt >> 1;
        if (n > 0) hop::mbar_wait(&qempty[w], (n - 1) & 1);
        hop::mbar_expect_tx(&qfull[w], NT * CHUNK);
        for (int c = 0; c < NT; ++c)
          hop::tma_load_4d(qs + (w * NT + c) * CHUNK, &tma_q, &qfull[w],
                           64 * c, h, qt * QROWS, b);
      };
      // key block kb of K or V (`map`) into its buffer
      auto load_block = [&](unsigned char* dst, uint64_t* bar,
                            const CUtensorMap* map, int kb) {
        hop::mbar_expect_tx(bar, NT * kch);
        for (int c = 0; c < NT; ++c)
          for (int r = 0; r < KB; r += KBOX)
            hop::tma_load_4d(dst + c * kch + r * 128, map, bar, 64 * c, h,
                             kb * KB + r, b);
      };
      if constexpr (!STREAM) {
        load_q(0);
        if (nqt > 1) load_q(1);
        load_block(ks, kfull, &tma_k, 0);
        load_block(vs, vfull, &tma_v, 0);
        for (int qt = 2; qt < nqt; ++qt) load_q(qt);
      } else {
        // each round of two Q tiles streams K twice (the maximum, then the
        // scores again) and V once, a block at a time, each fill once both
        // warpgroups have released the last
        int kf = 0, vf = 0;
        for (int qt = 0; qt < nqt; qt += 2) {
          load_q(qt);
          if (qt + 1 < nqt) load_q(qt + 1);
          for (int pass = 0; pass < 2; ++pass)
            for (int kb = 0; kb < nkb; ++kb) {
              if (kf > 0) hop::mbar_wait(kempty, (kf - 1) & 1);
              load_block(ks, kfull, &tma_k, kb);
              ++kf;
              if (pass == 1) {
                if (vf > 0) hop::mbar_wait(vempty, (vf - 1) & 1);
                load_block(vs, vfull, &tma_v, kb);
                ++vf;
              }
            }
        }
      }
    }
    return;
  }

  hop::setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const unsigned char* qw = qs + wgi * NT * CHUNK;
  float s[128], st[8], o[NT * 32];

  // o / l rounded to bf16 into this warpgroup's staging tile (128-byte
  // swizzle, conflict-free), then TMA stores that clip at L and D
  auto store = [&](int qt, float l0, float l1) {
    unsigned char* ow = os + wgi * NT * CHUNK;
    if (tid == 0) hop::bulk_wait_read<0>();   // the last tile's stores
    hop::named_sync(1 + wgi, 128);
    const int rl = warp * 16 + (lane >> 2);
    const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < NT * 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(ow + hop::sw128_offset(rl, col, CHUNK)) =
          pack_bf16(div_by(o[4 * j], l0, r0), div_by(o[4 * j + 1], l0, r0));
      *reinterpret_cast<uint32_t*>(ow + hop::sw128_offset(rl + 8, col, CHUNK)) =
          pack_bf16(div_by(o[4 * j + 2], l1, r1), div_by(o[4 * j + 3], l1, r1));
    }
    hop::fence_proxy_async();
    hop::named_sync(1 + wgi, 128);
    if (tid == 0) {
      for (int c = 0; c < NT; ++c)
        hop::tma_store_4d(&tma_o, ow + c * CHUNK, 64 * c, h, qt * QROWS, b);
      hop::bulk_commit();
    }
  };

  if constexpr (!STREAM) {
    // the whole row in registers: QK^T once, the maximum from registers
    hop::mbar_wait(kfull, 0);
    int n = 0;
    for (int qt = wgi; qt < nqt; qt += 2, ++n) {
      hop::mbar_wait(&qfull[wgi], n & 1);
      block_scores<NT>(s, st, qw, ks, kch, 0, L, qk_scale, lane);
      if (tid == 0) hop::mbar_arrive(&qempty[wgi]);
      float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
      block_max(s, st, m0, m1);
      m0 = quad_max(m0);
      m1 = quad_max(m1);
#pragma unroll
      for (int i = 0; i < NT * 32; ++i) o[i] = 0.f;
      hop::mbar_wait(vfull, 0);
      block_pv<NT>(s, st, o, vs, kch, 0, m0, m1, l0, l1);
      store(qt, quad_sum(l0), quad_sum(l1));
    }
  } else {
    // streamed key blocks: a first pass takes the row maximum, a second
    // recomputes each block's scores and exponentiates against it. A
    // warpgroup with no tile in the last round still takes each fill in
    // turn and releases it. The block buffers are addressed by key (less
    // the block's first key), as the resident path's are.
    int kn = 0, vn = 0;
    for (int r = 0; 2 * r < nqt; ++r) {
      const int qt = 2 * r + wgi;
      const bool act = qt < nqt;
      if (act) hop::mbar_wait(&qfull[wgi], r & 1);
      float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++kn) {
        hop::mbar_wait(kfull, kn & 1);
        if (act) {
          block_scores<NT>(s, st, qw, ks - kb * KB * 128, kch, kb * KB, L,
                           qk_scale, lane);
          block_max(s, st, m0, m1);
        }
        if (tid == 0) hop::mbar_arrive(kempty);
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
#pragma unroll
      for (int i = 0; i < NT * 32; ++i) o[i] = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++kn, ++vn) {
        hop::mbar_wait(kfull, kn & 1);
        if (act)
          block_scores<NT>(s, st, qw, ks - kb * KB * 128, kch, kb * KB, L,
                           qk_scale, lane);
        if (tid == 0) hop::mbar_arrive(kempty);
        hop::mbar_wait(vfull, vn & 1);
        if (act)
          block_pv<NT>(s, st, o, vs - kb * KB * 128, kch, kb * KB, m0, m1,
                       l0, l1);
        if (tid == 0) hop::mbar_arrive(vempty);
      }
      if (act) {
        if (tid == 0) hop::mbar_arrive(&qempty[wgi]);
        store(qt, quad_sum(l0), quad_sum(l1));
      }
    }
  }
  if (tid == 0) hop::bulk_wait<0>();
}

// q, k, v: the head-0 columns of batch row 0 of three bf16 operands whose
// rows lie `ld` elements apart (batch rows L * ld apart; for a fused qkv
// (B*L, 3W): qkv, qkv + W, qkv + 2W with ld = 3W); out (B, L, H*D). D a
// multiple of 8 up to 128, ld a multiple of 8 and the pointers 16-byte
// aligned (TMA's strides and addresses; the wrappers check); any L.
inline cudaError_t launch_attn(const bf16* q, const bf16* k, const bf16* v,
                               int ld, bf16* out, int B, int L, int H, int D,
                               float qk_scale, cudaStream_t stream) {
  if (D % 8 || D > 128 || D <= 0 || L <= 0 || ld % 8)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * 2 * L};
  const cuuint32_t qbox[4] = {64, 1, QROWS, 1};
  const cuuint32_t kvbox[4] = {64, 1, KBOX, 1};
  const cuuint64_t ostrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)2 * H * D,
                                  (cuuint64_t)2 * H * D * L};
  CUtensorMap tq, tk, tv, to;
  cudaError_t e = hop::make_map(&tq, q, 4, dims, strides, qbox);
  if (e != cudaSuccess) return e;
  e = hop::make_map(&tk, k, 4, dims, strides, kvbox);
  if (e != cudaSuccess) return e;
  e = hop::make_map(&tv, v, 4, dims, strides, kvbox);
  if (e != cudaSuccess) return e;
  e = hop::make_map(&to, out, 4, dims, ostrides, qbox);
  if (e != cudaSuccess) return e;
  int dev;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(D);
  const dim3 grid(B * H);
  const bool stream_kv = L > KB;
  if (D > 64 && stream_kv) {
    e = hop::smem_opt_in<2>((const void*)qkv_attn_kernel<2, true>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<2, true><<<grid, THREADS, smem, stream>>>(
        tq, tk, tv, to, L, H, qk_scale);
  } else if (D > 64) {
    e = hop::smem_opt_in<3>((const void*)qkv_attn_kernel<2, false>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<2, false><<<grid, THREADS, smem, stream>>>(
        tq, tk, tv, to, L, H, qk_scale);
  } else if (stream_kv) {
    e = hop::smem_opt_in<4>((const void*)qkv_attn_kernel<1, true>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<1, true><<<grid, THREADS, smem, stream>>>(
        tq, tk, tv, to, L, H, qk_scale);
  } else {
    e = hop::smem_opt_in<5>((const void*)qkv_attn_kernel<1, false>, dev);
    if (e != cudaSuccess) return e;
    qkv_attn_kernel<1, false><<<grid, THREADS, smem, stream>>>(
        tq, tk, tv, to, L, H, qk_scale);
  }
  return cudaGetLastError();
}

}  // namespace qattn
}  // namespace mico
