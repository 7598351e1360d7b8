// Shared device code of the attention kernels (flash_attention.cu: K1, K2;
// folded_attention.cu: K3, K4): the bf16 tensor-core tile (mma.sync
// m16n8k16) and the two online-softmax updates, the counterparts of
// _mha_online_update in cyclediffusion_tpu/ops/flash_attention.py.  Only
// K3/K4 still use the mma.sync helpers and online_update_tc; the bf16 path
// of K1/K2 runs on wgmma (hopper_attention.cuh), and their fp32 path uses
// online_update_f32.
//
// Every definition sits in an anonymous namespace, so each translation unit
// that includes this header gets its own internal copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // q rows per block
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update (fp32 path)

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// c += a (16x16, row-major A fragment) * b (16x8, "col" B fragment), fp32 sum
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct TcShape {
  static constexpr int Dp = (D + 15) / 16 * 16;  // head dim padded for k16 steps
  static constexpr int KS = Dp + 8;              // K tile row stride (bank spread)
  static constexpr int VS = kBlockK + 8;         // V^T tile row stride
};

// The counterpart of _mha_online_update for one warp's 16 q rows over one
// staged tile: s holds S = Q K^T for 64 keys in mma C-fragment layout (this
// thread: rows g and g+8, columns 8*nt + c, +1).  Masks keys >= n_valid,
// updates the running max m[2] and this thread's partial row sums l[2],
// rescales the accumulator o, and returns P (rounded to bf16, the same values
// that enter l) as the A fragments of P.V.
template <int D>
__device__ __forceinline__ void online_update_tc(float (&s)[8][4], int c,
                                                 int n_valid, float scale,
                                                 float (&m)[2], float (&l)[2],
                                                 float (&o)[TcShape<D>::Dp / 8][4],
                                                 uint32_t (&pa)[4][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + c + (e & 1);
      s[nt][e] = key < n_valid ? s[nt][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row's 64 columns are spread over the 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile has a real key
    alpha[r] = expf(m[r] - m_new);           // 0 on the first tile
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int dt = 0; dt < TcShape<D>::Dp / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    __nv_bfloat16 p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = __float2bfloat16(expf(s[nt][e] - m[e >> 1]));
      l[e >> 1] += __bfloat162float(p[e]);
    }
    // keys 16*kk + [0, 8) fill a0 (row g) / a1 (row g+8); keys 16*kk + [8, 16)
    // fill a2 / a3
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

// ---------------------------------------------------------------------------
// fp32: FP32 cores, one thread per q row
// ---------------------------------------------------------------------------

// The counterpart of _mha_online_update for one q row over keys
// [j0, j0 + kChunk) of the staged tile, of which the first n_valid are real.
template <int D>
__device__ __forceinline__ void online_update_f32(const float (&q)[D],
                                                  const float (*ks)[D],
                                                  const float (*vs)[D], int j0,
                                                  int n_valid, float scale,
                                                  float& m, float& l,
                                                  float (&acc)[D]) {
  float s[kChunk];
  float mx = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < kChunk; ++jj) {
    const float4* kr = reinterpret_cast<const float4*>(ks[j0 + jj]);
    float dot = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = kr[d4];
      dot = fmaf(q[4 * d4 + 0], kv.x, dot);
      dot = fmaf(q[4 * d4 + 1], kv.y, dot);
      dot = fmaf(q[4 * d4 + 2], kv.z, dot);
      dot = fmaf(q[4 * d4 + 3], kv.w, dot);
    }
    // scale the fp32 logit after the product, as the TPU kernels do
    s[jj] = (j0 + jj < n_valid) ? dot * scale : -INFINITY;
    mx = fmaxf(mx, s[jj]);
  }
  // the chunk holds at least one real key, so m_new is finite; on the first
  // chunk m is -inf and alpha is exactly 0
  const float m_new = fmaxf(m, mx);
  const float alpha = expf(m - m_new);
  l *= alpha;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
  for (int jj = 0; jj < kChunk; ++jj) {
    const float p = expf(s[jj] - m_new);
    l += p;
    const float4* vr = reinterpret_cast<const float4*>(vs[j0 + jj]);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 vv = vr[d4];
      acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
      acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
    }
  }
  m = m_new;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace
