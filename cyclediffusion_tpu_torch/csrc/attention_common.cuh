// Shared device code of the fp32 attention kernels (flash_attention.cu: K1,
// K2; folded_attention.cu: K3, K4), which run on the FP32 cores: the tile
// sizes and the online-softmax update online_update_f32, the counterpart of
// _mha_online_update in cyclediffusion_tpu/ops/flash_attention.py, and the
// alignment test of the C entry points.  The bf16 paths of all four run on
// wgmma and TMA: hopper_attention.cuh and hopper_linear.cuh.
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
constexpr int kChunk = 16;   // keys per online-softmax update

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
