// Flash attention for Hopper (sm_90a): non-causal multi-head attention with
// an fp32 online softmax, for the SD UNet's long self-attention.
//
// Replaces the two Pallas TPU kernels on the SD-v1 translate path, both in
// cyclediffusion_tpu/ops/flash_attention.py:
//   * flash_attention_packed (_packed_kernel + _mha_online_update): token-major
//     q (B,Tq,H*D), k/v (B,Tk,H*D) -> (B,Tq,H*D); the 64x64 level, H=8, D=40.
//   * flash_attention_bhtd (_flash_kernel): head-major q (B,H,Tq,D),
//     k/v (B,H,Tk,D) -> (B,H,Tq,D); the 32x32 level, H=8, D=80 (LDM
//     text2img-large's: D=40; the FFHQ/CelebA LDM's, ds 2 of its 64x64
//     latent: H=14, D=32, head views of token-major (B, T, 448) tensors).
// Both compute out = softmax(q k^T * scale) v per (batch, head): fp32 logits,
// fp32 running max m and denominator l, p rounded to the input dtype before it
// enters P.V, and l summing that same rounded p.  The two layouts reach the
// same kernels through element strides of (batch, head, row): nothing is
// transposed or padded through device memory.
//
// What bounds it on the H100, at the main path's shapes in bf16 (batch 4 =
// 2 requests x the CFG pair, H = 8):
//   * the matrix products, 4*Tq*Tk*D flops per (batch, head): 85.9 GFLOP for
//     K2 (T = 4096, d = 40) and 10.7 for K1 (T = 1024, d = 80), 0.087 and
//     0.011 ms at 989 TFLOP/s;
//   * the exponentials, one per logit: 537 M for K2 and 34 M for K1, 0.138
//     and 0.009 ms at the ~3.9 T/s of the special-function units (FA3
//     paper, Shah et al. 2024, sec. 3) -- above the matmul bound at d = 40;
//   * the re-reads of K and V from L2, once per q tile: 1,024 blocks x 655 KB
//     = 0.67 GB per K2 call with 128-row tiles (1.34 GB with 64-row ones);
//   * compulsory HBM traffic, q, k, v and o once: 42 / 21 MB, 13 / 6 us.
//
// Design of the bf16 path.  The kernel and its main loop are in
// hopper_attention.cuh, where the folded kernels K3/K4 launch it too.  What
// it does about each limit of the mma.sync kernel it replaced:
//   * staging: one producer thread issues TMA (cp.async.bulk.tensor) loads
//     of the q tile and of 128-key K/V tiles into a 4-stage ring guarded by
//     mbarriers; no thread spends registers or instructions on a copy, and
//     the loads overlap the tensor cores and the softmax;
//   * V's transpose: none.  P V reads the V tile MN-major as it lies in
//     memory (wgmma's transpose bit on B);
//   * tensor cores: both products on wgmma (m64nNk16, fp32 accumulate),
//     Hopper's full-rate path.  S = Q K^T takes Q and K from shared memory;
//     O += P V takes P from registers, converted in place from S's
//     accumulator fragments;
//   * q tiles: 128 rows per block, two consumer warpgroups of 64 rows
//     sharing every K/V tile, which halves the L2 re-reads of 64-row tiles;
//   * the exponentials: p = 2^(s*c - m*c) with c = scale*log2(e), one FFMA
//     and one MUFU ex2 per logit, the row max a quad shuffle;
//   * the head-dim pad: only S pads d = 40 to 48 (TMA zero-fills the columns
//     past D); P V runs at N = D;
//   * warps: a producer warpgroup and two consumer warpgroups.  Within a
//     consumer the softmax of tile j overlaps P_{j-1} V_{j-1} on the tensor
//     cores; between them the issue of the products alternates (FA3's
//     ping-pong), so that one's softmax overlaps the other's products.  The
//     producer gives its registers to the consumers (setmaxnreg 40 / 232):
//     the 64x128 fp32 S tile, the O tile and P stay in registers.
// Operands lie in shared memory as 16-column chunks with TMA's 32-byte
// swizzle: 80- and 160-byte head rows (d = 40, 80) fit no swizzle width, a
// 16-column chunk fits exactly one.  The tensor maps are encoded on the host
// per call (cuTensorMapEncodeTiled, from libcuda through the runtime) and
// passed as __grid_constant__ parameters, so a CUDA graph captures them.
// K2 at batch 4 runs 1,024 blocks, 7.8 waves on 132 SMs with one block per
// SM; K1 runs 256, 1.94 waves, so its last wave is 94% full and needs no
// persistent schedule.
//
// fp32 (off the path): one thread per q row on the FP32 cores (tensor cores
// would round to TF32), 64-row q tiles, K and V tiles staged in shared memory
// and read as broadcasts, online_update_f32 over chunks of 16 keys.
// Keys >= Tk are masked to -inf in the last tile and rows >= Tq are not
// stored.  There are no atomics: the output is bitwise deterministic.

#include "attention_common.cuh"
#include "hopper_attention.cuh"

namespace {

using hopper::Args;
using hopper::Strides;

// ---------------------------------------------------------------------------
// fp32: FP32 cores, one thread per q row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int H, int Tq, int Tk, float scale, Strides sq,
                         Strides sk, Strides sv, Strides so) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool live = row < Tq;

  const float* qp = q + b * sq.b + h * sq.h + (long long)(live ? row : 0) * sq.t;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    const int n_valid = min(kBlockK, Tk - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D;
      const int d = i - j * D;
      const bool real = j < n_valid;
      ks[j][d] = real ? kp[(long long)(k0 + j) * sk.t + d] : 0.f;
      vs[j][d] = real ? vp[(long long)(k0 + j) * sv.t + d] : 0.f;
    }
    __syncthreads();
    for (int j0 = 0; j0 < n_valid; j0 += kChunk) {
      online_update_f32<D>(qr, ks, vs, j0, n_valid, scale, m, l, acc);
    }
  }

  if (live) {
    float* op = o + b * so.b + h * so.h + (long long)row * so.t;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] / l;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_d(const Args& a, bool bf16) {
  if (bf16) return hopper::launch_bf16<D>(a);
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.B * a.H);
  flash_fwd_f32_kernel<D><<<grid, kBlockQ, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.H, a.Tq, a.Tk,
      a.scale, a.sq, a.sk, a.sv, a.so);
  return static_cast<int>(cudaGetLastError());
}

bool strides_of_8(const Strides& s) { return (s.b % 8 | s.h % 8 | s.t % 8) == 0; }

int dispatch(const Args& a, int D, int is_bf16) {
  // TMA takes 16-byte aligned bases and strides in multiples of 16 bytes
  if (is_bf16 && !(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                   aligned16(a.o) && strides_of_8(a.sq) && strides_of_8(a.sk) &&
                   strides_of_8(a.sv) && strides_of_8(a.so))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  switch (D) {
    case 32: return launch_d<32>(a, is_bf16);
    case 40: return launch_d<40>(a, is_bf16);
    case 64: return launch_d<64>(a, is_bf16);
    case 80: return launch_d<80>(a, is_bf16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Token-major (K2): q/o contiguous (B, Tq, H*D), k/v contiguous (B, Tk, H*D).
// Returns cudaGetLastError() after the launch.
extern "C" int cd_flash_attention_packed(const void* q, const void* k,
                                         const void* v, void* o, int B, int Tq,
                                         int Tk, int H, int D, float scale,
                                         int is_bf16, void* stream) {
  const long long hd = (long long)H * D;
  const Strides sq{Tq * hd, D, hd};
  const Strides skv{Tk * hd, D, hd};
  const Args a{q, k, v, o, B, H, Tq, Tk, scale, sq, skv, skv, sq,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, D, is_bf16);
}

// Head-major (K1): q (B, H, Tq, D), k/v (B, H, Tk, D) with the given element
// strides of (batch, head, row) and a contiguous head dim; o contiguous
// (B, H, Tq, D).  Returns cudaGetLastError() after the launch.
extern "C" int cd_flash_attention_bhtd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
    int Tk, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, float scale, int is_bf16, void* stream) {
  const Strides so{(long long)H * Tq * D, (long long)Tq * D, D};
  const Args a{q, k, v, o, B, H, Tq, Tk, scale,
               Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
               Strides{v_sb, v_sh, v_st}, so, static_cast<cudaStream_t>(stream)};
  return dispatch(a, D, is_bf16);
}
