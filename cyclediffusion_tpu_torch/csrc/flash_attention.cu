// Flash attention for Hopper (sm_90a): non-causal multi-head attention with
// an fp32 online softmax, for the SD UNet's long self-attention.
//
// Replaces the two Pallas TPU kernels on the SD-v1 translate path, both in
// cyclediffusion_tpu/ops/flash_attention.py:
//   * flash_attention_packed (_packed_kernel + _mha_online_update): token-major
//     q (B,Tq,H*D), k/v (B,Tk,H*D) -> (B,Tq,H*D); the 64x64 level, H=8, D=40.
//   * flash_attention_bhtd (_flash_kernel): head-major q (B,H,Tq,D),
//     k/v (B,H,Tk,D) -> (B,H,Tq,D); the 32x32 level, H=8, D=80.
// Both compute out = softmax(q k^T * scale) v per (batch, head): fp32 logits,
// fp32 running max m and denominator l, p rounded to the input dtype before it
// enters P.V, and l summing that same rounded p.  The two layouts reach the
// same kernels through element strides of (batch, head, row): nothing is
// transposed or padded through device memory.
//
// What bounds it on the H100.  The logits never leave the chip, so the
// traffic is q, k, v and o plus one re-read of k and v per 64-row q tile
// (from L2), a few tens of MB per call at the SD shapes, against
// 4*Tq*Tk*D flops per (batch, head): 86 GFLOP at the 64x64 level of a CFG
// pair of two images.  The kernel is compute-bound, by the tensor cores'
// rate (989 TFLOP/s dense bf16) and, as here without pipelining, by the
// exp and the staging of K/V tiles between the matmuls.
//
// Design.  One thread block per (batch*head, 64-row q tile).
//   * bf16, the path: four warps, 16 q rows each, with both matmuls on the
//     tensor cores (mma.sync m16n8k16, fp32 accumulate).  The block stages K
//     (row-major) and V (transposed, so that P.V reads key pairs) in 64-key
//     tiles in shared memory, zero-padding the head dim to a multiple of 16
//     (D=40 -> 48; D=80 needs none).  S = Q K^T stays in registers; the
//     online-softmax update (online_update_tc) rescales the accumulator and
//     turns S into P's A-operand fragments without leaving registers.
//   * fp32: one thread per q row on the FP32 cores (tensor cores would round
//     to TF32), K and V tiles staged in shared memory and read as broadcasts,
//     online_update_f32 over chunks of 16 keys.
// Keys >= Tk are masked to -inf in the last tile and rows >= Tq are not
// stored.  There are no atomics: the output is bitwise deterministic.

#include "attention_common.cuh"

namespace {

// Element strides of a (batch, head, row) triple; the head dim is contiguous.
struct Strides {
  long long b, h, t;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int H, int Tq, int Tk,
                          float scale, Strides sq, Strides sk, Strides sv,
                          Strides so) {
  using S = TcShape<D>;
  constexpr int Dp = S::Dp;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * S::KS];
  __shared__ __align__(16) __nv_bfloat16 vt[Dp * S::VS];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // fragment row group
  const int c = (lane & 3) * 2;   // fragment column pair
  const int r_lo = blockIdx.x * kBlockQ + warp * 16 + g;
  const int r_hi = r_lo + 8;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // Q as A fragments, loaded once: rows >= Tq and columns >= D read as zero
  uint32_t qa[Dp / 16][4];
#pragma unroll
  for (int kk = 0; kk < Dp / 16; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = (f & 1) ? r_hi : r_lo;
      const int d = kk * 16 + c + (f >> 1) * 8;
      qa[kk][f] = (row < Tq && d < D) ? ld32(qb + row * sq.t + d) : 0u;
    }
  }

  float acc[Dp / 8][4];
#pragma unroll
  for (int dt = 0; dt < Dp / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    const int n_valid = min(kBlockK, Tk - k0);
    __syncthreads();  // every warp is done with the previous tile
    // stage 16-byte chunks: K row-major, V transposed; pads read as zero
    for (int i = threadIdx.x; i < kBlockK * (Dp / 8); i += blockDim.x) {
      const int j = i / (Dp / 8);
      const int d0 = (i - j * (Dp / 8)) * 8;
      uint4 kc = make_uint4(0u, 0u, 0u, 0u);
      uint4 vc = make_uint4(0u, 0u, 0u, 0u);
      if (j < n_valid && d0 < D) {
        kc = *reinterpret_cast<const uint4*>(kb + (k0 + j) * sk.t + d0);
        vc = *reinterpret_cast<const uint4*>(vb + (k0 + j) * sv.t + d0);
      }
      *reinterpret_cast<uint4*>(ks + j * S::KS + d0) = kc;
      const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&vc);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(d0 + e) * S::VS + j] = vv[e];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk) {
        const __nv_bfloat16* kp = ks + (nt * 8 + g) * S::KS + kk * 16 + c;
        mma_16816(s[nt], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    uint32_t pa[4][4];
    online_update_tc<D>(s, c, n_valid, scale, m, l, acc, pa);

#pragma unroll
    for (int dt = 0; dt < Dp / 8; ++dt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* vp = vt + (dt * 8 + g) * S::VS + kk * 16 + c;
        mma_16816(acc[dt], pa[kk], ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int dt = 0; dt < Dp / 8; ++dt) {
    const int d = dt * 8 + c;
    if (d >= D) continue;
    if (r_lo < Tq) {
      *reinterpret_cast<uint32_t*>(ob + r_lo * so.t + d) =
          pack_bf16(__float2bfloat16(acc[dt][0] / l[0]),
                    __float2bfloat16(acc[dt][1] / l[0]));
    }
    if (r_hi < Tq) {
      *reinterpret_cast<uint32_t*>(ob + r_hi * so.t + d) =
          pack_bf16(__float2bfloat16(acc[dt][2] / l[1]),
                    __float2bfloat16(acc[dt][3] / l[1]));
    }
  }
}

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Tq, Tk;
  float scale;
  Strides sq, sk, sv, so;
  cudaStream_t stream;
};

template <int D>
int launch_d(const Args& a, bool bf16) {
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.B * a.H);
  if (bf16) {
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o),
        a.H, a.Tq, a.Tk, a.scale, a.sq, a.sk, a.sv, a.so);
  } else {
    flash_fwd_f32_kernel<D><<<grid, kBlockQ, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.H, a.Tq,
        a.Tk, a.scale, a.sq, a.sk, a.sv, a.so);
  }
  return static_cast<int>(cudaGetLastError());
}

bool strides_of_8(const Strides& s) { return (s.b % 8 | s.h % 8 | s.t % 8) == 0; }

int dispatch(const Args& a, int D, int is_bf16) {
  // the bf16 kernel moves 16-byte chunks of head rows
  if (is_bf16 && !(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                   aligned16(a.o) && strides_of_8(a.sq) && strides_of_8(a.sk) &&
                   strides_of_8(a.sv) && strides_of_8(a.so))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  switch (D) {
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
