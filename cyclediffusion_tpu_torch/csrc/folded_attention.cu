// Folded self-attention for Hopper (sm_90a): the SD UNet's 4096-token
// self-attention block with its projections.
//
// Replaces the two folded Pallas TPU kernels of
// cyclediffusion_tpu/ops/flash_attention.py:
//   * qout_self_attention_block (_qout_kernel + _project_flush), K3:
//       out = (softmax((x W_q^T) k^T * scale) v) W_o^T + b_o,
//     with k and v given (B, Tk, H*D);
//   * fused_self_attention_block (_folded_kernel), K4: the same with
//     k = x W_k^T and v = x W_v^T computed from x.
// Weights are nn.Linear weights (out, in), read as they are: W_q (H*D, C),
// W_k / W_v (H*D, C), W_o (C, H*D).
//
// Rounding points, as on the TPU: q (and K4's k, v) accumulated in fp32 and
// rounded once to the input dtype; p rounded before P.V, l summing the same
// rounded p; the normalised attention rounded before the output projection;
// the projection accumulated in fp32, b_o added in fp32, the result rounded
// once.
//
// What bounds it on the H100.  At the SD shape (B = 4, the CFG pair of two
// images; T = 4096, C = H*D = 320, H = 8, D = 40) K3 is 92.6 GFLOP, 85.9 of
// it the attention and 3.4 each projection, against 42 MB of compulsory
// traffic: 0.094 ms at the tensor cores' 989 TFLOP/s.  As in K2, the
// exponentials (537 M, ~0.14 ms at the special-function units' rate) and
// the L2 re-reads of K and V set the real floor; the projections are bound
// by bytes (6.3 us for N = 320).
//
// Design of the bf16 path: composed, not folded.  The Pallas kernels fold
// the projections so that q and the attention tile stay in VMEM.  On the
// H100 that trade does not pay:
//   * q and the attention output are 10.5 MB each at the SD shape: a round
//     trip through device memory is ~3 us at 3.35 TB/s, and both fit in the
//     50 MB L2, against the attention's ~0.34 ms;
//   * the output projection sums over heads, so a folded block must own all
//     8 heads of its rows: either ~96 KB of shared memory for a 128 x 8 x 48
//     q / attention tile, which halves the K/V ring (2 stages instead of 4
//     cost K2 41%), or 64-row tiles, which double the L2 re-reads of K/V.
// So each call is three launches on the caller's stream, all hand-written
// wgmma/TMA kernels:
//   1. the projection kernel (hopper_linear.cuh) writes q (K3) or
//      [q | k | v] (K4, three weights, one launch) into a workspace;
//   2. the attention kernel of K1/K2 (hopper_attention.cuh, this library's
//      own copy) reads q, k and v there (K4: strided views of row stride
//      3*H*D; K3: k and v as given) and overwrites q with the normalised
//      attention -- each block reads its q tile before it writes the same
//      rows and columns;
//   3. the projection kernel maps the attention through W_o, adds b_o and
//      writes out.
// Widths: C and H*D multiples of 64 and at most 448 (the projection's X
// tile and W ring in shared memory); head dims 40, 64, 80.
//
// fp32 (off the path): one thread per q row on the FP32 cores (tensor cores
// would round to TF32), one block of 64 q rows owning all H heads:
//   1. the head's q rows = x rows W_q^T, x and W_q streamed through shared
//      memory in 32-wide slices;
//   2. the head's online softmax over 64-key tiles (online_update_f32); the
//      normalised head output goes into an fp32 attention tile in shared
//      memory (~100 KB with its scratch at H*D = 320);
//   3. out rows = attention rows W_o^T + b_o, written once.
// K4 in fp32 is two launches: [k | v] = x [W_k | W_v]^T into a (B, T, 2*H*D)
// workspace, then the fp32 K3 kernel on it.
// Keys >= Tk are masked to -inf; rows >= Tq are computed on zeros and not
// stored.  No atomics: the output is bitwise deterministic.

#include "attention_common.cuh"
#include "hopper_attention.cuh"
#include "hopper_linear.cuh"

namespace {

constexpr int kF32Slice = 32;         // fp32 GEMM slice
constexpr int kF32S = kF32Slice + 1;  // shared row stride of an fp32 slice

// ---------------------------------------------------------------------------
// fp32: FP32 cores, one thread per q row
// ---------------------------------------------------------------------------

// Shared memory of qout_f32_kernel<D> in floats: the 64 x (H*D + 1) attention
// tile (rounded up to 16 bytes) and the scratch of the largest phase.
template <int D>
size_t qout_f32_smem(int HD) {
  const size_t tile = (kBlockQ * (size_t)(HD + 1) + 3) & ~(size_t)3;
  const size_t proj_q = (size_t)(kBlockQ + D) * kF32S;
  const size_t attn = 2 * (size_t)kBlockK * D;
  const size_t proj_o = (size_t)kF32Slice * kF32S;
  size_t scratch = proj_q > attn ? proj_q : attn;
  scratch = scratch > proj_o ? scratch : proj_o;
  return sizeof(float) * (tile + scratch);
}

template <int D>
__global__ void __launch_bounds__(kBlockQ)
    qout_f32_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ wo, const float* __restrict__ bo,
                    float* __restrict__ out, int Tq, int Tk, int C, int H,
                    float scale, long long k_sb, long long k_st, long long v_sb,
                    long long v_st) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  extern __shared__ __align__(16) float smf[];
  const int HD = H * D;
  const int AS = HD + 1;  // odd row stride: row t of the tile in bank t + col
  float* at = smf;        // the attention tile, 64 x AS
  float* region = smf + ((kBlockQ * AS + 3) & ~3);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ;
  const int n_rows = min(kBlockQ, Tq - row0);
  const int t = threadIdx.x;
  const float* xb = x + ((long long)b * Tq + row0) * C;

  for (int h = 0; h < H; ++h) {
    // 1. this head's q row = x row W_q[h*D:(h+1)*D]^T
    float q[D];
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = 0.f;
    float* xs = region;
    float* wsl = region + kBlockQ * kF32S;
    for (int k0 = 0; k0 < C; k0 += kF32Slice) {
      __syncthreads();
      for (int i = t; i < kBlockQ * kF32Slice; i += kBlockQ) {
        const int r = i / kF32Slice;
        const int kk = i - r * kF32Slice;
        xs[r * kF32S + kk] = r < n_rows ? xb[(long long)r * C + k0 + kk] : 0.f;
      }
      for (int i = t; i < D * kF32Slice; i += kBlockQ) {
        const int d = i / kF32Slice;
        const int kk = i - d * kF32Slice;
        wsl[d * kF32S + kk] = wq[(long long)(h * D + d) * C + k0 + kk];
      }
      __syncthreads();
      for (int kk = 0; kk < kF32Slice; ++kk) {
        const float xv = xs[t * kF32S + kk];
#pragma unroll
        for (int d = 0; d < D; ++d) q[d] = fmaf(xv, wsl[d * kF32S + kk], q[d]);
      }
    }

    // 2. the head's attention over 64-key tiles
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    float m = -INFINITY;
    float l = 0.f;
    float(*ks)[D] = reinterpret_cast<float(*)[D]>(region);
    float(*vs)[D] = ks + kBlockK;
    const float* kb = k + b * k_sb + h * D;
    const float* vb = v + b * v_sb + h * D;
    for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
      const int n_valid = min(kBlockK, Tk - k0);
      __syncthreads();
      for (int i = t; i < kBlockK * D; i += kBlockQ) {
        const int j = i / D;
        const int d = i - j * D;
        const bool real = j < n_valid;
        ks[j][d] = real ? kb[(long long)(k0 + j) * k_st + d] : 0.f;
        vs[j][d] = real ? vb[(long long)(k0 + j) * v_st + d] : 0.f;
      }
      __syncthreads();
      for (int j0 = 0; j0 < n_valid; j0 += kChunk) {
        online_update_f32<D>(q, ks, vs, j0, n_valid, scale, m, l, acc);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) at[t * AS + h * D + d] = acc[d] / l;
  }

  // 3. out row = attention row W_o^T + b_o
  float* ob = out + ((long long)b * Tq + row0) * C;
  float* wsl = region;
  for (int n0 = 0; n0 < C; n0 += kF32Slice) {
    float o[kF32Slice];
#pragma unroll
    for (int n = 0; n < kF32Slice; ++n) o[n] = 0.f;
    for (int k0 = 0; k0 < HD; k0 += kF32Slice) {
      __syncthreads();
      for (int i = t; i < kF32Slice * kF32Slice; i += kBlockQ) {
        const int n = i / kF32Slice;
        const int kk = i - n * kF32Slice;
        wsl[n * kF32S + kk] = wo[(long long)(n0 + n) * HD + k0 + kk];
      }
      __syncthreads();
      for (int kk = 0; kk < kF32Slice; ++kk) {
        const float a = at[t * AS + k0 + kk];
#pragma unroll
        for (int n = 0; n < kF32Slice; ++n) o[n] = fmaf(a, wsl[n * kF32S + kk], o[n]);
      }
    }
    if (t < n_rows) {
#pragma unroll
      for (int n = 0; n < kF32Slice; ++n) ob[(long long)t * C + n0 + n] = o[n] + bo[n0 + n];
    }
  }
}

__global__ void __launch_bounds__(kBlockQ)
    kv_proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                       const float* __restrict__ wv, float* __restrict__ kv, int M,
                       int C, int HD) {
  __shared__ float xs[kBlockQ * kF32S];
  __shared__ float wsl[kF32Slice * kF32S];
  const int n0 = blockIdx.x * kF32Slice;
  const int row0 = blockIdx.y * kBlockQ;
  const int n_rows = min(kBlockQ, M - row0);
  const int t = threadIdx.x;
  const float* w = n0 < HD ? wk + (long long)n0 * C : wv + (long long)(n0 - HD) * C;
  const float* xb = x + (long long)row0 * C;

  float o[kF32Slice];
#pragma unroll
  for (int n = 0; n < kF32Slice; ++n) o[n] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kF32Slice) {
    __syncthreads();
    for (int i = t; i < kBlockQ * kF32Slice; i += kBlockQ) {
      const int r = i / kF32Slice;
      const int kk = i - r * kF32Slice;
      xs[r * kF32S + kk] = r < n_rows ? xb[(long long)r * C + k0 + kk] : 0.f;
    }
    for (int i = t; i < kF32Slice * kF32Slice; i += kBlockQ) {
      const int n = i / kF32Slice;
      const int kk = i - n * kF32Slice;
      wsl[n * kF32S + kk] = w[(long long)n * C + k0 + kk];
    }
    __syncthreads();
    for (int kk = 0; kk < kF32Slice; ++kk) {
      const float xv = xs[t * kF32S + kk];
#pragma unroll
      for (int n = 0; n < kF32Slice; ++n) o[n] = fmaf(xv, wsl[n * kF32S + kk], o[n]);
    }
  }
  if (t < n_rows) {
    float* dst = kv + ((long long)row0 + t) * 2 * HD + n0;
#pragma unroll
    for (int n = 0; n < kF32Slice; ++n) dst[n] = o[n];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct QoutArgs {
  const void *x, *wq, *k, *v, *wo, *bo;
  void* out;
  int B, Tq, Tk, C, H;
  float scale;
  long long k_sb, k_st, v_sb, v_st;
  cudaStream_t stream;
};

template <int D>
int launch_qout_f32(const QoutArgs& a) {
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.B);
  const size_t smem = qout_f32_smem<D>(a.H * D);
  const cudaError_t err = cudaFuncSetAttribute(
      qout_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qout_f32_kernel<D><<<grid, kBlockQ, smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.wq),
      static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.wo), static_cast<const float*>(a.bo),
      static_cast<float*>(a.out), a.Tq, a.Tk, a.C, a.H, a.scale, a.k_sb, a.k_st,
      a.v_sb, a.v_st);
  return static_cast<int>(cudaGetLastError());
}

int launch_qout_f32_d(const QoutArgs& a, int D) {
  switch (D) {
    case 40: return launch_qout_f32<40>(a);
    case 64: return launch_qout_f32<64>(a);
    case 80: return launch_qout_f32<80>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 path of K3 (w_in: W_q three times, n_in = 1; k, v given) and K4
// (w_in: W_q, W_k, W_v, n_in = 3; k, v the workspace's columns): steps 1-3
// of the note above.  ws holds B*Tq rows of ld elements, q in the first H*D.
int composed_bf16(const QoutArgs& a, int D, const void* const (&w_in)[3], int n_in, void* ws,
                  long long ld) {
  const int HD = a.H * D;
  const int M = a.B * a.Tq;
  const hopper::LinearArgs proj_in{
      a.x, a.C, M, a.C, {w_in[0], w_in[1], w_in[2]}, HD, n_in, nullptr, ws, ld, a.stream};
  int rc = hopper::launch_linear(proj_in);
  if (rc != 0) return rc;
  const hopper::Strides sq{a.Tq * ld, D, ld};
  const hopper::Args attn{ws,   a.k,  a.v,     ws, a.B, a.H, a.Tq, a.Tk, a.scale, sq,
                          {a.k_sb, D, a.k_st}, {a.v_sb, D, a.v_st}, sq, a.stream};
  rc = hopper::launch_bf16_d(attn, D);
  if (rc != 0) return rc;
  const hopper::LinearArgs proj_out{
      ws, ld, M, HD, {a.wo, a.wo, a.wo}, a.C, 1, a.bo, a.out, a.C, a.stream};
  return hopper::launch_linear(proj_out);
}

// Shapes and alignment the kernels take; 0 or a CUDA error code.
int check(int B, int C, int H, int D, bool bf16_path, const void* const* ptrs, int n_ptrs) {
  if (D != 40 && D != 64 && D != 80) return static_cast<int>(cudaErrorInvalidValue);
  if (C % 64 != 0 || (H * D) % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_path) {
    // the projection's X tile and W ring; the attention's grid of B*H rows
    if (C > hopper::kLinMaxK || H * D > hopper::kLinMaxK || (long long)B * H > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < n_ptrs; ++i) {  // TMA takes 16-byte aligned bases
      if (!aligned16(ptrs[i])) return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  return 0;
}

}  // namespace

// K3: x (B, Tq, C), W_q (H*D, C), k/v (B, Tk, H*D) with element strides of
// (batch, row) and a contiguous head dim, W_o (C, H*D), b_o (C) -> out
// (B, Tq, C), all contiguous otherwise.  bf16: ws is a (B, Tq, H*D)
// workspace (q, then the attention); fp32: ws is not used.  Returns 0 or a
// CUDA error code.
extern "C" int cd_qout_self_attention(const void* x, const void* wq, const void* k,
                                      const void* v, const void* wo, const void* bo,
                                      void* out, void* ws, int B, int Tq, int Tk, int C,
                                      int H, int D, long long k_sb, long long k_st,
                                      long long v_sb, long long v_st, float scale,
                                      int is_bf16, void* stream) {
  const void* ptrs[] = {x, wq, k, v, wo, out, ws};
  int rc = check(B, C, H, D, is_bf16, ptrs, 7);
  if (rc == 0 && is_bf16 && (k_sb % 8 | k_st % 8 | v_sb % 8 | v_st % 8) != 0) {
    rc = static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (rc != 0) return rc;
  const QoutArgs a{x,  wq,   k,     v,    wo,   bo,   out,  B,
                   Tq, Tk,   C,     H,    scale, k_sb, k_st, v_sb,
                   v_st, static_cast<cudaStream_t>(stream)};
  if (!is_bf16) return launch_qout_f32_d(a, D);
  const void* w_in[] = {wq, wq, wq};
  return composed_bf16(a, D, w_in, 1, ws, (long long)H * D);
}

// K4: x (B, T, C), W_q/W_k/W_v (H*D, C), W_o (C, H*D), b_o (C) -> out
// (B, T, C), with a workspace ws of (B, T, 3*H*D) in bf16 ([q | k | v], the
// attention over q) or (B, T, 2*H*D) in fp32 ([k | v]).  Returns 0 or a CUDA
// error code.
extern "C" int cd_fused_self_attention(const void* x, const void* wq, const void* wk,
                                       const void* wv, const void* wo, const void* bo,
                                       void* ws, void* out, int B, int T, int C, int H,
                                       int D, float scale, int is_bf16, void* stream) {
  const void* ptrs[] = {x, wq, wk, wv, wo, ws, out};
  const int rc = check(B, C, H, D, is_bf16, ptrs, 7);
  if (rc != 0) return rc;
  const long long HD = (long long)H * D;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const __nv_bfloat16* qkv = static_cast<const __nv_bfloat16*>(ws);
    const long long sb = T * 3 * HD;
    const QoutArgs a{x, wq, qkv + HD, qkv + 2 * HD, wo, bo, out, B, T, T, C, H, scale,
                     sb, 3 * HD, sb, 3 * HD, st};
    const void* w_in[] = {wq, wk, wv};
    return composed_bf16(a, D, w_in, 3, ws, 3 * HD);
  }
  const int M = B * T;
  const dim3 grid(2 * HD / kF32Slice, (M + kBlockQ - 1) / kBlockQ);
  kv_proj_f32_kernel<<<grid, kBlockQ, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk),
      static_cast<const float*>(wv), static_cast<float*>(ws), M, C, HD);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* kv = static_cast<const float*>(ws);
  const long long sb = T * 2 * HD;
  const QoutArgs a{x, wq, kv, kv + HD, wo, bo, out, B, T, T, C, H, scale,
                   sb, 2 * HD, sb, 2 * HD, st};
  return launch_qout_f32_d(a, D);
}

// The projection kernel alone: y (M, N) = x (M, K) w (N, K)^T (+ bias (N),
// or nullptr), bf16, all contiguous.  Returns 0 or a CUDA error code.
extern "C" int cd_linear(const void* x, const void* w, const void* bias, void* y, int M, int N,
                         int K, void* stream) {
  const hopper::LinearArgs a{x, K, M, K, {w, w, w}, N, 1, bias, y, N,
                             static_cast<cudaStream_t>(stream)};
  return hopper::launch_linear(a);
}
