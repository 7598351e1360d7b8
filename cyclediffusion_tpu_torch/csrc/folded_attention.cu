// Folded self-attention for Hopper (sm_90a): the SD UNet's 4096-token
// self-attention block with its projections, in the same kernel as the
// online softmax.
//
// Replaces the two folded Pallas TPU kernels of
// cyclediffusion_tpu/ops/flash_attention.py:
//   * qout_self_attention_block (_qout_kernel + _project_flush), K3:
//       out = (softmax((x W_q^T) k^T * scale) v) W_o^T + b_o,
//     with k and v given (B, Tk, H*D);
//   * fused_self_attention_block (_folded_kernel), K4: the same with
//     k = x W_k^T and v = x W_v^T computed from x.
// Weights are nn.Linear weights (out, in), read as they are: W_q (H*D, C),
// W_k / W_v (H*D, C), W_o (C, H*D).  Rounding points, as on the TPU: q (and
// K4's k, v) accumulated in fp32 and rounded once to the input dtype; p
// rounded before P.V, l summing the same rounded p; the normalised attention
// rounded before the output projection; the projection accumulated in fp32,
// b_o added in fp32, the result rounded once.
//
// What bounds it on the H100.  At the SD shape (B=4 CFG pair of two images,
// T=4096, C=H*D=320, H=8, D=40) the work is 92.6 GFLOP for K3 (85.9 of it the
// attention, 3.4 each projection) and 99.3 for K4, against 21-42 MB of
// compulsory traffic: compute-bound, ~0.1 ms at the tensor cores' 989 TFLOP/s.
// This first version is simple, not fast: no pipelining of the staging, and
// only 256 blocks (64 q tiles x batch 4) for 132 SMs.
//
// Design.  The output projection sums over heads, so one block owns all H
// heads of its 64 q rows (K1/K2 launch one block per head and cannot).
//   * bf16, the path: four warps of 16 q rows, every product on the tensor
//     cores with this file's own mma.sync code (m16n8k16, fp32 accumulate):
//       1. q tile = x tile W_q^T, W_q and x streamed through shared memory in
//          64x64 slices, rounded into a 64 x (H*D) shared tile;
//       2. per head, an online softmax over 64-key tiles of k/v on
//          mma.sync (online_update_tc, attention_common.cuh);
//          the normalised head output is rounded into the same shared tile,
//          over the q columns that head no longer needs;
//       3. out tile = attention tile W_o^T + b_o, W_o streamed in slices,
//          written once.
//     Dynamic shared memory ~59 KB at the SD shape, set per launch with
//     cudaFuncSetAttribute.
//   * fp32: one thread per q row on the FP32 cores (tensor cores would round
//     to TF32), the same three steps with online_update_f32; the attention
//     tile is fp32 in shared memory (~100 KB with its scratch at H*D = 320).
//   * K4 cannot carry k/v from one block to the next as the TPU's sequential
//     grid does, so it is two launches behind one call: a projection kernel
//     writes [k | v] = x [W_k | W_v]^T, rounded once, into a (B, T, 2*H*D)
//     workspace, then the K3 kernel reads k and v from it.
// Keys >= Tk are masked to -inf; rows >= Tq are computed on zeros and not
// stored.  No atomics: the output is bitwise deterministic.

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSlice = 64;            // GEMM slice: 64 output columns x 64 k
constexpr int kSliceS = kSlice + 8;   // shared row stride of a bf16 slice
constexpr int kF32Slice = 32;         // fp32 GEMM slice
constexpr int kF32S = kF32Slice + 1;  // shared row stride of an fp32 slice

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Stage a 64 x 64 slice of a row-major matrix (row stride ld elements, rows
// 16-byte aligned) into a 64 x kSliceS shared tile; rows >= n_rows read zero.
__device__ __forceinline__ void stage_slice(bf16* dst, const bf16* src,
                                            long long ld, int n_rows) {
  for (int i = threadIdx.x; i < kSlice * (kSlice / 8); i += blockDim.x) {
    const int r = i >> 3;
    const int c8 = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) val = *reinterpret_cast<const uint4*>(src + r * ld + c8);
    *reinterpret_cast<uint4*>(dst + r * kSliceS + c8) = val;
  }
}

// acc (16 rows x 64 columns of this warp) += A B^T over one 64-wide k slice:
// a points at the warp's first row (row stride lda), b at a staged slice of
// 64 weight rows (the output columns).
__device__ __forceinline__ void mma_slice(float (&acc)[8][4], const bf16* a,
                                          int lda, const bf16* b, int g, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* ap = a + g * lda + kk * 16 + c;
    const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * lda), ld32(ap + 8),
                            ld32(ap + 8 * lda + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* bp = b + (nt * 8 + g) * kSliceS + kk * 16 + c;
      mma_16816(acc[nt], af, ld32(bp), ld32(bp + 8));
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
}

// Round a warp's 16 x 64 accumulator tile and store it at dst (row stride
// ld, the warp's first row), rows >= n_rows skipped.
__device__ __forceinline__ void store_tile(bf16* dst, long long ld,
                                           const float (&acc)[8][4], int g, int c,
                                           int n_rows) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + c;
    if (g < n_rows) {
      *reinterpret_cast<uint32_t*>(dst + g * ld + col) =
          pack_bf16(__float2bfloat16(acc[nt][0]), __float2bfloat16(acc[nt][1]));
    }
    if (g + 8 < n_rows) {
      *reinterpret_cast<uint32_t*>(dst + (g + 8) * ld + col) =
          pack_bf16(__float2bfloat16(acc[nt][2]), __float2bfloat16(acc[nt][3]));
    }
  }
}

// Shared memory of qout_bf16_kernel<D> in bytes: the 64 x (H*D + 8) q /
// attention tile and the scratch of the largest phase.
template <int D>
size_t qout_bf16_smem(int HD) {
  using S = TcShape<D>;
  const size_t gemm = 2 * kBlockQ * kSliceS;
  const size_t attn = kBlockK * S::KS + S::Dp * S::VS;
  return sizeof(bf16) * (kBlockQ * (size_t)(HD + 8) + (gemm > attn ? gemm : attn));
}

template <int D>
__global__ void __launch_bounds__(128)
    qout_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                     bf16* __restrict__ out, int Tq, int Tk, int C, int H,
                     float scale, long long k_sb, long long k_st, long long v_sb,
                     long long v_st) {
  using S = TcShape<D>;
  constexpr int Dp = S::Dp;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  extern __shared__ __align__(16) unsigned char smem[];
  const int HD = H * D;
  const int QS = HD + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // q, then the attention output
  bf16* region = qs + kBlockQ * QS;          // scratch of the phase at hand

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ;
  const int n_rows = min(kBlockQ, Tq - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;       // fragment row group
  const int c = (lane & 3) * 2;  // fragment column pair
  const int wr = warp * 16;      // the warp's first row in the tile

  // 1. q = x W_q^T, rounded once into qs
  {
    const bf16* xb = x + ((long long)b * Tq + row0) * C;
    bf16* xa = region;
    bf16* ws = region + kBlockQ * kSliceS;
    for (int n0 = 0; n0 < HD; n0 += kSlice) {
      float acc[8][4];
      zero(acc);
      for (int k0 = 0; k0 < C; k0 += kSlice) {
        __syncthreads();  // every warp is done with the previous slices
        stage_slice(xa, xb + k0, C, n_rows);
        stage_slice(ws, wq + (long long)n0 * C + k0, C, kSlice);
        __syncthreads();
        mma_slice(acc, xa + wr * kSliceS, kSliceS, ws, g, c);
      }
      store_tile(qs + wr * QS + n0, QS, acc, g, c, kBlockQ);
    }
  }
  __syncthreads();  // q written by other lanes; region reused below

  // 2. attention per head (online_update_tc); the result overwrites the head's q
  bf16* kt = region;
  bf16* vt = region + kBlockK * S::KS;
  for (int h = 0; h < H; ++h) {
    uint32_t qa[Dp / 16][4];
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = wr + g + (f & 1) * 8;
        const int d = kk * 16 + c + (f >> 1) * 8;
        qa[kk][f] = d < D ? ld32(qs + row * QS + h * D + d) : 0u;
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
    const bf16* kb = k + b * k_sb + h * D;
    const bf16* vb = v + b * v_sb + h * D;

    for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
      const int n_valid = min(kBlockK, Tk - k0);
      __syncthreads();  // every warp is done with the previous tile
      for (int i = threadIdx.x; i < kBlockK * (Dp / 8); i += blockDim.x) {
        const int j = i / (Dp / 8);
        const int d0 = (i - j * (Dp / 8)) * 8;
        uint4 kc = make_uint4(0u, 0u, 0u, 0u);
        uint4 vc = make_uint4(0u, 0u, 0u, 0u);
        if (j < n_valid && d0 < D) {
          kc = *reinterpret_cast<const uint4*>(kb + (k0 + j) * k_st + d0);
          vc = *reinterpret_cast<const uint4*>(vb + (k0 + j) * v_st + d0);
        }
        *reinterpret_cast<uint4*>(kt + j * S::KS + d0) = kc;
        const bf16* vv = reinterpret_cast<const bf16*>(&vc);
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
          const bf16* kp = kt + (nt * 8 + g) * S::KS + kk * 16 + c;
          mma_16816(s[nt], qa[kk], ld32(kp), ld32(kp + 8));
        }
      }
      uint32_t pa[4][4];
      online_update_tc<D>(s, c, n_valid, scale, m, l, acc, pa);
#pragma unroll
      for (int dt = 0; dt < Dp / 8; ++dt) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const bf16* vp = vt + (dt * 8 + g) * S::VS + kk * 16 + c;
          mma_16816(acc[dt], pa[kk], ld32(vp), ld32(vp + 8));
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int dt = 0; dt < Dp / 8; ++dt) {
      const int d = dt * 8 + c;
      if (d >= D) continue;
      bf16* dst = qs + (wr + g) * QS + h * D + d;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(
          __float2bfloat16(acc[dt][0] / l[0]), __float2bfloat16(acc[dt][1] / l[0]));
      *reinterpret_cast<uint32_t*>(dst + 8 * QS) = pack_bf16(
          __float2bfloat16(acc[dt][2] / l[1]), __float2bfloat16(acc[dt][3] / l[1]));
    }
  }

  // 3. out = attention W_o^T + b_o, written once
  bf16* ob = out + ((long long)b * Tq + row0) * C;
  bf16* ws = region;
  for (int n0 = 0; n0 < C; n0 += kSlice) {
    float acc[8][4];
    zero(acc);
    for (int k0 = 0; k0 < HD; k0 += kSlice) {
      __syncthreads();  // attention tile complete; previous slice consumed
      stage_slice(ws, wo + (long long)n0 * HD + k0, HD, kSlice);
      __syncthreads();
      mma_slice(acc, qs + wr * QS + k0, QS, ws, g, c);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + nt * 8 + c;
      const float b0 = __bfloat162float(bo[col]);
      const float b1 = __bfloat162float(bo[col + 1]);
      acc[nt][0] += b0;
      acc[nt][1] += b1;
      acc[nt][2] += b0;
      acc[nt][3] += b1;
    }
    store_tile(ob + (long long)wr * C + n0, C, acc, g, c, n_rows - wr);
  }
}

// [k | v] = x [W_k | W_v]^T for K4: kv (M, 2*HD) rows of 64 columns per block,
// each column chunk wholly in W_k or in W_v (HD is a multiple of 64).
__global__ void __launch_bounds__(128)
    kv_proj_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                        const bf16* __restrict__ wv, bf16* __restrict__ kv, int M,
                        int C, int HD) {
  __shared__ __align__(16) bf16 xa[kBlockQ * kSliceS];
  __shared__ __align__(16) bf16 ws[kSlice * kSliceS];
  const int n0 = blockIdx.x * kSlice;
  const int row0 = blockIdx.y * kBlockQ;
  const int n_rows = min(kBlockQ, M - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = (lane & 3) * 2;
  const int wr = warp * 16;
  const bf16* w = n0 < HD ? wk + (long long)n0 * C : wv + (long long)(n0 - HD) * C;
  const bf16* xb = x + (long long)row0 * C;

  float acc[8][4];
  zero(acc);
  for (int k0 = 0; k0 < C; k0 += kSlice) {
    __syncthreads();
    stage_slice(xa, xb + k0, C, n_rows);
    stage_slice(ws, w + k0, C, kSlice);
    __syncthreads();
    mma_slice(acc, xa + wr * kSliceS, kSliceS, ws, g, c);
  }
  store_tile(kv + ((long long)row0 + wr) * 2 * HD + n0, 2 * HD, acc, g, c,
             n_rows - wr);
}

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
int launch_qout_d(const QoutArgs& a, bool bf16_path) {
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.B);
  const int HD = a.H * D;
  cudaError_t err;
  if (bf16_path) {
    const size_t smem = qout_bf16_smem<D>(HD);
    err = cudaFuncSetAttribute(qout_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    qout_bf16_kernel<D><<<grid, 128, smem, a.stream>>>(
        static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.wq),
        static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const bf16*>(a.wo), static_cast<const bf16*>(a.bo),
        static_cast<bf16*>(a.out), a.Tq, a.Tk, a.C, a.H, a.scale, a.k_sb, a.k_st,
        a.v_sb, a.v_st);
  } else {
    const size_t smem = qout_f32_smem<D>(HD);
    err = cudaFuncSetAttribute(qout_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    qout_f32_kernel<D><<<grid, kBlockQ, smem, a.stream>>>(
        static_cast<const float*>(a.x), static_cast<const float*>(a.wq),
        static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const float*>(a.wo), static_cast<const float*>(a.bo),
        static_cast<float*>(a.out), a.Tq, a.Tk, a.C, a.H, a.scale, a.k_sb, a.k_st,
        a.v_sb, a.v_st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shapes and alignment the kernels take; 0 or a CUDA error code.
int check(int C, int H, int D, bool bf16_path, const void* const* ptrs, int n_ptrs) {
  if (D != 40 && D != 64 && D != 80) return static_cast<int>(cudaErrorInvalidValue);
  if (C % kSlice != 0 || (H * D) % kSlice != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16_path) {  // the bf16 kernels move 16-byte chunks of rows
    for (int i = 0; i < n_ptrs; ++i) {
      if (!aligned16(ptrs[i])) return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  return 0;
}

int launch_qout(const QoutArgs& a, int D, bool bf16_path) {
  switch (D) {
    case 40: return launch_qout_d<40>(a, bf16_path);
    case 64: return launch_qout_d<64>(a, bf16_path);
    case 80: return launch_qout_d<80>(a, bf16_path);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K3: x (B, Tq, C), W_q (H*D, C), k/v (B, Tk, H*D) with element strides of
// (batch, row) and a contiguous head dim, W_o (C, H*D), b_o (C) -> out
// (B, Tq, C), all contiguous otherwise.  Returns 0 or a CUDA error code.
extern "C" int cd_qout_self_attention(const void* x, const void* wq, const void* k,
                                      const void* v, const void* wo, const void* bo,
                                      void* out, int B, int Tq, int Tk, int C, int H,
                                      int D, long long k_sb, long long k_st,
                                      long long v_sb, long long v_st, float scale,
                                      int is_bf16, void* stream) {
  const void* ptrs[] = {x, wq, k, v, wo, out};
  int rc = check(C, H, D, is_bf16, ptrs, 6);
  if (rc == 0 && is_bf16 && (k_sb % 8 | k_st % 8 | v_sb % 8 | v_st % 8) != 0) {
    rc = static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (rc != 0) return rc;
  const QoutArgs a{x,  wq,   k,     v,    wo,   bo,   out,  B,
                   Tq, Tk,   C,     H,    scale, k_sb, k_st, v_sb,
                   v_st, static_cast<cudaStream_t>(stream)};
  return launch_qout(a, D, is_bf16);
}

// K4: x (B, T, C), W_q/W_k/W_v (H*D, C), W_o (C, H*D), b_o (C), a workspace
// kv (B, T, 2*H*D) -> out (B, T, C): the [k | v] projection, then K3 on it.
// Returns 0 or a CUDA error code.
extern "C" int cd_fused_self_attention(const void* x, const void* wq, const void* wk,
                                       const void* wv, const void* wo, const void* bo,
                                       void* kv, void* out, int B, int T, int C, int H,
                                       int D, float scale, int is_bf16, void* stream) {
  const void* ptrs[] = {x, wq, wk, wv, wo, kv, out};
  const int rc = check(C, H, D, is_bf16, ptrs, 7);
  if (rc != 0) return rc;
  const int HD = H * D;
  const int M = B * T;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid(2 * HD / kSlice, (M + kBlockQ - 1) / kBlockQ);
    kv_proj_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
        static_cast<const bf16*>(wv), static_cast<bf16*>(kv), M, C, HD);
  } else {
    const dim3 grid(2 * HD / kF32Slice, (M + kBlockQ - 1) / kBlockQ);
    kv_proj_f32_kernel<<<grid, kBlockQ, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wk),
        static_cast<const float*>(wv), static_cast<float*>(kv), M, C, HD);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t elt = is_bf16 ? sizeof(bf16) : sizeof(float);
  const void* v = static_cast<const char*>(kv) + HD * elt;
  const long long sb = (long long)T * 2 * HD;
  const QoutArgs a{x, wq, kv, v, wo, bo, out, B, T, T, C, H, scale,
                   sb, 2LL * HD, sb, 2LL * HD, st};
  return launch_qout(a, D, is_bf16);
}
