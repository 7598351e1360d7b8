// The projection kernel of the folded self-attention K3/K4 on Hopper
// (sm_90a):
//
//   Y[M, N] = X[M, K] W[N, K]^T (+ b)
//
// bf16 in, fp32 accumulate, b added in fp32, Y rounded once to bf16: the
// rounding of the TPU kernels' in-body projections (a dot with
// preferred_element_type=float32, + bias, cast once).  W is an nn.Linear
// weight as it is, (out, in), which is K-major: wgmma's B without a
// transpose.  X and Y may have row strides other than K and N (multiples of
// 8 elements), so that a caller reads or writes columns of a wider
// workspace.  Up to three weights of the same row count fill the N axis one
// after another (K4's [q | k | v] from W_q, W_k, W_v), each through its own
// tensor map; a 64-row W tile never straddles two of them.
//
// What bounds it at the SD shapes (M = 4 x 4096 tokens, K = 320): the
// bytes.  For N = 320, X read and Y written once are 21.2 MB, 6.3 us at
// 3.35 TB/s, against 3.4 GFLOP, 3.4 us at 989 TFLOP/s; for N = 960, 42.6 MB
// and 12.7 us against 10.1 GFLOP.
//
// Design.  K <= 448 is small enough that a block keeps its whole X tile in
// shared memory (128 x 320 bf16 = 80 KB at SD's width) and streams W in
// 64-row tiles: there is no k loop to pipeline.  K is a multiple of 64 and
// a template parameter, so the K/16 products of a tile are unrolled (a
// run-time loop made ptxas fence every product, warning C7519).  One block
// per 128 rows of X (128 blocks, one wave on 132 SMs at the SD shape):
//   * a producer warp, of which one thread loads the X tile once and the W
//     tiles into a ring as deep as shared memory allows (3 stages at K =
//     320), with TMA, guarded by mbarriers (full, empty);
//   * two consumer warpgroups of 64 rows: per W tile, K/16 wgmma m64n64k16
//     with A (the X rows) and B (the W tile) both from shared memory, fp32
//     accumulators in registers, two sets of them: the products of tile
//     j + 1 run while the epilogue of tile j adds the bias, rounds and
//     stores.
// Operands lie in shared memory as 64-column chunks ([rows][64] bf16, 128
// bytes a row) in TMA's 128-byte swizzle, the layout wgmma reads K-major;
// a k16 step is 32 bytes into the chunk.  TMA zero-fills the rows past M,
// and rows >= M are not stored.  Each block reads all of W from L2 (200 KB
// at N = 320).  No atomics: the output is bitwise deterministic.

#pragma once

#include "hopper_attention.cuh"

namespace {
namespace hopper {

constexpr int kLinRows = 128;                            // X rows per block
constexpr int kLinTileN = 64;                            // W rows per tile
constexpr int kLinCols = 64;                             // columns per 128-byte chunk
constexpr int kLinConsumers = 256;                       // two warpgroups
constexpr int kLinThreads = kLinConsumers + 32;          // + the producer warp
constexpr int kLinXChunkBytes = kLinRows * kLinCols * 2;    // one [128][64] chunk
constexpr int kLinWChunkBytes = kLinTileN * kLinCols * 2;   // one [64][64] chunk
constexpr int kLinMaxStages = 4;
constexpr int kLinMaxWeights = 3;
constexpr int kLinSmemLimit = 232448;                    // bytes a block may use
constexpr int kLinBarrierBytes = 8 * (1 + 2 * kLinMaxStages);

// W tiles in flight at width K: what shared memory holds beside the X tile,
// at most kLinMaxStages
__host__ __device__ constexpr int linear_stages(int K) {
  const int n = (kLinSmemLimit - 1024 - kLinBarrierBytes - kLinRows * K * 2) / (kLinTileN * K * 2);
  return n < kLinMaxStages ? n : kLinMaxStages;
}

// the X tile, the ring and the barriers, + room to align to 1024 bytes
__host__ __device__ constexpr int linear_smem_bytes(int K) {
  return (kLinRows + linear_stages(K) * kLinTileN) * K * 2 + kLinBarrierBytes + 1024;
}

// the largest K whose X tile and a 2-stage ring fit
constexpr int kLinMaxK = 448;
static_assert(linear_stages(kLinMaxK) >= 2 && linear_smem_bytes(kLinMaxK) <= kLinSmemLimit,
              "X tile + ring exceed shared memory");

// wgmma descriptor of a K-major operand in 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO); LBO is not read for this layout
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// one box of a 2-D tensor map into shared memory, completion on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// d (64 x 64) (+)= A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Tensor maps are 2-D over (K, rows); a box is 64 columns x the tile's rows.
// W tile j comes from weight j / tiles_per_w, rows (j % tiles_per_w) * 64.
template <int K>
__global__ void __launch_bounds__(kLinThreads, 1)
    linear_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w0,
                       const __grid_constant__ CUtensorMap tm_w1,
                       const __grid_constant__ CUtensorMap tm_w2,
                       __nv_bfloat16* __restrict__ y, long long ldy,
                       const __nv_bfloat16* __restrict__ bias, int M, int n_tiles,
                       int tiles_per_w) {
  static_assert(K % kLinCols == 0 && K <= kLinMaxK, "K: a multiple of 64 up to kLinMaxK");
  constexpr int kc = K / kLinCols;                      // 64-column chunks
  constexpr int S = linear_stages(K);
  constexpr int stage_bytes = kc * kLinWChunkBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* ws = xs + kc * kLinXChunkBytes;              // stage s at ws + s * stage_bytes
  uint64_t* x_full = reinterpret_cast<uint64_t*>(ws + S * stage_bytes);
  uint64_t* w_full = x_full + 1;
  uint64_t* empty = w_full + S;
  const int m0 = blockIdx.x * kLinRows;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&empty[s], kLinConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kLinConsumers) {  // the producer warp: one thread issues
    if (threadIdx.x == kLinConsumers) {
      mbar_expect_tx(x_full, kc * kLinXChunkBytes);
#pragma unroll
      for (int c = 0; c < kc; ++c) {
        tma_load_2d(xs + c * kLinXChunkBytes, &tm_x, x_full, c * kLinCols, m0);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        mbar_wait(&empty[s], ((j / S) & 1) ^ 1);  // passes at once on the first round
        const int w = j / tiles_per_w;
        const CUtensorMap* tm = w == 0 ? &tm_w0 : (w == 1 ? &tm_w1 : &tm_w2);
        const int row = (j - w * tiles_per_w) * kLinTileN;
        uint8_t* dst = ws + s * stage_bytes;
        mbar_expect_tx(&w_full[s], stage_bytes);
#pragma unroll
        for (int c = 0; c < kc; ++c) {
          tma_load_2d(dst + c * kLinWChunkBytes, tm, &w_full[s], c * kLinCols, row);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows; accumulator fragments as in consume()
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x & 127;
  const int g = (t & 31) >> 2;
  const int c2 = (t & 3) * 2;
  const int row_lo = m0 + wg * 64 + (t >> 5) * 16 + g;
  const uint32_t a_addr = smem_u32(xs) + wg * 64 * kLinCols * 2;

  // the products of tile j into acc, issued and committed, not waited for
  auto issue = [&](float (&acc)[32], int j) {
    const int s = j % S;
    mbar_wait(&w_full[s], (j / S) & 1);
    const uint32_t b_addr = smem_u32(ws + s * stage_bytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < K / 16; ++k) {
      const uint32_t off = (k & 3) * 32;  // a k16 step is 32 bytes into its chunk
      wgmma_ss_n64(acc, desc_sw128(a_addr + (k >> 2) * kLinXChunkBytes + off),
                   desc_sw128(b_addr + (k >> 2) * kLinWChunkBytes + off), k > 0);
    }
    wgmma_commit();
  };
  // tile j's products are done: free its stage, add the bias, round, store
  auto finish = [&](float (&acc)[32], int j) {
    fence_regs(acc);
    mbar_arrive(&empty[j % S]);
    const int n0 = j * kLinTileN;
#pragma unroll
    for (int nb = 0; nb < kLinTileN / 8; ++nb) {
      const int col = n0 + 8 * nb + c2;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        b0 = __bfloat162float(bias[col]);
        b1 = __bfloat162float(bias[col + 1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row < M) {
          *reinterpret_cast<__nv_bfloat162*>(y + row * ldy + col) =
              __floats2bfloat162_rn(acc[4 * nb + 2 * r] + b0, acc[4 * nb + 2 * r + 1] + b1);
        }
      }
    }
  };

  float acc0[32], acc1[32];
  mbar_wait(x_full, 0);
  issue(acc0, 0);
  for (int j = 0; j < n_tiles; j += 2) {
    if (j + 1 < n_tiles) {
      issue(acc1, j + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    finish(acc0, j);
    if (j + 1 < n_tiles) {
      if (j + 2 < n_tiles) {
        issue(acc0, j + 2);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      finish(acc1, j + 1);
    }
  }
}

// The tensor map of a bf16 matrix of `rows` rows of K elements, row stride
// ld elements, read in boxes of 64 columns x box_rows rows in the 128-byte
// swizzle; rows >= `rows` read as zero.  Returns a CUDA error code.
inline int encode_rows(CUtensorMap* map, const void* base, int rows, int K, long long ld,
                       int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * 2)};
  const cuuint32_t box[2] = {kLinCols, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Y (M rows, stride ldy) = X (M x K, stride ldx) [W_0 | ... ]^T (+ bias),
// with n_weights weights of n_w rows each (N = n_weights * n_w) and bias
// nullptr or N values.
struct LinearArgs {
  const void* x;
  long long ldx;
  int M, K;
  const void* w[kLinMaxWeights];
  int n_w, n_weights;
  const void* bias;
  void* y;
  long long ldy;
  cudaStream_t stream;
};

template <int K>
int launch_linear_k(const LinearArgs& a, const CUtensorMap& tx, const CUtensorMap (&tw)[3]) {
  constexpr int smem = linear_smem_bytes(K);
  const cudaError_t err = cudaFuncSetAttribute(
      linear_bf16_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_per_w = a.n_w / kLinTileN;
  linear_bf16_kernel<K><<<(a.M + kLinRows - 1) / kLinRows, kLinThreads, smem, a.stream>>>(
      tx, tw[0], tw[1], tw[2], static_cast<__nv_bfloat16*>(a.y), a.ldy,
      static_cast<const __nv_bfloat16*>(a.bias), a.M, a.n_weights * tiles_per_w, tiles_per_w);
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() after the launch, or the error of a shape or
// alignment the kernel does not take.
inline int launch_linear(const LinearArgs& a) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  if (a.M <= 0 || a.K <= 0 || a.K % 64 || a.K > kLinMaxK || a.n_w <= 0 ||
      a.n_w % kLinTileN || a.n_weights < 1 || a.n_weights > kLinMaxWeights) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool ok = aligned(a.x) && aligned(a.y) && a.ldx % 8 == 0 && a.ldy % 8 == 0 && a.ldx >= a.K;
  for (int i = 0; i < a.n_weights; ++i) ok = ok && aligned(a.w[i]);
  if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tx, tw[kLinMaxWeights];
  int rc = encode_rows(&tx, a.x, a.M, a.K, a.ldx, kLinRows);
  for (int i = 0; i < kLinMaxWeights && rc == 0; ++i) {
    if (i < a.n_weights) {
      rc = encode_rows(&tw[i], a.w[i], a.n_w, a.K, a.K, kLinTileN);
    } else {
      tw[i] = tw[0];  // a map the kernel never reads
    }
  }
  if (rc != 0) return rc;
  switch (a.K) {
    case 64: return launch_linear_k<64>(a, tx, tw);
    case 128: return launch_linear_k<128>(a, tx, tw);
    case 192: return launch_linear_k<192>(a, tx, tw);
    case 256: return launch_linear_k<256>(a, tx, tw);
    case 320: return launch_linear_k<320>(a, tx, tw);
    case 384: return launch_linear_k<384>(a, tx, tw);
    default: return launch_linear_k<448>(a, tx, tw);
  }
}

}  // namespace hopper
}  // namespace
