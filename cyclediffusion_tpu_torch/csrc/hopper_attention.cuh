// The Hopper main loop of flash attention (sm_90a), shared by the kernels
// that compute softmax(q k^T * scale) v per (batch, head) in bf16: the bf16
// path of K1 and K2 (flash_attention.cu) and the attention step of K3 and K4
// (folded_attention.cu), which launch the same kernel, flash_fwd_bf16_kernel
// at the end of this file, through launch_bf16.
//
// One thread block per (batch*head, 128-row q tile), three warpgroups:
//   * warpgroup 2, the producer: one thread loads the block's q tile once
//     and keeps 128-key tiles of K and V in flight with TMA
//     (cp.async.bulk.tensor) into a ring of kStages stages, each guarded by
//     mbarriers (K full, V full, stage empty); the warpgroup hands most of
//     its registers to the consumers (setmaxnreg).
//   * warpgroups 0 and 1, the consumers: each owns 64 q rows and reads every
//     K/V tile of the ring, so the block re-reads K and V from L2 once per
//     128 q rows.  S = Q K^T is one wgmma m64n128k16 per 16 head columns
//     (A = the q tile, B = the K tile, both in shared memory); the online
//     softmax runs on S's accumulator fragments in registers and turns them
//     into P's A fragments (bf16); O += P V is one wgmma m64nDk16 per 16
//     keys with A = P from registers and B = the V tile as it lies in memory
//     (MN-major, no transpose).  N = D there, so d = 40 is not padded.
//     Within a warpgroup the exponentials of tile j overlap P_{j-1} V_{j-1};
//     between the two, the issue of the products alternates (ping-pong).
//
// Shared-memory layout.  Every operand tile is stored as 16-column chunks
// of [rows][16] bf16 with TMA's 32-byte swizzle: a head row of 80 or 160
// bytes (d = 40, 80) fits no swizzle width, but a 16-column chunk is exactly
// one 32-byte swizzle row and one k16 step of wgmma (d = 32: two whole
// chunks, two k16 steps of S, nothing padded).  TMA zero-fills the
// columns past D (d = 40 -> the chunk 32..47) and the rows past T, so the
// head-dim pad of Q and K reads as zero and the ragged edges need no
// copies; keys >= Tk are still masked to -inf.  The tensor maps are 4-D,
// (D, T, H, B) with the caller's element strides, so a ragged tile never
// reads the next head's or batch's rows.
//
// Softmax: running max m and denominator l in fp32 per row, logits kept
// unscaled and turned into p = 2^(s*c - m*c), c = scale*log2(e), by one FFMA
// and one MUFU ex2 each; p is rounded to bf16 before P V and l sums that
// same rounded p; the normalised output is rounded once.  No atomics: the
// output is bitwise deterministic.
//
// Every definition sits in an anonymous namespace, so each translation unit
// that includes this header gets its own internal copy.

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace hopper {

constexpr int kConsumerWGs = 2;             // consumer warpgroups of 64 q rows
constexpr int kRowsQ = 64 * kConsumerWGs;   // q rows per block
constexpr int kBlockN = 128;                // keys per K/V tile
constexpr int kStages = 4;                  // K/V tiles in flight
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers per thread after setmaxnreg: the producer gives its share to
// the consumers, 128 x 40 + 256 x 232 <= the SM's 65,536 (one block per SM)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kChunkCols = 16;                          // head columns per chunk
constexpr int kChunkBytes = kBlockN * kChunkCols * 2;   // one [128][16] bf16 K/V chunk
constexpr int kQChunkBytes = kRowsQ * kChunkCols * 2;   // one Q chunk

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of the given parity has completed; a barrier that
// never completes (a copy that never lands) traps after 2^28 polls, seconds,
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completion on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
  }
}

// FA3's ping-pong: the two consumer warpgroups take turns issuing their
// products, so that one's softmax runs while the other's products hold the
// tensor cores.  Warpgroup w waits on named barrier 1 + w (barrier 0 is
// __syncthreads'), issues, then passes the turn on the other's barrier.
__device__ __forceinline__ void turn_wait(int wg) {
  static_assert(kConsumerWGs == 2, "the turns alternate between two warpgroups");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor of a 32-byte-swizzled operand; byte
// offsets: lbo between 16-column chunks along M/N (MN-major only; ignored
// for K-major), sbo between groups of 8 rows (8 x 32 bytes)
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

// d (64 x 128) (+)= A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32) += A (registers) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 40) += A (registers) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (registers) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80) += A (registers) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(D == 32 || D == 40 || D == 64 || D == 80,
                "head dims of the SD, LDM and FFHQ/CelebA UNets and the tests");
  if constexpr (D == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (D == 40) {
    wgmma_rs_n40(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n80(d, a, db);
  }
}

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

template <int D>
struct Smem {
  static constexpr int kChunks = (D + kChunkCols - 1) / kChunkCols;  // 2, 3, 4, 5
  static constexpr uint32_t kTileBytes = kChunks * kChunkBytes;       // one K or V tile
  // each chunk is [128 rows][16 columns] bf16 in TMA's 32-byte swizzle
  __nv_bfloat16 q[kChunks][kRowsQ * kChunkCols];
  __nv_bfloat16 k[kStages][kChunks][kBlockN * kChunkCols];
  __nv_bfloat16 v[kStages][kChunks][kBlockN * kChunkCols];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

// the dynamic shared-memory size to launch with: the tiles plus room to
// align them to 1024 bytes (the swizzle pattern is tied to address bits)
template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<D>)) + 1024;
}

template <int D>
__device__ __forceinline__ Smem<D>& smem_tiles(uint8_t* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem<D>*>(raw + pad);
}

// one thread, before the roles split; followed by __syncthreads()
template <int D>
__device__ __forceinline__ void init_barriers(Smem<D>& sm) {
  mbar_init(&sm.q_full, 1);
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&sm.k_full[s], 1);
    mbar_init(&sm.v_full[s], 1);
    mbar_init(&sm.empty[s], kConsumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the producer: one thread
// ---------------------------------------------------------------------------

// Tensor maps are 4-D over (D, T, H, B); a box is 16 columns x 128 rows.
template <int D>
__device__ __forceinline__ void produce(Smem<D>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv, int q0,
                                        int h, int b, int n_tiles) {
  constexpr int C = Smem<D>::kChunks;
  mbar_expect_tx(&sm.q_full, C * kQChunkBytes);
#pragma unroll
  for (int c = 0; c < C; ++c) tma_load_4d(sm.q[c], tq, &sm.q_full, c * kChunkCols, q0, h, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    mbar_wait(&sm.empty[s], phase ^ 1);  // passes at once on the first round
    mbar_expect_tx(&sm.k_full[s], Smem<D>::kTileBytes);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load_4d(sm.k[s][c], tk, &sm.k_full[s], c * kChunkCols, j * kBlockN, h, b);
    }
    mbar_expect_tx(&sm.v_full[s], Smem<D>::kTileBytes);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load_4d(sm.v[s][c], tv, &sm.v_full[s], c * kChunkCols, j * kBlockN, h, b);
    }
  }
}

// ---------------------------------------------------------------------------
// a consumer warpgroup: 64 q rows
// ---------------------------------------------------------------------------

// Accumulator fragments of wgmma m64nN (fp32), thread t of the warpgroup:
// register 4*nb + e holds row 16*(t/32) + (t%32)/4 + 8*(e/2), column
// 8*nb + 2*(t%4) + e%2 -- mma.sync's m16n8 C fragment per 8 columns.  The
// A fragments of P (m64k16 from registers) follow mma.sync's m16n8k16 A
// layout, so S's fragments for keys 16*kk..16*kk+15 become P's kk-th A
// operand without leaving the thread.

// S = Q K^T for one 128-key tile: K-major A and B, one k16 step per
// 16-column chunk; issued, not waited for
template <int C>
__device__ __forceinline__ void issue_scores(float (&sa)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int cc = 0; cc < C; ++cc) {
    wgmma_ss_n128(sa, desc_sw32(q_addr + cc * kQChunkBytes, 16, 256),
                  desc_sw32(k_addr + cc * kChunkBytes, 16, 256), cc > 0);
  }
}

// O += P V for one tile: A = P from registers, B = the V tile, MN-major;
// issued, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_rs<D>(o, pa[kk], desc_sw32(v_addr + kk * 16 * kChunkCols * 2, kChunkBytes, 256));
  }
}

// The online-softmax step on one tile of raw logits: masks keys >=
// n_valid, updates the running max m, returns alpha = 2^((m_old - m)*c) per
// row (0 on the first tile) with l already scaled by it, and overwrites sa
// with p = 2^(s*c - m*c) in fp32.
__device__ __forceinline__ void softmax_exp(float (&sa)[64], int n_valid, int c2,
                                            float scale_log2, float (&m)[2], float (&l)[2],
                                            float (&alpha)[2]) {
  if (n_valid < kBlockN) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (8 * (i >> 2) + c2 + (i & 1) >= n_valid) sa[i] = -INFINITY;
    }
  }
  // four independent chains per row keep the reduction off the latency path
  float mc[2][4] = {{-INFINITY, -INFINITY, -INFINITY, -INFINITY},
                    {-INFINITY, -INFINITY, -INFINITY, -INFINITY}};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    mc[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mc[(i >> 1) & 1][(i >> 2) & 3], sa[i]);
  }
  float mx[2], msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(mc[r][0], mc[r][1]), fmaxf(mc[r][2], mc[r][3]));
    // a row's 128 columns are spread over the 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile has a real key
    alpha[r] = ex2((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    msc[r] = m_new * scale_log2;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) sa[i] = ex2(fmaf(sa[i], scale_log2, -msc[(i >> 1) & 1]));
}

// p rounded to bf16 into P's A fragments; l sums the rounded p
__device__ __forceinline__ void pack_p(const float (&sa)[64], uint32_t (&pa)[8][4],
                                       float (&l)[2]) {
  float ls[2][4] = {};  // four independent partial sums per row
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 pb = __floats2bfloat162_rn(sa[4 * nb + 2 * r], sa[4 * nb + 2 * r + 1]);
      const uint32_t u = *reinterpret_cast<const uint32_t*>(&pb);
      ls[r][nb & 3] += __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
      // keys 16*kk + [0, 8) fill a0 (row g) / a1 (row g+8); + [8, 16) a2 / a3
      pa[nb >> 1][(nb & 1) * 2 + r] = u;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]);
}

// The tiles run as a software pipeline (FA3's intra-warpgroup overlap):
// while P_{j-1} V_{j-1} runs on the tensor cores, the warpgroup computes
// the exponentials of tile j, whose S = Q K_j^T was issued just before.
// Each issue of products sits between turn_wait and turn_pass.
template <int D>
__device__ __forceinline__ void consume(Smem<D>& sm, int wg, int q0, int Tq, int Tk,
                                        int n_tiles, float scale_log2,
                                        __nv_bfloat16* __restrict__ ob, long long so_t) {
  constexpr int C = Smem<D>::kChunks;
  constexpr int NO = D / 2;  // O accumulator registers per thread
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the unscaled logits
  float l[2] = {0.f, 0.f};              // this thread's part of the denominators
  float alpha[2];
  float sa[64];
  uint32_t pa[8][4];

  const uint32_t q_addr = smem_u32(sm.q[0]) + wg * 64 * kChunkCols * 2;
  mbar_wait(&sm.q_full, 0);
  // each warpgroup issues n_tiles + 1 times; warpgroup 0 goes first
  if (wg == 1) turn_pass(wg);

  // tile 0: scores, exponentials, P
  mbar_wait(&sm.k_full[0], 0);
  turn_wait(wg);
  wgmma_fence();
  issue_scores<C>(sa, q_addr, smem_u32(sm.k[0][0]));
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(sa);
  softmax_exp(sa, Tk, c2, scale_log2, m, l, alpha);  // o is still 0: no rescale
  pack_p(sa, pa, l);

  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int sp = (j - 1) % kStages;
    mbar_wait(&sm.k_full[s], (j / kStages) & 1);
    mbar_wait(&sm.v_full[sp], ((j - 1) / kStages) & 1);
    turn_wait(wg);
    wgmma_fence();
    issue_scores<C>(sa, q_addr, smem_u32(sm.k[s][0]));
    wgmma_commit();
    issue_pv<D>(o, pa, smem_u32(sm.v[sp][0]));
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
    fence_regs(sa);
    softmax_exp(sa, Tk - j * kBlockN, c2, scale_log2, m, l, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&sm.empty[sp]);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p(sa, pa, l);
  }

  const int sl = (n_tiles - 1) % kStages;
  mbar_wait(&sm.v_full[sl], ((n_tiles - 1) / kStages) & 1);
  turn_wait(wg);
  wgmma_fence();
  issue_pv<D>(o, pa, smem_u32(sm.v[sl][0]));
  wgmma_commit();
  // warpgroup 1's last pass would have no turn to meet
  if (wg == 0) turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  mbar_arrive(&sm.empty[sl]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row_lo = q0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < Tq) {
        const __nv_bfloat162 out = __floats2bfloat162_rn(o[4 * nb + 2 * r] / l[r],
                                                         o[4 * nb + 2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(ob + row * so_t + 8 * nb + c2) = out;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda)
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 (B, H, T, D) operand with element strides (sb,
// sh, st) and a contiguous head dim, read in boxes of 16 columns x rows.
// Columns >= D and rows >= T read as zero.  A dim of size 1 takes any
// stride TMA accepts.  Returns a CUDA error code.
inline int encode_operand(CUtensorMap* map, const void* base, int B, int H, int T, int D,
                          long long sb, long long sh, long long st, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto bytes = [](long long stride, int n) {
    return static_cast<cuuint64_t>(n == 1 ? 16 : stride * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st, T), bytes(sh, H), bytes(sb, B)};
  const cuuint32_t box[4] = {kChunkCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// the kernel and its launcher
// ---------------------------------------------------------------------------

// Element strides of a (batch, head, row) triple; the head dim is contiguous.
struct Strides {
  long long b, h, t;
};

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

// One block per (128-row q tile, batch*head); o may be q itself (the block
// has read its q tile before it writes the same rows and columns of o).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, int H, int Tq, int Tk,
                          float scale_log2, Strides so) {
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = smem_tiles<D>(smem_raw);
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * kRowsQ;
  const int n_tiles = (Tk + kBlockN - 1) / kBlockN;
  if (threadIdx.x == 0) init_barriers(sm);
  __syncthreads();
  // one if/else for the whole lifetime of each role, as setmaxnreg needs
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) produce<D>(sm, &tm_q, &tm_k, &tm_v, q0, h, b, n_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D>(sm, threadIdx.x / 128, q0, Tq, Tk, n_tiles, scale_log2, o + b * so.b + h * so.h,
               so.t);
  }
}

// bf16 q, k, v, o as (B, H, T, D) with the given element strides, 16-byte
// aligned bases and strides in multiples of 8 (the caller checks); returns
// cudaGetLastError() after the launch or the encoder's error.
template <int D>
int launch_bf16(const Args& a) {
  CUtensorMap tq, tk, tv;
  int rc = encode_operand(&tq, a.q, a.B, a.H, a.Tq, D, a.sq.b, a.sq.h, a.sq.t, kRowsQ);
  if (rc == 0) rc = encode_operand(&tk, a.k, a.B, a.H, a.Tk, D, a.sk.b, a.sk.h, a.sk.t, kBlockN);
  if (rc == 0) rc = encode_operand(&tv, a.v, a.B, a.H, a.Tk, D, a.sv.b, a.sv.h, a.sv.t, kBlockN);
  if (rc != 0) return rc;
  constexpr int smem = smem_bytes<D>();
  auto kernel = flash_fwd_bf16_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tq + kRowsQ - 1) / kRowsQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, a.stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.H,
                                             a.Tq, a.Tk,
                                             static_cast<float>(a.scale * 1.4426950408889634),
                                             a.so);
  return static_cast<int>(cudaGetLastError());
}

// launch_bf16 for a head dim known at run time
inline int launch_bf16_d(const Args& a, int D) {
  switch (D) {
    case 32: return launch_bf16<32>(a);
    case 40: return launch_bf16<40>(a);
    case 64: return launch_bf16<64>(a);
    case 80: return launch_bf16<80>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace hopper
}  // namespace
