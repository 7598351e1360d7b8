// GroupNorm, with an optional SiLU epilogue, on channels-last activations,
// forward and backward, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA.  It
// was added for the port's layout and occupancy.  PyTorch's CUDA GroupNorm
// reads NCHW only, so each call turned the UNet's and the KL-f8 stacks'
// activations back to NCHW, and cuDNN's Hopper convolutions (NHWC) then
// converted every input, filter and output; its moments kernel also runs
// one block per (sample, group), 32 blocks on 132 SMs at batch 1.  Here x is
// read as (N, HW, C) in memory, C fastest, and the result is written the
// same way, so the convolutions around it stay channels-last.
//
// What bounds it on the H100: bytes.  A few flops per element against
// 2-4 bytes moved.  The forward reads x twice and writes y once (the KL-f8
// decoder at 512 px normalises ~459 M elements a call, 0.8 ms at 3.35 TB/s
// in bf16); the backward reads x and dy twice and writes dx once.
//
// Design:
//   * forward, three launches: (1) statistics.  The pixels of each sample
//     are split into chunks, one block per (chunk, sample), enough blocks to
//     fill the card whatever N * G is.  A thread owns V consecutive channels
//     (a 16-byte vector where C and the base allow, two for float32 where C
//     is too wide for one block otherwise) and a row of pixels; it
//     sums x - s and (x - s)^2 per channel in fp32, s its first value, and
//     its moments are merged over the block's rows (a pairwise tree) and then
//     over each group's channels by Chan's formula in shared memory, into one
//     (count, mean, M2) partial per (sample, group, chunk).
//     (2) one block per (sample, group) merges its chunks' partials in a
//     fixed order into fp32 mean and rstd, the counts in double there (a
//     group may pass 2^24 elements, where fp32 stops counting exactly; the
//     wrapper keeps each chunk below it).  (3) the normalisation, y = x a + b with
//     a = rstd * gamma and b = beta - mean * a per channel, rounded once to
//     the input dtype; SiLU, where fused, is applied to that rounded value.
//   * backward, three launches of the same shape: (1) per (chunk, sample) and
//     channel, the sums of dz and dz * x_hat, where dz is dy through the
//     SiLU's derivative (recomputed from x, mean and rstd when fused) or dy;
//     (2) those sums over the chunks in a fixed order, and over the samples
//     into dgamma and dbeta when they are asked for; (3) dx = rstd * (gamma dz
//     - mean(gamma dz) - x_hat mean(gamma dz x_hat)) over each group.
//   * no atomics: every sum is taken in an order fixed by the shapes, so two
//     calls give the same bits, and the kernels capture into CUDA graphs
//     (the wrapper allocates every buffer).
//
// The plain version and the wrapper are ops/group_norm.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;  // the wrapper keeps (C / V) * rows within it
constexpr int kFinalizeThreads = 256;  // one block per (sample, group)
constexpr int kReduceCols = 32;   // channels per backward-reduce block
constexpr int kReduceRows = 32;   // chunk slices per backward-reduce block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise update: a and b summarise disjoint sets.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, a.mean + d * wb, a.m2 + b.m2 + d * d * a.n * wb};
}

// The finalize's merge: the counts of a whole group, in double.  Where they
// stay below 2^24 it gives merge()'s bits (a division of two exact values
// rounded from double to float is the float division).
struct WideMoments {
  double n;
  float mean, m2;
};

__device__ __forceinline__ WideMoments merge_wide(WideMoments a, WideMoments b) {
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  const double n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float wb = static_cast<float>(b.n / n);
  return {n, a.mean + d * wb, a.m2 + b.m2 + d * d * static_cast<float>(a.n) * wb};
}

struct Geo {
  int N;         // samples
  long long HW;  // pixels a sample
  int C, G, Cg;  // channels, groups, channels a group
  int K;         // chunks a sample
  long long P;   // pixels a chunk (the last one may be shorter)
  int rows;      // pixel rows a block; blockDim.x = (C / V) * rows
};

// z / (1 + exp(-z)) for SiLU (x = z) and the logistic function (x = 1):
// for 16-bit data with the fast exponential and division, whose error (a
// few fp32 ulps) lies far below a bf16 or fp16 rounding; for float32 data
// with the accurate ones, as PyTorch's SiLU.  For z below ~-88 the
// exponential is inf and it gives 0.
template <typename T>
__device__ __forceinline__ float over_one_plus_exp(float x, float z) {
  if constexpr (std::is_same<T, float>::value) {
    return x / (1.f + expf(-z));
  } else {
    return __fdividef(x, 1.f + __expf(-z));
  }
}

template <typename T>
__device__ __forceinline__ float silu_f(float z) { return over_one_plus_exp<T>(z, z); }

template <typename T>
__device__ __forceinline__ float silu_grad(float z) {
  const float s = over_one_plus_exp<T>(1.f, z);
  return s * (1.f + z * (1.f - s));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Block (chunk k, sample n) -> part[((n * G + g) * K + k) * 3 + {0,1,2}] =
// (count, mean, M2) of group g over the chunk's pixels.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ part, Geo g) {
  extern __shared__ float sm[];
  const int cv = g.C / V;
  const int slot = threadIdx.x % cv, row = threadIdx.x / cv;
  const int k = blockIdx.x, n = blockIdx.y;
  const long long p1 = min((long long)(k + 1) * g.P, g.HW);
  const T* xs = x + (long long)n * g.HW * g.C + slot * V;

  // per channel, sums of d = x - shift and d^2, shift the thread's first
  // value: no division in the loop, and little cancellation (d ~ std)
  float cnt = 0.f, shift[V], s1[V], s2[V];
  long long p = (long long)k * g.P + row;
  const long long step = g.rows;
  {
    const bool any = p < p1;
    Pack<T, V> a;
    if (any) a = load<T, V>(xs + p * g.C);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      shift[v] = any ? to_f(a.v[v]) : 0.f;
      s1[v] = s2[v] = 0.f;
    }
  }
  auto update = [&](const Pack<T, V>& a) {
    cnt += 1.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = to_f(a.v[v]) - shift[v];
      s1[v] += d;
      s2[v] = fmaf(d, d, s2[v]);
    }
  };
  for (; p + 3 * step < p1; p += 4 * step) {
    Pack<T, V> a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = load<T, V>(xs + (p + u * step) * g.C);
#pragma unroll
    for (int u = 0; u < 4; ++u) update(a[u]);
  }
  for (; p < p1; p += step) update(load<T, V>(xs + p * g.C));

  // rows (a pairwise tree) -> channels -> groups, in shared memory, in an
  // order fixed by the shapes
  float* smean = sm;
  float* sm2 = sm + g.rows * g.C;
  float* scnt = sm + 2 * g.rows * g.C;
  const float inv = cnt > 0.f ? 1.f / cnt : 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    smean[row * g.C + slot * V + v] = shift[v] + s1[v] * inv;
    sm2[row * g.C + slot * V + v] = fmaxf(s2[v] - s1[v] * s1[v] * inv, 0.f);
  }
  if (slot == 0) scnt[row] = cnt;
  __syncthreads();
  for (int s = 1; s < g.rows; s *= 2) {
    const int pairs = (g.rows - s + 2 * s - 1) / (2 * s);
    for (int j = threadIdx.x; j < pairs * g.C; j += blockDim.x) {
      const int r = (j / g.C) * 2 * s, i = r * g.C + j % g.C, o = i + s * g.C;
      const Moments m = merge({scnt[r], smean[i], sm2[i]}, {scnt[r + s], smean[o], sm2[o]});
      smean[i] = m.mean;
      sm2[i] = m.m2;
    }
    __syncthreads();
    if (threadIdx.x < pairs) scnt[threadIdx.x * 2 * s] += scnt[threadIdx.x * 2 * s + s];
    __syncthreads();
  }
  const float total = scnt[0];
  for (int gi = threadIdx.x; gi < g.G; gi += blockDim.x) {
    const int c0 = gi * g.Cg;
    Moments m{total, smean[c0], sm2[c0]};
    for (int j = 1; j < g.Cg; ++j) m = merge(m, {total, smean[c0 + j], sm2[c0 + j]});
    float* out = part + (((long long)n * g.G + gi) * g.K + k) * 3;
    out[0] = m.n;
    out[1] = m.mean;
    out[2] = m.m2;
  }
}

// One block per (sample, group): its K partials, thread-strided, then a
// shuffle tree in each warp and one over the warps, into mean and
// rstd = 1 / sqrt(var + eps) (biased variance).
__global__ void __launch_bounds__(kFinalizeThreads)
group_norm_finalize_kernel(const float* __restrict__ part, float* __restrict__ mean,
                           float* __restrict__ rstd, int K, float eps) {
  __shared__ WideMoments warps[kFinalizeThreads / 32];
  const int w = blockIdx.x, lane = threadIdx.x % 32;
  const float* p = part + (long long)w * K * 3;
  WideMoments m{0.0, 0.f, 0.f};
  for (int k = threadIdx.x; k < K; k += kFinalizeThreads)
    m = merge_wide(m, WideMoments{p[3 * k], p[3 * k + 1], p[3 * k + 2]});
  auto tree = [&]() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const WideMoments o{__shfl_down_sync(0xffffffffu, m.n, off),
                          __shfl_down_sync(0xffffffffu, m.mean, off),
                          __shfl_down_sync(0xffffffffu, m.m2, off)};
      m = merge_wide(m, o);
    }
  };
  tree();
  if (lane == 0) warps[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kFinalizeThreads / 32 ? warps[threadIdx.x]
                                            : WideMoments{0.0, 0.f, 0.f};
    tree();
    if (threadIdx.x == 0) {
      mean[w] = m.mean;
      rstd[w] = rsqrtf(fmaxf(static_cast<float>(m.m2 / m.n), 0.f) + eps);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                        const T* __restrict__ beta, const float* __restrict__ mean,
                        const float* __restrict__ rstd, T* __restrict__ y, Geo g, int silu) {
  const int cv = g.C / V;
  const int slot = threadIdx.x % cv, row = threadIdx.x / cv;
  const int k = blockIdx.x, n = blockIdx.y;
  float a[V], b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = slot * V + v, gi = n * g.G + c / g.Cg;
    a[v] = rstd[gi] * to_f(gamma[c]);
    b[v] = to_f(beta[c]) - mean[gi] * a[v];
  }
  const long long p1 = min((long long)(k + 1) * g.P, g.HW);
  const long long base = (long long)n * g.HW * g.C + slot * V;
  auto apply = [&](const Pack<T, V>& in, long long pix) {
    Pack<T, V> out;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T r = from_f<T>(fmaf(to_f(in.v[v]), a[v], b[v]));
      if (silu) r = from_f<T>(silu_f<T>(to_f(r)));
      out.v[v] = r;
    }
    *reinterpret_cast<Pack<T, V>*>(y + base + pix * g.C) = out;
  };
  long long p = (long long)k * g.P + row;
  const long long step = g.rows;
  for (; p + 3 * step < p1; p += 4 * step) {
    Pack<T, V> in[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) in[u] = load<T, V>(x + base + (p + u * step) * g.C);
#pragma unroll
    for (int u = 0; u < 4; ++u) apply(in[u], p + u * step);
  }
  for (; p < p1; p += step) apply(load<T, V>(x + base + p * g.C), p);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The per-thread constants of its V channels: the group's mean and rstd,
// gamma and, for the SiLU's derivative, the forward's a and b.
template <typename T, int V>
struct ChannelConsts {
  float mu[V], r[V], gam[V], a[V], b[V];
  __device__ __forceinline__ void load_for(const T* gamma, const T* beta, const float* mean,
                                           const float* rstd, const Geo& g, int n, int slot) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = slot * V + v, gi = n * g.G + c / g.Cg;
      mu[v] = mean[gi];
      r[v] = rstd[gi];
      gam[v] = to_f(gamma[c]);
      a[v] = r[v] * gam[v];
      b[v] = to_f(beta[c]) - mu[v] * a[v];
    }
  }
  __device__ __forceinline__ float dz(int v, float xv, float dyv, int silu) const {
    return silu ? dyv * silu_grad<T>(fmaf(xv, a[v], b[v])) : dyv;
  }
};

// Block (chunk k, sample n) -> the chunk's per-channel sums of dz and of
// dz * x_hat: part[(n * K + k) * C + c] and part[N * K * C + (n * K + k) * C + c].
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_backward_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                 const T* __restrict__ gamma, const T* __restrict__ beta,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd, float* __restrict__ part,
                                 Geo g, int silu) {
  extern __shared__ float sm[];
  const int cv = g.C / V;
  const int slot = threadIdx.x % cv, row = threadIdx.x / cv;
  const int k = blockIdx.x, n = blockIdx.y;
  ChannelConsts<T, V> cc;
  cc.load_for(gamma, beta, mean, rstd, g, n, slot);
  float s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
  auto update = [&](const Pack<T, V>& xa, const Pack<T, V>& da) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xv = to_f(xa.v[v]);
      const float d = cc.dz(v, xv, to_f(da.v[v]), silu);
      s1[v] += d;
      s2[v] += d * ((xv - cc.mu[v]) * cc.r[v]);
    }
  };
  const long long p1 = min((long long)(k + 1) * g.P, g.HW);
  const long long base = (long long)n * g.HW * g.C + slot * V;
  long long p = (long long)k * g.P + row;
  const long long step = g.rows;
  for (; p + step < p1; p += 2 * step) {
    const Pack<T, V> x0 = load<T, V>(x + base + p * g.C);
    const Pack<T, V> d0 = load<T, V>(dy + base + p * g.C);
    const Pack<T, V> x1 = load<T, V>(x + base + (p + step) * g.C);
    const Pack<T, V> d1 = load<T, V>(dy + base + (p + step) * g.C);
    update(x0, d0);
    update(x1, d1);
  }
  for (; p < p1; p += step)
    update(load<T, V>(x + base + p * g.C), load<T, V>(dy + base + p * g.C));

  float* t1 = sm;
  float* t2 = sm + g.rows * g.C;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    t1[row * g.C + slot * V + v] = s1[v];
    t2[row * g.C + slot * V + v] = s2[v];
  }
  __syncthreads();
  const long long out = ((long long)n * g.K + k) * g.C;
  const long long second = (long long)g.N * g.K * g.C;
  for (int c = threadIdx.x; c < g.C; c += blockDim.x) {
    float a1 = t1[c], a2 = t2[c];
    for (int r = 1; r < g.rows; ++r) {
      a1 += t1[r * g.C + c];
      a2 += t2[r * g.C + c];
    }
    part[out + c] = a1;
    part[second + out + c] = a2;
  }
}

// Blocks of 32 channels x 32 chunk slices: sums[n * C + c] (dz) and
// sums[N * C + n * C + c] (dz * x_hat) over the chunks; with dgamma, the same
// over the samples into dgamma (dz * x_hat) and dbeta (dz), in fp32.
__global__ void __launch_bounds__(kReduceCols * kReduceRows)
group_norm_backward_reduce_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                  float* __restrict__ dgamma, float* __restrict__ dbeta,
                                  int N, int K, int C) {
  __shared__ float r1[kReduceRows][kReduceCols], r2[kReduceRows][kReduceCols];
  const int tx = threadIdx.x % kReduceCols, ty = threadIdx.x / kReduceCols;
  const int c = blockIdx.x * kReduceCols + tx;
  const long long second = (long long)N * K * C;
  float acc_g = 0.f, acc_b = 0.f;
  for (int n = 0; n < N; ++n) {
    float a1 = 0.f, a2 = 0.f;
    if (c < C) {
      for (int k = ty; k < K; k += kReduceRows) {
        const long long i = ((long long)n * K + k) * C + c;
        a1 += part[i];
        a2 += part[second + i];
      }
    }
    r1[ty][tx] = a1;
    r2[ty][tx] = a2;
    __syncthreads();
    if (ty == 0 && c < C) {
      float t1 = r1[0][tx], t2 = r2[0][tx];
      for (int j = 1; j < kReduceRows; ++j) {
        t1 += r1[j][tx];
        t2 += r2[j][tx];
      }
      sums[(long long)n * C + c] = t1;
      sums[(long long)N * C + (long long)n * C + c] = t2;
      acc_b += t1;
      acc_g += t2;
    }
    __syncthreads();
  }
  if (dgamma != nullptr && ty == 0 && c < C) {
    dgamma[c] = acc_g;
    dbeta[c] = acc_b;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_backward_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                 const T* __restrict__ gamma, const T* __restrict__ beta,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 const float* __restrict__ sums, T* __restrict__ dx, Geo g,
                                 int silu) {
  extern __shared__ float sm[];  // per group: mean(gamma dz), mean(gamma dz x_hat)
  const int cv = g.C / V;
  const int slot = threadIdx.x % cv, row = threadIdx.x / cv;
  const int k = blockIdx.x, n = blockIdx.y;
  const float inv_m = 1.f / (float)((double)g.HW * g.Cg);
  for (int gi = threadIdx.x; gi < g.G; gi += blockDim.x) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < g.Cg; ++j) {
      const int c = gi * g.Cg + j;
      const float gm = to_f(gamma[c]);
      sa += gm * sums[(long long)n * g.C + c];
      sb += gm * sums[(long long)g.N * g.C + (long long)n * g.C + c];
    }
    sm[gi] = sa * inv_m;
    sm[g.G + gi] = sb * inv_m;
  }
  __syncthreads();
  ChannelConsts<T, V> cc;
  cc.load_for(gamma, beta, mean, rstd, g, n, slot);
  float ma[V], mb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int gi = (slot * V + v) / g.Cg;
    ma[v] = sm[gi];
    mb[v] = sm[g.G + gi];
  }
  const long long p1 = min((long long)(k + 1) * g.P, g.HW);
  const long long base = (long long)n * g.HW * g.C + slot * V;
  auto apply = [&](const Pack<T, V>& xa, const Pack<T, V>& da, long long pix) {
    Pack<T, V> out;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xv = to_f(xa.v[v]);
      const float d = cc.dz(v, xv, to_f(da.v[v]), silu);
      const float xh = (xv - cc.mu[v]) * cc.r[v];
      out.v[v] = from_f<T>(cc.r[v] * (cc.gam[v] * d - ma[v] - xh * mb[v]));
    }
    *reinterpret_cast<Pack<T, V>*>(dx + base + pix * g.C) = out;
  };
  long long p = (long long)k * g.P + row;
  const long long step = g.rows;
  for (; p + step < p1; p += 2 * step) {
    const Pack<T, V> x0 = load<T, V>(x + base + p * g.C);
    const Pack<T, V> d0 = load<T, V>(dy + base + p * g.C);
    const Pack<T, V> x1 = load<T, V>(x + base + (p + step) * g.C);
    const Pack<T, V> d1 = load<T, V>(dy + base + (p + step) * g.C);
    apply(x0, d0, p);
    apply(x1, d1, p + step);
  }
  for (; p < p1; p += step)
    apply(load<T, V>(x + base + p * g.C), load<T, V>(dy + base + p * g.C), p);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Launch {
  Geo g;
  dim3 grid, block;
  cudaStream_t stream;
};

Launch make_launch(int N, long long HW, int C, int G, int K, long long P, int rows, int vec,
                   void* stream) {
  Launch l;
  l.g = Geo{N, HW, C, G, C / G, K, P, rows};
  l.grid = dim3(K, N);
  l.block = dim3((C / vec) * rows);
  l.stream = static_cast<cudaStream_t>(stream);
  return l;
}

bool valid(const Launch& l, int vec) {
  const Geo& g = l.g;
  return g.N > 0 && g.HW > 0 && g.G > 0 && g.C % g.G == 0 && g.C % vec == 0 && g.K > 0 &&
         g.P > 0 && g.rows > 0 && (long long)g.K * g.P >= g.HW &&
         (long long)(g.K - 1) * g.P < g.HW && (int)l.block.x <= kMaxThreads &&
         g.N <= 65535;
}

template <typename T, int V>
int forward_t(const void* x, const void* gamma, const void* beta, void* y, float* part,
              float* mean, float* rstd, const Launch& l, float eps, int silu) {
  const size_t smem = (2 * (size_t)l.g.rows * l.g.C + l.g.rows) * sizeof(float);
  group_norm_stats_kernel<T, V><<<l.grid, l.block, smem, l.stream>>>(
      static_cast<const T*>(x), part, l.g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  group_norm_finalize_kernel<<<l.g.N * l.g.G, kFinalizeThreads, 0, l.stream>>>(
      part, mean, rstd, l.g.K, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  group_norm_apply_kernel<T, V><<<l.grid, l.block, 0, l.stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      mean, rstd, static_cast<T*>(y), l.g, silu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int backward_t(const void* x, const void* dy, const void* gamma, const void* beta,
               const float* mean, const float* rstd, void* dx, float* part, float* sums,
               float* dgamma, float* dbeta, const Launch& l, int silu) {
  const size_t smem = 2 * (size_t)l.g.rows * l.g.C * sizeof(float);
  group_norm_backward_stats_kernel<T, V><<<l.grid, l.block, smem, l.stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), mean, rstd, part, l.g, silu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  group_norm_backward_reduce_kernel<<<(l.g.C + kReduceCols - 1) / kReduceCols,
                                      kReduceCols * kReduceRows, 0, l.stream>>>(
      part, sums, dgamma, dbeta, l.g.N, l.g.K, l.g.C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  group_norm_backward_apply_kernel<T, V><<<l.grid, l.block, 2 * l.g.G * sizeof(float),
                                           l.stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), mean, rstd, sums, static_cast<T*>(dx), l.g, silu);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32, 1 bfloat16, 2 float16; vec: 16 bytes' worth, or 1, or
// for float32 also 32 bytes' worth (C / 4 > kMaxThreads: SD's 2560 channels).
template <template <typename, int> class Fn, typename... Args>
int dispatch(int dtype, int vec, Args... args) {
  switch (dtype) {
    case 0:
      if (vec == 8) return Fn<float, 8>::run(args...);
      if (vec == 4) return Fn<float, 4>::run(args...);
      if (vec == 1) return Fn<float, 1>::run(args...);
      break;
    case 1:
      if (vec == 8) return Fn<__nv_bfloat16, 8>::run(args...);
      if (vec == 1) return Fn<__nv_bfloat16, 1>::run(args...);
      break;
    case 2:
      if (vec == 8) return Fn<__half, 8>::run(args...);
      if (vec == 1) return Fn<__half, 1>::run(args...);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int V>
struct Forward {
  template <typename... A>
  static int run(A... a) { return forward_t<T, V>(a...); }
};

template <typename T, int V>
struct Backward {
  template <typename... A>
  static int run(A... a) { return backward_t<T, V>(a...); }
};

}  // namespace

// x, y: (N, HW, C) contiguous; gamma, beta: (C,) in x's dtype; part: N*G*K*3
// floats; mean, rstd: N*G floats (written, kept for the backward).  Chunk k
// of a sample covers pixels [k * P, min((k + 1) * P, HW)).  Returns the CUDA
// error of the launches (0 on success).
extern "C" int cd_group_norm_forward(const void* x, const void* gamma, const void* beta,
                                     void* y, void* part, void* mean, void* rstd, int N,
                                     long long HW, int C, int G, int K, long long P, int rows,
                                     int vec, float eps, int silu, int dtype, void* stream) {
  const Launch l = make_launch(N, HW, C, G, K, P, rows, vec, stream);
  if (!valid(l, vec)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Forward>(dtype, vec, x, gamma, beta, y, static_cast<float*>(part),
                           static_cast<float*>(mean), static_cast<float*>(rstd), l, eps,
                           silu);
}

// x, dy, dx: (N, HW, C) contiguous; mean, rstd from the forward; part:
// 2*N*K*C floats; sums: 2*N*C floats; dgamma, dbeta: C floats each, or both
// null when the weights' gradients are not wanted.
extern "C" int cd_group_norm_backward(const void* x, const void* dy, const void* gamma,
                                      const void* beta, const void* mean, const void* rstd,
                                      void* dx, void* part, void* sums, void* dgamma,
                                      void* dbeta, int N, long long HW, int C, int G, int K,
                                      long long P, int rows, int vec, int silu, int dtype,
                                      void* stream) {
  const Launch l = make_launch(N, HW, C, G, K, P, rows, vec, stream);
  if (!valid(l, vec) || (dgamma == nullptr) != (dbeta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Backward>(dtype, vec, x, dy, gamma, beta, static_cast<const float*>(mean),
                            static_cast<const float*>(rstd), dx, static_cast<float*>(part),
                            static_cast<float*>(sums), static_cast<float*>(dgamma),
                            static_cast<float*>(dbeta), l, silu);
}
