// Train-mode batch norm (flax semantics, models/bn.py) over channel-innermost
// rows, forward and backward, in four launches a call on one process:
//
//   bn_stats_kernel       per-channel sum x, sum x^2 and the row count n
//                         (rows where the row mask holds, or every row), in
//                         f32; the last block to finish combines the blocks'
//                         partials in a fixed order and finalizes: mean,
//                         var = max(E[x^2] - E[x]^2, 0), scale =
//                         rsqrt(var + eps) * gamma, the running stats moved;
//                         across processes it writes the sums instead, which
//                         the wrapper all-reduces before bn_finalize_kernel;
//   bn_apply_kernel       y = relu?((x - mean) * scale + beta), f32 math,
//                         stored in the output's type;
//   bn_bwd_reduce_kernel  per channel over every row: sum g and
//                         sum g * xhat, g = dy * [y > 0] (dy without the
//                         ReLU), y and xhat recomputed from x;
//   bn_bwd_apply_kernel   dx = scale * (g - [row counted] * (sum g
//                         + xhat * sum g xhat) / n); the xhat term drops
//                         where the variance was clamped.
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's, lowered by
// XLA (voxelnet_tpu/models/*.py: nn.BatchNorm). On an H100 the layer is bound
// by device-memory bytes: at bf16, 2 bytes an element read by the
// statistics, 2 read and 2 written by the normalisation, 4 read by the
// backward's reduction and 4 read and 2 written by its apply, 16 in all.
// The design moves those bytes once each: 16-byte loads and stores, no f32
// intermediate in device memory, the ReLU, its gate and the cast fused; the
// backward recomputes xhat and the gate from x instead of reading saved f32
// tensors. Reductions run in a fixed number of blocks that loop over rows,
// summing in registers, then in shared memory by a fixed tree, then across
// blocks in block order, in f64 (no float atomics): two runs are bitwise
// equal.
//
// Layout: x is (rows, C) with C innermost (the VFE's (B, K, T, C), the
// middle's NDHWC behind an NCDHW view, the RPN's NHWC), bf16 or f32; y, dy
// and dx have x's type (the port's callers store the BN's output in its
// input's type, so no other pair is built). A thread owns
// V = 16 / sizeof(element) consecutive channels of a row; L = C / V lanes
// cover a row and must divide the block's 256 threads, so a block reads
// 256 / L rows a pass. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// rows of the per-channel vectors in `stats`
enum { kMean, kInvstd, kScale, kClamped, kCount, kStatRows };

template <typename T>
struct Elems;  // elements in 16 bytes
template <>
struct Elems<__nv_bfloat16> { static constexpr int n = 8; };
template <>
struct Elems<float> { static constexpr int n = 4; };

// the 16 bytes at p (aligned to them) <-> Elems<T>::n floats
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load(const float* p, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// (x - mean) * scale + shift rounded after each operation, as the plain
// version's three f32 tensor ops do (no fused multiply-add)
__device__ __forceinline__ float normalise(float x, float mean, float scale,
                                           float shift) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), shift);
}

struct Finalize {
  const float* weight;  // (C,) gamma
  float* running_mean;  // (C,), moved in place unless `update` is 0
  float* running_var;
  float keep, take, eps;  // running = keep * running + take * batch
  int update;
  float* stats;  // (kStatRows, C) out; nullptr: write `sums` instead
  float* sums;   // (3, C) out: sum x, sum x^2, n (the all-reduce's input)
};

// channel c's statistics from its f32 sums over n rows, in the plain
// version's f32 operations
__device__ void finalize(const Finalize& f, int C, int c, float s1, float s2,
                         float n) {
  const float mean = __fdiv_rn(s1, n), mean2 = __fdiv_rn(s2, n);
  const float raw = __fsub_rn(mean2, __fmul_rn(mean, mean));
  const float var = fmaxf(raw, 0.f);
  const float invstd = rsqrtf(__fadd_rn(var, f.eps));
  f.stats[kMean * C + c] = mean;
  f.stats[kInvstd * C + c] = invstd;
  f.stats[kScale * C + c] = __fmul_rn(invstd, f.weight[c]);
  f.stats[kClamped * C + c] = raw < 0.f ? 1.f : 0.f;
  f.stats[kCount * C + c] = n;
  if (f.update) {
    f.running_mean[c] = __fadd_rn(__fmul_rn(f.keep, f.running_mean[c]),
                                  __fmul_rn(f.take, mean));
    f.running_var[c] = __fadd_rn(__fmul_rn(f.keep, f.running_var[c]),
                                 __fmul_rn(f.take, var));
  }
}

// Sum the per-thread sums a[V], b[V] of a block over its row groups by a
// fixed tree in shared memory; thread t < L then holds channels
// [t * V, t * V + V) of the block's sums in sh_a, sh_b at t * V.
template <int V>
__device__ void block_tree(float (&a)[V], float (&b)[V], float* sh_a,
                           float* sh_b, int L) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sh_a[t * V + k] = a[k];
    sh_b[t * V + k] = b[k];
  }
  __syncthreads();
  for (int s = kThreads / L / 2; s >= 1; s >>= 1) {
    if (t < s * L) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sh_a[t * V + k] += sh_a[(t + s * L) * V + k];
        sh_b[t * V + k] += sh_b[(t + s * L) * V + k];
      }
    }
    __syncthreads();
  }
}

// After each block wrote its partials: true in the last block to finish,
// which then reads every block's partials (the ticket is reset for the
// next launch on the stream).
__device__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block: each channel's sums of the blocks' partials (G, 2, C),
// read as 16-byte words, in block order within each of P parts and then in
// part order, in f64; tot_a and tot_b (C floats of shared memory each) take
// them, then done(c, a, b) runs once a channel.
template <typename Done>
__device__ void combine(const float* partial, int G, int C, float* tot_a,
                        float* tot_b, Done done) {
  __shared__ double red[4][kThreads];
  const int t = threadIdx.x;
  const int words = C / 2;  // 4-float words in a block's 2C partials
  const int width = words < kThreads ? words : kThreads;
  const int parts = kThreads / width, part = t / width;
  for (int e0 = 0; e0 < words; e0 += width) {
    const int e = e0 + t % width;
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 8
    for (int g = part; g < G; g += parts) {
      const float4 v = __ldcg(
          reinterpret_cast<const float4*>(partial + (size_t)g * 2 * C) + e);
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) red[k][t] = acc[k];
    __syncthreads();
    if (part == 0) {
      for (int q = 1; q < parts; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += red[k][q * width + t];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * e + k;
        if (i < C)
          tot_a[i] = (float)acc[k];
        else
          tot_b[i - C] = (float)acc[k];
      }
    }
    __syncthreads();
  }
  for (int c = t; c < C; c += kThreads) done(c, tot_a[c], tot_b[c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                long long rows, int C, float* __restrict__ partial,
                long long* __restrict__ pcount,
                unsigned int* __restrict__ ticket, Finalize f) {
  constexpr int V = Elems<T>::n;
  __shared__ float sh_a[kThreads * V], sh_b[kThreads * V];
  __shared__ long long sh_n[kThreads];
  const int L = C / V, R = kThreads / L;
  const int lane = threadIdx.x % L;
  const long long stride = (long long)gridDim.x * R;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  long long n = 0;
  long long r = (long long)blockIdx.x * R + threadIdx.x / L;
  for (; r < rows; r += kUnroll * stride) {
    float v[kUnroll][V];
    bool m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * stride;
      m[u] = row < rows && (mask == nullptr || mask[row] != 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (m[u]) load(x + (r + u * stride) * C + lane * V, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!m[u]) continue;
      ++n;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += v[u][k];
        s2[k] = fmaf(v[u][k], v[u][k], s2[k]);
      }
    }
  }
  sh_n[threadIdx.x] = lane == 0 ? n : 0;
  block_tree<V>(s1, s2, sh_a, sh_b, L);
  if (threadIdx.x < L) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = threadIdx.x * V + k;
      partial[(size_t)blockIdx.x * 2 * C + c] = sh_a[c];
      partial[(size_t)blockIdx.x * 2 * C + C + c] = sh_b[c];
    }
  }
  if (threadIdx.x == 0) {
    long long total = 0;  // integers: the order does not matter
    for (int g = 0; g < R; ++g) total += sh_n[g * L];
    pcount[blockIdx.x] = total;
  }
  if (!last_block(ticket)) return;

  __shared__ float count;
  if (threadIdx.x == 0) {
    long long total = 0;
    if (mask == nullptr) {
      total = rows;
    } else {
      for (int g = 0; g < (int)gridDim.x; ++g) total += __ldcg(pcount + g);
    }
    count = (float)total;
  }
  __syncthreads();
  const float nf = count;
  combine(partial, gridDim.x, C, sh_a, sh_b, [&](int c, float a, float b) {
    if (f.stats == nullptr) {
      f.sums[c] = a;
      f.sums[C + c] = b;
      f.sums[2 * C + c] = nf;
    } else {
      finalize(f, C, c, a, b, nf);
    }
  });
}

// across processes: the all-reduced sums (3, C) -> stats, running stats
__global__ void __launch_bounds__(kThreads)
bn_finalize_kernel(const float* __restrict__ sums, int C, Finalize f) {
  for (int c = threadIdx.x; c < C; c += kThreads)
    finalize(f, C, c, sums[c], sums[C + c], sums[2 * C + c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ shift, T* __restrict__ y,
                long long vecs, int C, int relu) {
  constexpr int V = Elems<T>::n;
  const int L = C / V;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;  // L divides it
  const int c0 = (int)(t0 % L) * V;
  float mean[V], scale[V], beta[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = stats[kMean * C + c0 + k];
    scale[k] = stats[kScale * C + c0 + k];
    beta[k] = shift[c0 + k];
  }
  for (long long i = t0; i < vecs; i += kUnroll * stride) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < vecs) load(x + (i + u * stride) * V, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride >= vecs) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float out = normalise(v[u][k], mean[k], scale[k], beta[k]);
        // NaN passes, as torch.relu's
        v[u][k] = relu && out < 0.f ? 0.f : out;
      }
      store(y + (i + u * stride) * V, v[u]);
    }
  }
}

// two blocks an SM at least: at bf16 the unrolled loads and the
// per-channel vectors would take more registers than that leaves
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     long long dy_rs, const float* __restrict__ stats,
                     const float* __restrict__ shift, long long rows, int C,
                     int relu, float* __restrict__ partial,
                     unsigned int* __restrict__ ticket,
                     float* __restrict__ out) {
  constexpr int V = Elems<T>::n;
  __shared__ float sh_a[kThreads * V], sh_b[kThreads * V];
  const int L = C / V, R = kThreads / L;
  const int lane = threadIdx.x % L, c0 = lane * V;
  const long long stride = (long long)gridDim.x * R;
  float mean[V], scale[V], beta[V], sg[V], sgt[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = stats[kMean * C + c0 + k];
    scale[k] = stats[kScale * C + c0 + k];
    beta[k] = shift[c0 + k];
    sg[k] = sgt[k] = 0.f;
  }
  long long r = (long long)blockIdx.x * R + threadIdx.x / L;
  for (; r < rows; r += kUnroll * stride) {
    float v[kUnroll][V], g[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * stride;
      if (row < rows) {
        load(x + row * C + c0, v[u]);
        load(dy + row * dy_rs + c0, g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * stride >= rows) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float t = __fsub_rn(v[u][k], mean[k]);
        const float gk =
            relu && !(normalise(v[u][k], mean[k], scale[k], beta[k]) > 0.f)
                ? 0.f
                : g[u][k];
        sg[k] += gk;
        sgt[k] = fmaf(gk, t, sgt[k]);
      }
    }
  }
  block_tree<V>(sg, sgt, sh_a, sh_b, L);
  if (threadIdx.x < L) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = threadIdx.x * V + k;
      partial[(size_t)blockIdx.x * 2 * C + c] = sh_a[c];
      partial[(size_t)blockIdx.x * 2 * C + C + c] = sh_b[c];
    }
  }
  if (!last_block(ticket)) return;
  combine(partial, gridDim.x, C, sh_a, sh_b, [&](int c, float a, float b) {
    out[c] = a;                                         // d beta
    out[C + c] = __fmul_rn(b, stats[kInvstd * C + c]);  // d gamma
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    long long dy_rs, const uint8_t* __restrict__ mask,
                    const float* __restrict__ stats,
                    const float* __restrict__ shift,
                    const float* __restrict__ sums, T* __restrict__ dx,
                    long long vecs, int C, int relu) {
  constexpr int V = Elems<T>::n;
  const int L = C / V;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const int c0 = (int)(t0 % L) * V;
  const int rows_shift = __ffs(L) - 1;  // L is a power of two
  float mean[V], invstd[V], scale[V], beta[V], a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = c0 + k;
    const float n = stats[kCount * C + c];
    mean[k] = stats[kMean * C + c];
    invstd[k] = stats[kInvstd * C + c];
    scale[k] = stats[kScale * C + c];
    beta[k] = shift[c];
    a[k] = sums[c] / n;
    b[k] = stats[kClamped * C + c] != 0.f ? 0.f : sums[C + c] / n;
  }
  for (long long i = t0; i < vecs; i += kUnroll * stride) {
    float v[kUnroll][V], g[kUnroll][V];
    bool counted[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < vecs) {
        load(x + j * V, v[u]);
        const long long row = j >> rows_shift;
        load(dy + row * dy_rs + c0, g[u]);
        counted[u] = mask == nullptr || mask[row] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride >= vecs) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float t = __fsub_rn(v[u][k], mean[k]);
        const float gk =
            relu && !(normalise(v[u][k], mean[k], scale[k], beta[k]) > 0.f)
                ? 0.f
                : g[u][k];
        const float mean_part =
            counted[u] ? fmaf(t * invstd[k], b[k], a[k]) : 0.f;
        v[u][k] = scale[k] * (gk - mean_part);
      }
      store(dx + (i + u * stride) * V, v[u]);
    }
  }
}

template <typename Kernel>
int resident(Kernel* kernel, int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            kThreads, 0);
}

template <typename T>
int blocks_per_sm(int which, int* out) {
  switch (which) {
    case 0: return resident(bn_stats_kernel<T>, out);
    case 1: return resident(bn_apply_kernel<T>, out);
    case 2: return resident(bn_bwd_reduce_kernel<T>, out);
    default: return resident(bn_bwd_apply_kernel<T>, out);
  }
}

template <typename T>
int stats_launch(const void* x, const void* mask, long long rows, int C,
                 void* partial, void* pcount, void* ticket, int blocks,
                 const Finalize& f, cudaStream_t s) {
  bn_stats_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const T*)x, (const uint8_t*)mask, rows, C, (float*)partial,
      (long long*)pcount, (unsigned int*)ticket, f);
  return (int)cudaGetLastError();
}

template <typename T>
int apply_launch(const void* x, const void* stats, const void* shift,
                 void* y, long long vecs, int C, int relu, int blocks,
                 cudaStream_t s) {
  bn_apply_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const T*)x, (const float*)stats, (const float*)shift, (T*)y, vecs, C,
      relu);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_reduce_launch(const void* x, const void* dy, long long dy_rs,
                      const void* stats, const void* shift, long long rows,
                      int C, int relu, void* partial, void* ticket,
                      int blocks, void* out, cudaStream_t s) {
  bn_bwd_reduce_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const T*)x, (const T*)dy, dy_rs, (const float*)stats,
      (const float*)shift, rows, C, relu, (float*)partial,
      (unsigned int*)ticket, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_apply_launch(const void* x, const void* dy, long long dy_rs,
                     const void* mask, const void* stats, const void* shift,
                     const void* sums, void* dx, long long vecs, int C,
                     int relu, int blocks, cudaStream_t s) {
  bn_bwd_apply_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const T*)x, (const T*)dy, dy_rs, (const uint8_t*)mask,
      (const float*)stats, (const float*)shift, (const float*)sums, (T*)dx,
      vecs, C, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// Every tensor but the per-channel f32 vectors has one element type, a code
// here: 1 bf16, 0 f32 (x, y, dy and dx alike).

// Resident blocks an SM of kernel `which` (0 stats, 1 apply, 2 backward
// reduction, 3 backward apply): the wrapper launches that many an SM at
// most, so every block of a grid-stride launch runs in one wave.
extern "C" int bn_blocks_per_sm(int which, int bf16, int* out) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>(which, out)
              : blocks_per_sm<float>(which, out);
}

// x (rows, C), C innermost, C / (16 / element bytes) a power of two <= 256;
// mask (rows,) bytes or null. stats (5, C) or null; then sums (3, C).
extern "C" int bn_stats_launch(const void* x, int bf16, const void* mask,
                               long long rows, int C, void* partial,
                               void* pcount, void* ticket, int blocks,
                               const void* weight, void* running_mean,
                               void* running_var, int update, float keep,
                               float take, float eps, void* stats,
                               void* sums, void* stream) {
  const Finalize f{(const float*)weight, (float*)running_mean,
                   (float*)running_var, keep, take, eps, update,
                   (float*)stats, (float*)sums};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? stats_launch<__nv_bfloat16>(x, mask, rows, C, partial,
                                            pcount, ticket, blocks, f, s)
              : stats_launch<float>(x, mask, rows, C, partial, pcount,
                                    ticket, blocks, f, s);
}

extern "C" int bn_finalize_launch(const void* sums, int C, const void* weight,
                                  void* running_mean, void* running_var,
                                  int update, float keep, float take,
                                  float eps, void* stats, void* stream) {
  const Finalize f{(const float*)weight, (float*)running_mean,
                   (float*)running_var, keep, take, eps, update,
                   (float*)stats, nullptr};
  bn_finalize_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sums, C, f);
  return (int)cudaGetLastError();
}

// vecs = rows * C / (16 / element bytes); y in x's type and layout
extern "C" int bn_apply_launch(const void* x, int bf16, const void* stats,
                               const void* shift, void* y, long long vecs,
                               int C, int relu, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? apply_launch<__nv_bfloat16>(x, stats, shift, y, vecs, C,
                                            relu, blocks, s)
              : apply_launch<float>(x, stats, shift, y, vecs, C, relu,
                                    blocks, s);
}

// dy in x's type, its rows dy_rs elements apart (C where it has x's layout),
// channels innermost; out (2, C): d beta, d gamma
extern "C" int bn_bwd_reduce_launch(const void* x, int bf16, const void* dy,
                                    long long dy_rs, const void* stats,
                                    const void* shift, long long rows, int C,
                                    int relu, void* partial, void* ticket,
                                    int blocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? bwd_reduce_launch<__nv_bfloat16>(x, dy, dy_rs, stats, shift,
                                                 rows, C, relu, partial,
                                                 ticket, blocks, out, s)
              : bwd_reduce_launch<float>(x, dy, dy_rs, stats, shift, rows, C,
                                         relu, partial, ticket, blocks, out,
                                         s);
}

// dy as for the reduction; sums (2, C): d beta and d gamma summed over the
// processes; dx in x's type and layout
extern "C" int bn_bwd_apply_launch(const void* x, int bf16, const void* dy,
                                   long long dy_rs, const void* mask,
                                   const void* stats, const void* shift,
                                   const void* sums, void* dx,
                                   long long vecs, int C, int relu,
                                   int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? bwd_apply_launch<__nv_bfloat16>(x, dy, dy_rs, mask, stats,
                                                shift, sums, dx, vecs, C,
                                                relu, blocks, s)
              : bwd_apply_launch<float>(x, dy, dy_rs, mask, stats, shift,
                                        sums, dx, vecs, C, relu, blocks, s);
}
