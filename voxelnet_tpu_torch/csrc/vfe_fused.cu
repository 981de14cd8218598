// Fused voxel-table + VFE stack: sorted point stream -> voxelwise features.
//
// Replaces the TPU kernel voxelnet_tpu/kernels/vfe_fused.py::_kernel (entry
// voxelize_vfe_fused). It computes the same function, not the TPU layout:
// per voxel, copy its run of at most T sorted points, centroid offsets,
// VFE1 (7->16 dense, ReLU, folded BN, masked max, concat -> 32), VFE2
// (32->64, the same), and emit [agg2, agg2] (128 bf16), zero for empty
// voxels. The voxel table never reaches device memory.
//
// Design: one warp per voxel; lane l holds point slots l and l + 32
// (T <= 64), so the whole per-point MLP lives in registers and the masked
// max over points is a warp shuffle reduction. The folded weights sit in
// shared memory and are read as float4 broadcasts. Voxels with at most 32
// points (almost all of them) skip the second slot.
//
// Rounding follows the TPU kernel: dot inputs rounded to bf16, products
// accumulated in f32, then relu(y + b), then y * scale + shift (separate
// roundings, no FMA contraction), then bf16; the max runs over bf16 values
// of the points t < count. The f32 accumulation order differs from any
// matmul's, so a few outputs land one bf16 ulp away from the plain version.
//
// What bounds it on an H100: arithmetic and shuffles. Reads are ~16 bytes
// per point and 256 bytes are written per voxel (Car, B=8: ~10 MB), while
// each occupied voxel costs ~2.2k FMAs per lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC1 = 16;    // VFE1 units
constexpr int kIn1 = 8;    // 7 point features + 1 zero pad
constexpr int kC2 = 64;    // VFE2 units
constexpr int kIn2 = 32;   // [pointwise 16, aggregate 16]
constexpr int kWarps = 8;  // voxels per block iteration
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// relu(y + bias) * scale + shift, rounded to bf16 (three separate roundings)
__device__ __forceinline__ float affine(float y, const float* a) {
  y = fmaxf(__fadd_rn(y, a[0]), 0.0f);
  return bf16_round(__fadd_rn(__fmul_rn(y, a[1]), a[2]));
}

// sum_i w[i] * x[i] over n (a multiple of 4) weights in shared memory
template <int n>
__device__ __forceinline__ float dot(const float* w, const float* x) {
  float acc = 0.0f;
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < n / 4; ++i) {
    const float4 q = w4[i];
    acc = fmaf(q.x, x[4 * i + 0], acc);
    acc = fmaf(q.y, x[4 * i + 1], acc);
    acc = fmaf(q.z, x[4 * i + 2], acc);
    acc = fmaf(q.w, x[4 * i + 3], acc);
  }
  return acc;
}

// One voxel by one warp. NP = point slots per lane (1: count <= 32, 2: <= 64).
template <int NP>
__device__ void voxel(const float* __restrict__ pts, int n_stride, int start,
                      int cnt, const float* sw1, const float* sa1,
                      const float* sw2, const float* sa2,
                      __nv_bfloat16* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  bool m[NP];
  float x[NP][kIn2];  // [0, 8): point features; then [0, 32): VFE2 input
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int t = lane + 32 * p;
    m[p] = t < cnt;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x[p][c] = m[p] ? pts[(size_t)c * n_stride + start + t] : 0.0f;
  }
  // centroid of the stored points, offsets for stored points only
  const float denom = (float)cnt;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < NP; ++p) s += x[p][c];
    const float cen = __fdiv_rn(warp_sum(s), denom);
#pragma unroll
    for (int p = 0; p < NP; ++p) x[p][4 + c] = m[p] ? x[p][c] - cen : 0.0f;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    x[p][7] = 0.0f;
#pragma unroll
    for (int c = 0; c < 7; ++c) x[p][c] = bf16_round(x[p][c]);
  }

  // VFE1: pointwise 16 channels, then the masked max over the voxel
  float y1[NP][kC1];
#pragma unroll
  for (int c = 0; c < kC1; ++c) {
    float mx = neg_inf();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      y1[p][c] = affine(dot<kIn1>(sw1 + c * kIn1, x[p]), sa1 + 3 * c);
      if (m[p]) mx = fmaxf(mx, y1[p][c]);
    }
    const float agg = warp_max(mx);
#pragma unroll
    for (int p = 0; p < NP; ++p) x[p][kC1 + c] = agg;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int c = 0; c < kC1; ++c) x[p][c] = y1[p][c];

  // VFE2: only the masked max of the pointwise half leaves the kernel
  // (the final voxel max of [pointwise, aggregate] is [agg2, agg2])
  float keep[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 32 * h + j;
      float mx = neg_inf();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float y = affine(dot<kIn2>(sw2 + c * kIn2, x[p]), sa2 + 3 * c);
        if (m[p]) mx = fmaxf(mx, y);
      }
      const float agg = warp_max(mx);
      if (lane == j) keep[h] = agg;
    }
  }
  const __nv_bfloat16 lo = __float2bfloat16_rn(keep[0]);
  const __nv_bfloat16 hi = __float2bfloat16_rn(keep[1]);
  dst[lane] = lo;
  dst[32 + lane] = hi;
  dst[64 + lane] = lo;
  dst[96 + lane] = hi;
}

__global__ void __launch_bounds__(kWarps * 32)
vfe_fused_kernel(const float* __restrict__ planar,    // (B, 4, N)
                 const int* __restrict__ run_start,   // (B, K)
                 const int* __restrict__ num_voxels,  // (B,)
                 const int* __restrict__ counts,      // (B, K)
                 const float* __restrict__ w1,        // (16, 8)
                 const float* __restrict__ a1,        // (16, 3)
                 const float* __restrict__ w2,        // (64, 32)
                 const float* __restrict__ a2,        // (64, 3)
                 __nv_bfloat16* __restrict__ out,     // (B, K, 128)
                 int B, int N, int K) {
  __shared__ __align__(16) float sw1[kC1 * kIn1];
  __shared__ __align__(16) float sw2[kC2 * kIn2];
  __shared__ float sa1[kC1 * 3];
  __shared__ float sa2[kC2 * 3];
  for (int i = threadIdx.x; i < kC1 * kIn1; i += blockDim.x)
    sw1[i] = bf16_round(w1[i]);
  for (int i = threadIdx.x; i < kC2 * kIn2; i += blockDim.x)
    sw2[i] = bf16_round(w2[i]);
  for (int i = threadIdx.x; i < kC1 * 3; i += blockDim.x) sa1[i] = a1[i];
  for (int i = threadIdx.x; i < kC2 * 3; i += blockDim.x) sa2[i] = a2[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long total = (long long)B * K;
  for (long long v = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       v < total; v += (long long)gridDim.x * kWarps) {
    const int b = (int)(v / K);
    const int k = (int)(v - (long long)b * K);
    __nv_bfloat16* dst = out + v * 128;
    const int start = run_start[v];
    // a run never reaches past the stream; clamp so bad input cannot
    // read out of bounds
    int cnt = counts[v];
    cnt = min(cnt, N - start);
    if (k >= num_voxels[b] || cnt <= 0) {
      reinterpret_cast<uint2*>(dst)[lane] = make_uint2(0u, 0u);
      continue;
    }
    const float* pts = planar + (size_t)b * 4 * N;
    if (cnt <= 32)
      voxel<1>(pts, N, start, cnt, sw1, sa1, sw2, sa2, dst);
    else
      voxel<2>(pts, N, start, cnt, sw1, sa1, sw2, sa2, dst);
  }
}

}  // namespace

extern "C" int vfe_fused_launch(const void* planar, const void* run_start,
                                const void* num_voxels, const void* counts,
                                const void* w1, const void* a1,
                                const void* w2, const void* a2, void* out,
                                int B, int N, int K, void* stream) {
  const long long total = (long long)B * K;
  long long blocks = (total + kWarps - 1) / kWarps;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  vfe_fused_kernel<<<(int)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)planar, (const int*)run_start, (const int*)num_voxels,
      (const int*)counts, (const float*)w1, (const float*)a1,
      (const float*)w2, (const float*)a2, (__nv_bfloat16*)out, B, N, K);
  return (int)cudaGetLastError();
}
