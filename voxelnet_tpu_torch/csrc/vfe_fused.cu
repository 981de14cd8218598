// Fused voxel-table + VFE stack: sorted point stream -> voxelwise features.
//
// Replaces the TPU kernel voxelnet_tpu/kernels/vfe_fused.py::_kernel (entry
// voxelize_vfe_fused). It computes the same function, not the TPU layout:
// per voxel, take its run of at most T sorted points, centroid offsets,
// VFE1 (7->16 dense, ReLU, folded BN, masked max, concat -> 32), VFE2
// (32->64, the same), and emit [agg2, agg2] (128 bf16), zero for empty
// voxels. The voxel table never reaches device memory.
//
// What bounds it on an H100: bytes. It must read the sorted points (16 B
// each), the run starts and counts, and write 256 B per voxel slot (Car,
// B=2: ~10.8 MB, 0.0032 ms at 3.35 TB/s); its 4,320 FLOP per stored point
// take a sixth of that at the tensor cores' bf16 rate. What held the
// first design (a warp per voxel, a point slot per lane) far from that was
// latency: ~85% of its lanes held no point, every lane ran the 2,048-FMA
// VFE2 dot as serial f32 chains, and each voxel paid 80 warp-wide max
// shuffles, at one 256-thread block per SM.
//
// Design: point-major tiles. A block takes a tile of 32 consecutive voxel
// slots of one frame (a persistent grid walks over the tiles). A warp scan
// of their counts gives each voxel its offset in a compacted list of the
// tile's stored points; the block stages them in chunks of at most 256
// rows that hold whole voxels (T <= 127, so a chunk holds at least two),
// with a point -> voxel index. The work then scales with stored points,
// not with voxel slots:
//   - centroids: per voxel, a warp sums its points in f32 and divides by
//     the count (__fdiv_rn);
//   - VFE1 (8 -> 16, zero-padded): one thread per point on CUDA cores; the
//     per-voxel max goes to shared memory with atomicMax on an
//     order-preserving int encoding of the float;
//   - VFE2: the rows [y1, agg1[voxel]] (32 wide, bf16) times the folded w2
//     (32 -> 64) on CUDA cores: a thread takes 8 channels of 4
//     consecutive points, 32 independent f32 FMA chains, each over the 32
//     inputs in order as a plain f32 matmul sums them; the weights sit in
//     shared memory, transposed, and a warp's 8 channel groups read them
//     as 128 contiguous bytes, each weight load serving 4 points. The
//     affine, the ReLU and the bf16 rounding are monotone in the dot
//     product, so the kernel keeps per voxel and channel only the extreme
//     dot product (the max, or the min where the BN scale is negative:
//     merged in registers over the thread's points of one voxel, then
//     atomicMax as above) and applies the affine once per voxel. A max
//     does not depend on order, so the output is deterministic;
//   - output: [agg2, agg2] per voxel with 16-byte stores, the tile's 8 KB
//     contiguous.
// VFE2 is not on the tensor cores: a version with mma.sync m16n8k16
// (bf16 in, f32 accumulate) failed the port's check against the plain
// version on an H100 (one output near zero 2.3e-2 relative off, where the
// check allows 2**-7): the tensor cores' f32 accumulation rounds unlike an
// IEEE FMA chain, and the affine's shift amplifies that where it cancels
// the product. wgmma and TMA would change neither that nor the bound: at
// K = 32 and N = 64 the products are a sixth of the byte bound. On CUDA
// cores they take ~0.008 ms at Car B=2 at the f32 peak (67 TFLOP/s): the
// floor of this design, above the bytes' 0.0032 ms.
//
// Rounding follows the TPU kernel: dot inputs rounded to bf16, products
// accumulated in f32, then relu(y + b), then y * scale + shift (separate
// roundings, no FMA contraction), then bf16; the max runs over the bf16
// values of the stored points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kTileV = 32;       // voxel slots per tile: one per lane
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;    // resident blocks per SM the registers allow
constexpr int kRowsPerThread = 4;  // VFE2 rows a thread reuses weights over
constexpr int kRows = 256;       // stored points per chunk: one per thread
constexpr int kMaxT = 127;       // points per voxel, as the TPU kernel
constexpr int kC1 = 16;          // VFE1 units
constexpr int kIn1 = 8;          // 7 point features + 1 zero pad
constexpr int kC2 = 64;          // VFE2 units
constexpr int kIn2 = 32;         // [pointwise 16, aggregate 16]
constexpr int kRowStride = 24;   // bf16 per staged row: 48 B, 16-byte
                                 // loads without bank conflicts
// keys per voxel of the VFE1 maxima and the VFE2 extremes, padded so that
// the atomics of neighbouring voxels fall in other banks
constexpr int kAgg1Stride = 17;
constexpr int kAgg2Stride = 72;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNegInfKey = (int)0x807fffff;  // key_of(-inf)
static_assert(kRows >= 2 * kMaxT, "a chunk must hold a whole voxel");
static_assert(kRows == kThreads, "one staged point per thread");

struct Smem {
  alignas(16) float w2t[kIn2 * kC2];  // bf16-rounded, [input][channel]
  alignas(16) __nv_bfloat16 y1[kRows * kRowStride];      // VFE1 per point
  alignas(16) __nv_bfloat16 agg1b[kTileV * kRowStride];  // VFE1 max per voxel
  int agg2[kTileV * kAgg2Stride];  // keys of the VFE2 extremes, d * dir2
  int agg1[kTileV * kAgg1Stride];                        // VFE1 max keys
  alignas(16) float w1[kC1 * kIn1];  // bf16-rounded
  float a1[kC1 * 3];
  float bias2[kC2], scale2[kC2], shift2[kC2];
  float dir2[kC2];         // 1 where the VFE2 affine rises with d, else -1
  float px[kRows], py[kRows], pz[kRows];
  float cen[kTileV][3];
  int start[kTileV], cnt[kTileV], off[kTileV + 1];
  unsigned char vox[kRows];
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// signed-int order of the keys = float order (no NaNs here)
__device__ __forceinline__ int key_of(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float float_of(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// relu(y + bias) * scale + shift, rounded to bf16 (three separate roundings)
__device__ __forceinline__ float affine(float y, float bias, float scale,
                                        float shift) {
  y = fmaxf(__fadd_rn(y, bias), 0.0f);
  return bf16_round(__fadd_rn(__fmul_rn(y, scale), shift));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// sum_i w[i] * x[i] over 8 weights in shared memory, one f32 FMA chain
__device__ __forceinline__ float dot8(const float* w, const float (&x)[8]) {
  const float4 p = reinterpret_cast<const float4*>(w)[0];
  const float4 q = reinterpret_cast<const float4*>(w)[1];
  float acc = fmaf(p.x, x[0], 0.0f);
  acc = fmaf(p.y, x[1], acc);
  acc = fmaf(p.z, x[2], acc);
  acc = fmaf(p.w, x[3], acc);
  acc = fmaf(q.x, x[4], acc);
  acc = fmaf(q.y, x[5], acc);
  acc = fmaf(q.z, x[6], acc);
  return fmaf(q.w, x[7], acc);
}

__device__ void load_weights(Smem& sm, const float* __restrict__ w1,
                             const float* __restrict__ a1,
                             const float* __restrict__ w2,
                             const float* __restrict__ a2) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kC1 * kIn1; i += kThreads) sm.w1[i] = bf16_round(w1[i]);
  for (int i = tid; i < kC1 * 3; i += kThreads) sm.a1[i] = a1[i];
  for (int i = tid; i < kC2; i += kThreads) {
    sm.bias2[i] = a2[3 * i];
    sm.scale2[i] = a2[3 * i + 1];
    sm.shift2[i] = a2[3 * i + 2];
    sm.dir2[i] = a2[3 * i + 1] < 0.0f ? -1.0f : 1.0f;
  }
  // w2 transposed and bf16-rounded: w2t[i][c] = w2[c][i]
  for (int i = tid; i < kC2 * kIn2; i += kThreads)
    sm.w2t[(i % kIn2) * kC2 + i / kIn2] = bf16_round(w2[i]);
}

// The 8 VFE2 channels of channel group g: 4g..4g+3 and 32+4g..32+4g+3, so
// that the 8 groups of a warp read 128 contiguous bytes per float4 load
__device__ __forceinline__ int vfe2_channel(int g, int c) {
  return 4 * g + (c < 4 ? c : 28 + c);
}

// VFE2 of the staged rows r0 .. r0 + kRowsPerThread - 1 (those below
// `rows`; r0 is) for channel group g: per channel one f32 FMA chain over
// the 32 inputs in order, as a plain f32 matmul sums them. relu, the affine
// and the bf16 rounding are monotone in the dot product d, rising where the
// BN scale is >= 0 and falling where it is < 0, so the voxel's max of the
// rounded output is that output at the max of d * dir2: only that max is
// kept (sm.agg2), and the output stage applies the affine once per voxel.
// The rows are consecutive, so mostly of one voxel: their maxima merge in
// registers and only a change of voxel costs an atomicMax.
__device__ void vfe2_rows(Smem& sm, int r0, int rows, int g) {
  constexpr int P = kRowsPerThread;
  int v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = r0 + p < rows ? sm.vox[r0 + p] : -1;
  float acc[P][8];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[p][c] = 0.0f;
#pragma unroll
  for (int blk = 0; blk < 4; ++blk) {
    // inputs 8 blk .. 8 blk + 7: the row's own VFE1 output, then its
    // voxel's VFE1 max (rows past the chunk read row r0's voxel)
    uint4 x[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      x[p] = blk < 2 ? *reinterpret_cast<const uint4*>(
                           sm.y1 + (r0 + p) * kRowStride + 8 * blk)
                     : *reinterpret_cast<const uint4*>(
                           sm.agg1b + (v[p] < 0 ? v[0] : v[p]) * kRowStride +
                           8 * (blk - 2));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float* wi = sm.w2t + (8 * blk + e) * kC2;
      const float4 wa = *reinterpret_cast<const float4*>(wi + 4 * g);
      const float4 wb = *reinterpret_cast<const float4*>(wi + 32 + 4 * g);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint32_t word = (&x[p].x)[e >> 1];
        const float xe = __uint_as_float(e & 1 ? word & 0xffff0000u
                                               : word << 16);
        acc[p][0] = fmaf(wa.x, xe, acc[p][0]);
        acc[p][1] = fmaf(wa.y, xe, acc[p][1]);
        acc[p][2] = fmaf(wa.z, xe, acc[p][2]);
        acc[p][3] = fmaf(wa.w, xe, acc[p][3]);
        acc[p][4] = fmaf(wb.x, xe, acc[p][4]);
        acc[p][5] = fmaf(wb.y, xe, acc[p][5]);
        acc[p][6] = fmaf(wb.z, xe, acc[p][6]);
        acc[p][7] = fmaf(wb.w, xe, acc[p][7]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ch = vfe2_channel(g, c);
    const float dir = sm.dir2[ch];
    int cur = v[0];
    int run = key_of(acc[0][c] * dir);
#pragma unroll
    for (int p = 1; p < P; ++p) {
      if (v[p] < 0) continue;   // past the chunk: the rest are too
      const int k = key_of(acc[p][c] * dir);
      if (v[p] == cur) {
        run = max(run, k);
      } else {
        atomicMax(sm.agg2 + cur * kAgg2Stride + ch, run);
        cur = v[p];
        run = k;
      }
    }
    atomicMax(sm.agg2 + cur * kAgg2Stride + ch, run);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
vfe_fused_kernel(const float* __restrict__ planar,    // (B, 4, N)
                 const int* __restrict__ run_start,   // (B, K)
                 const int* __restrict__ num_voxels,  // (B,)
                 const int* __restrict__ counts,      // (B, K)
                 const float* __restrict__ w1,        // (16, 8)
                 const float* __restrict__ a1,        // (16, 3)
                 const float* __restrict__ w2,        // (64, 32)
                 const float* __restrict__ a2,        // (64, 3)
                 __nv_bfloat16* __restrict__ out,     // (B, K, 128)
                 int B, int N, int K, int T) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_weights(sm, w1, a1, w2, a2);   // first read after the tile's sync

  const int tiles_per_frame = (K + kTileV - 1) / kTileV;
  const long long n_tiles = (long long)B * tiles_per_frame;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = (int)(tile / tiles_per_frame);
    const int k0 = (int)(tile - (long long)b * tiles_per_frame) * kTileV;
    const int nk = min(kTileV, K - k0);
    const int nv = min(num_voxels[b], K);
    uint4* dst = reinterpret_cast<uint4*>(out + ((size_t)b * K + k0) * 128);
    if (k0 >= nv) {   // no occupied voxel in the tile
      for (int i = tid; i < nk * 16; i += kThreads)
        dst[i] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }

    // the tile's runs; a run never reaches past the stream, and is clamped
    // so that bad input cannot read out of bounds
    if (warp == 0) {
      const int k = k0 + lane;
      int s = N, c = 0;
      if (k < nv) {
        s = run_start[(size_t)b * K + k];
        c = s >= 0 ? max(min(min(counts[(size_t)b * K + k], T), N - s), 0)
                   : 0;
      }
      int inc = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += t;
      }
      sm.start[lane] = s;
      sm.cnt[lane] = c;
      sm.off[lane + 1] = inc;
      if (lane == 0) sm.off[0] = 0;
    }
    for (int i = tid; i < kTileV * kAgg2Stride; i += kThreads)
      sm.agg2[i] = kNegInfKey;
    __syncthreads();

    // chunks of whole voxels [va, vb) with at most kRows stored points
    for (int va = 0; va < kTileV;) {
      const int base = sm.off[va];
      const bool fits = lane >= va && sm.off[lane + 1] - base <= kRows;
      const int vb = va + __popc(__ballot_sync(kFull, fits));
      const int rows = sm.off[vb] - base;
      if (rows == 0) break;

      // stage: row tid -> its voxel (the last one starting at or before
      // it) and its point
      const int r = base + tid;
      int v = 0;
      float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (tid < rows) {
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (sm.off[v + step] <= r) v += step;
        const float* q = planar + (size_t)b * 4 * N + sm.start[v] +
                         (r - sm.off[v]);
        p = make_float4(__ldg(q), __ldg(q + N), __ldg(q + 2 * (size_t)N),
                        __ldg(q + 3 * (size_t)N));
        sm.px[tid] = p.x;
        sm.py[tid] = p.y;
        sm.pz[tid] = p.z;
        sm.vox[tid] = (unsigned char)v;
      }
      for (int i = tid; i < kTileV * kAgg1Stride; i += kThreads)
        sm.agg1[i] = kNegInfKey;
      __syncthreads();

      // centroids: a warp per voxel
      for (int u = va + warp; u < vb; u += kWarps) {
        const int c = sm.cnt[u];
        if (c == 0) continue;
        const int r0 = sm.off[u] - base;
        float sx = 0.0f, sy = 0.0f, sz = 0.0f;
        for (int t = lane; t < c; t += 32) {
          sx += sm.px[r0 + t];
          sy += sm.py[r0 + t];
          sz += sm.pz[r0 + t];
        }
        sx = warp_sum(sx);
        sy = warp_sum(sy);
        sz = warp_sum(sz);
        if (lane == 0) {
          const float denom = (float)c;
          sm.cen[u][0] = __fdiv_rn(sx, denom);
          sm.cen[u][1] = __fdiv_rn(sy, denom);
          sm.cen[u][2] = __fdiv_rn(sz, denom);
        }
      }
      __syncthreads();

      // VFE1: one thread per point
      if (tid < rows) {
        const float f[kIn1] = {
            bf16_round(p.x), bf16_round(p.y), bf16_round(p.z), bf16_round(p.w),
            bf16_round(p.x - sm.cen[v][0]), bf16_round(p.y - sm.cen[v][1]),
            bf16_round(p.z - sm.cen[v][2]), 0.0f};
        int* agg = sm.agg1 + v * kAgg1Stride;
        uint32_t y[kC1 / 2];
#pragma unroll
        for (int c = 0; c < kC1; c += 2) {
          const float* a = sm.a1 + 3 * c;
          const float y0 = affine(dot8(sm.w1 + c * kIn1, f), a[0], a[1], a[2]);
          const float y1 = affine(dot8(sm.w1 + (c + 1) * kIn1, f), a[3], a[4],
                                  a[5]);
          y[c / 2] = pack_bf16(y0, y1);
          atomicMax(agg + c, key_of(y0));
          atomicMax(agg + c + 1, key_of(y1));
        }
        uint4* row = reinterpret_cast<uint4*>(sm.y1 + tid * kRowStride);
        row[0] = make_uint4(y[0], y[1], y[2], y[3]);
        row[1] = make_uint4(y[4], y[5], y[6], y[7]);
      }
      __syncthreads();

      for (int i = tid; i < (vb - va) * kC1; i += kThreads) {
        const int u = va + i / kC1, c = i % kC1;
        sm.agg1b[u * kRowStride + c] =
            __float2bfloat16_rn(float_of(sm.agg1[u * kAgg1Stride + c]));
      }
      __syncthreads();

      // VFE2: a thread per channel group of kRowsPerThread consecutive
      // rows, 32 such row groups a pass
      for (int r0 = kRowsPerThread * (tid >> 3); r0 < rows;
           r0 += kRowsPerThread * (kThreads / 8))
        vfe2_rows(sm, r0, rows, tid & 7);
      __syncthreads();
      va = vb;
    }

    // [agg2, agg2] per voxel slot, zero where it stores no point: the
    // affine of the kept VFE2 extreme, rounded to bf16
    for (int i = tid; i < nk * 16; i += kThreads) {
      const int u = i >> 4;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (sm.cnt[u] > 0) {
        const int c0 = 8 * (i & 7);
        const int* key = sm.agg2 + u * kAgg2Stride + c0;
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = c0 + 2 * q + e;
            y[e] = affine(float_of(key[2 * q + e]) * sm.dir2[ch],
                          sm.bias2[ch], sm.scale2[ch], sm.shift2[ch]);
          }
          w[q] = pack_bf16(y[0], y[1]);
        }
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
      dst[i] = val;
    }
    __syncthreads();
  }
}

int max_resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vfe_fused_kernel,
                                                  kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace

// planar (B, 4, N) f32, run_start (B, K) i32, num_voxels (B,) i32, counts
// (B, K) i32, folded w1 (16, 8), a1 (16, 3), w2 (64, 32), a2 (64, 3) f32 ->
// out (B, K, 128) bf16; 1 <= T <= 127.
extern "C" int vfe_fused_launch(const void* planar, const void* run_start,
                                const void* num_voxels, const void* counts,
                                const void* w1, const void* a1,
                                const void* w2, const void* a2, void* out,
                                int B, int N, int K, int T, void* stream) {
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((K + kTileV - 1) / kTileV);
  if (tiles == 0) return 0;
  const long long blocks = tiles < max_resident_blocks()
                               ? tiles : (long long)max_resident_blocks();
  vfe_fused_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)planar, (const int*)run_start, (const int*)num_voxels,
      (const int*)counts, (const float*)w1, (const float*)a1,
      (const float*)w2, (const float*)a2, (__nv_bfloat16*)out, B, N, K, T);
  return (int)cudaGetLastError();
}

// info[0..3]: csrc/kernel_info.cuh
extern "C" int vfe_fused_info(int* info) {
  return kernel_attributes(vfe_fused_kernel, kThreads, info);
}
