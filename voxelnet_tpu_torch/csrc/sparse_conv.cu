// Sparse 3x3x3 convolution of the voxel table (middle block 1, the
// `sparse1` lowering): the sum of the per-offset products into the output
// grid, and its gradient.
//
// Replaces XLA code, not a Pallas kernel: the 27 scatter-adds of
// voxelnet_tpu/models/sparse_conv.py::sparse_conv3x3 (:92-108) and the
// gather that JAX's autodiff makes of them. The product vals = feat @ wmat,
// (B, K, 27, C) with o = (kd * 3 + ky) * 3 + kx, is a torch matmul before
// these kernels (kernels/sparse_conv.py).
//
// sparse_conv_fwd_kernel is output-stationary. A block owns a run of
// output sites along x in one (b, oz, oy) row; a site's C channels are
// split into 16-byte chunks, one thread each. The block first copies the
// occupancy map's 9 (kd, ky) rows over its x range (plus one column each
// side) into shared memory, then each thread walks the 27 offsets in
// order, adds the occupied taps' values (widened to f32) into f32
// accumulators that start at 0, adds the f32 bias and writes its chunk
// once. That is the sequence of f32 additions that JAX's 27 sequential
// scatter-adds into a zero buffer make, so the result is bit-equal to them,
// with no atomics and no read-modify-write of the output.
//
// sparse_conv_grad_kernel is voxel-centric, as JAX's autodiff of the
// scatter is: a thread per 16-byte chunk of dvals[b, k, o], which is the
// output cotangent at the site that (k, o) reaches, or 0 where the tap
// misses (depth-stride parity, grid bounds, the x window) or k is padding.
// It moves chunks and never looks at the values, so it serves every type.
//
// What bounds them on an H100: device-memory bytes. At Car B=8 the forward
// writes the (8, 5, 400, 352, 64) bf16 output (721 MB) and reads the
// occupied rows of vals (~370 MB) and the 45 MB map; the gradient writes
// the (8, 16384, 27, 64) bf16 dvals (453 MB) and reads at most as much.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = kThreads;  // sites a block, when a site is 1 chunk

template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void add(float* acc, const uint4& u) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      acc[2 * e] += f.x;
      acc[2 * e + 1] += f.y;
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __halves2bfloat162(__float2bfloat16_rn(v[2 * e]),
                                __float2bfloat16_rn(v[2 * e + 1]));
    return u;
  }
};

template <>
struct Chunk<float> {
  static constexpr int kPer = 4;
  __device__ static void add(float* acc, const uint4& u) {
    acc[0] += __uint_as_float(u.x);
    acc[1] += __uint_as_float(u.y);
    acc[2] += __uint_as_float(u.z);
    acc[3] += __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_conv_fwd_kernel(const uint4* __restrict__ vals,  // (B, K, 27, chunks)
                       const int* __restrict__ occ,     // (B, D, H, W)
                       const float* __restrict__ bias,  // (C,)
                       uint4* __restrict__ out,  // (B, Do, H, wloc, chunks)
                       int K, int D, int H, int W, int Do, int stride_d,
                       int pad_d, int x0, int wloc, int chunks) {
  constexpr int kPer = Chunk<T>::kPer;
  __shared__ int rows[9][kMaxTile + 2];
  const int tile = kThreads / chunks;
  const int b = blockIdx.z;
  const int oz = blockIdx.y / H;
  const int oy = blockIdx.y - oz * H;
  const int ox0 = blockIdx.x * tile;

  // rows[kd * 3 + ky][j]: the voxel row at (oz * s - pad + kd, oy - 1 + ky,
  // x0 + ox0 - 1 + j), or -1 where it is empty or off the grid
  const int* frame = occ + (size_t)b * D * H * W;
  for (int i = threadIdx.x; i < 9 * (tile + 2); i += kThreads) {
    const int r = i / (tile + 2);
    const int j = i - r * (tile + 2);
    const int z = oz * stride_d - pad_d + r / 3;
    const int y = oy - 1 + r % 3;
    const int x = x0 + ox0 - 1 + j;
    int row = -1;
    if (z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W)
      row = frame[((size_t)z * H + y) * W + x];
    rows[r][j] = row;
  }
  __syncthreads();

  const int site = threadIdx.x / chunks;
  const int c = threadIdx.x - site * chunks;
  const int ox = ox0 + site;
  if (site >= tile || ox >= wloc) return;

  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  const uint4* src = vals + (size_t)b * K * 27 * chunks + c;
  for (int o = 0; o < 27; ++o) {
    const int row = rows[o / 3][site + o % 3];
    if (row >= 0) Chunk<T>::add(acc, src[((size_t)row * 27 + o) * chunks]);
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = acc[e] + bias[c * kPer + e];
  out[((((size_t)b * Do + oz) * H + oy) * wloc + ox) * chunks + c] =
      Chunk<T>::pack(acc);
}

// dout (B, Do, H, wloc, chunks) -> dvals (B, K, 27, chunks)
__global__ void __launch_bounds__(kThreads)
sparse_conv_grad_kernel(const uint4* __restrict__ dout,
                        const int* __restrict__ coords,  // (B, K, 3) zyx
                        const int* __restrict__ counts,  // (B, K)
                        uint4* __restrict__ dvals,
                        int B, int K, int Do, int H, int wloc, int stride_d,
                        int pad_d, int x0, int chunks) {
  const size_t total = (size_t)B * K * 27 * chunks;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const size_t r = i / chunks;  // (b * K + k) * 27 + o
    const int c = (int)(i - r * chunks);
    const size_t bk = r / 27;
    const int o = (int)(r - bk * 27);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (counts[bk] > 0) {
      const int num = coords[bk * 3] + pad_d - o / 9;
      const int oz = num / stride_d;
      const int oy = coords[bk * 3 + 1] + 1 - (o / 3) % 3;
      const int ox = coords[bk * 3 + 2] + 1 - o % 3 - x0;
      if (num >= 0 && num - oz * stride_d == 0 && oz < Do && oy >= 0 &&
          oy < H && ox >= 0 && ox < wloc) {
        const size_t b = bk / K;
        v = dout[(((b * Do + oz) * H + oy) * wloc + ox) * chunks + c];
      }
    }
    dvals[i] = v;
  }
}

template <typename T>
int launch_fwd(const void* vals, const void* occ, const void* bias, void* out,
               int B, int K, int D, int H, int W, int Do, int stride_d,
               int pad_d, int x0, int wloc, int channels, void* stream) {
  const int chunks = channels / Chunk<T>::kPer;
  const int tile = kThreads / chunks;
  dim3 grid((wloc + tile - 1) / tile, Do * H, B);
  sparse_conv_fwd_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)vals, (const int*)occ, (const float*)bias, (uint4*)out, K,
      D, H, W, Do, stride_d, pad_d, x0, wloc, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// vals (B, K, 27, C) bf16, occ (B, D, H, W) int32, bias (C,) f32 ->
// out (B, Do, H, wloc, C) bf16; C / 8 divides 256.
extern "C" int sparse_conv_fwd_launch(const void* vals, const void* occ,
                                      const void* bias, void* out, int B,
                                      int K, int D, int H, int W, int Do,
                                      int stride_d, int pad_d, int x0,
                                      int wloc, int channels, void* stream) {
  return launch_fwd<__nv_bfloat16>(vals, occ, bias, out, B, K, D, H, W, Do,
                                   stride_d, pad_d, x0, wloc, channels,
                                   stream);
}

// The same with vals and out f32; C / 4 divides 256.
extern "C" int sparse_conv_fwd_f32_launch(const void* vals, const void* occ,
                                          const void* bias, void* out, int B,
                                          int K, int D, int H, int W, int Do,
                                          int stride_d, int pad_d, int x0,
                                          int wloc, int channels,
                                          void* stream) {
  return launch_fwd<float>(vals, occ, bias, out, B, K, D, H, W, Do, stride_d,
                           pad_d, x0, wloc, channels, stream);
}

// dout (B, Do, H, wloc, C), coords (B, K, 3) int32, counts (B, K) int32 ->
// dvals (B, K, 27, C) of dout's type; a row of C is `chunks` 16-byte chunks.
extern "C" int sparse_conv_grad_launch(const void* dout, const void* coords,
                                       const void* counts, void* dvals, int B,
                                       int K, int Do, int H, int wloc,
                                       int stride_d, int pad_d, int x0,
                                       int chunks, void* stream) {
  const size_t total = (size_t)B * K * 27 * chunks;
  const size_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1u << 20) ? want : (1u << 20));
  sparse_conv_grad_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)dout, (const int*)coords, (const int*)counts,
      (uint4*)dvals, B, K, Do, H, wloc, stride_d, pad_d, x0, chunks);
  return (int)cudaGetLastError();
}
