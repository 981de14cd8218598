// Run-copy voxel table: sorted channel-planar points -> (B, K, T, 4) table.
//
// Replaces the three TPU run-copy kernels of
// voxelnet_tpu/kernels/voxelize_pallas.py: _planar_t_kernel (voxel-major
// (B, 4, TPAD, K) output), _planar_kernel ((B, 4, K * 128) slot stride) and
// _kernel ((B, K * TPAD, 4) rows). All three compute
//
//   table[b, k, t, c] = sorted[b, c, run_start[b, k] + t]   (0 at or past N)
//
// in the layout Mosaic's (8, 128) tiling wanted; this kernel writes the
// (B, K, T, 4) rows the rest of the port consumes. Rows past a voxel's
// count carry the next run's points; the consumer (ops/voxelize.finalize)
// masks them.
//
// What bounds it on an H100: device-memory writes. At Car B=2 it writes
// 2 x 16384 x 35 x 16 B = 18.4 MB and reads about 2.1 MB of points. One
// thread per (b, k, t) of frame b = blockIdx.y reads its point's 4
// channels (strided by N) and writes them with one 16-byte store, so
// consecutive threads write consecutive 16-byte rows and the stores
// coalesce fully. Index math is 32-bit within a frame (K * T < 2^31, the
// wrapper checks): a 64-bit divide is a long instruction sequence.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
run_copy_kernel(const float* __restrict__ planar,   // (B, 4, N)
                const int* __restrict__ run_start,  // (B, K), N = empty
                float4* __restrict__ table,          // (B, K, T) rows of 4
                int N, int K, int T) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;  // k * T + t
  const unsigned rows = (unsigned)K * T;
  if (i >= rows) return;
  const int b = blockIdx.y;
  const unsigned k = i / T;
  const int s = __ldg(run_start + (size_t)b * K + k) + (int)(i - k * T);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (s >= 0 && s < N) {
    const float* p = planar + (size_t)b * 4 * N + s;
    v.x = __ldg(p);
    v.y = __ldg(p + N);
    v.z = __ldg(p + 2 * (size_t)N);
    v.w = __ldg(p + 3 * (size_t)N);
  }
  table[(size_t)b * rows + i] = v;
}

}  // namespace

// planar (B, 4, N) f32, run_start (B, K) int32 -> table (B, K, T, 4) f32;
// K * T < 2^31 and B <= 65535.
extern "C" int run_copy_launch(const void* planar, const void* run_start,
                               void* table, int B, int N, int K, int T,
                               void* stream) {
  const long long rows = (long long)K * T;
  if (rows == 0 || B == 0) return 0;
  dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), B);
  run_copy_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)planar, (const int*)run_start, (float4*)table, N, K, T);
  return (int)cudaGetLastError();
}
