// Streaming dense-grid build: sorted voxel rows -> (B, n_cells, C) grid.
//
// Replaces the TPU kernel voxelnet_tpu/kernels/dense_build.py::_kernel
// (entry dense_build_pallas, forward; its backward is a row gather, done
// in torch by kernels/dense_build.py). Same contract: per frame the
// linear cell ids are ascending, padding rows carry the id n_cells and
// trail. Each block owns kRows consecutive cells of one frame: one warp
// finds the block's slot range by a 32-way search of the sorted ids
// (sorted_ids.cuh), the block maps each of its cells to a slot (or none)
// in shared memory, and then writes every 16-byte chunk of its cells
// exactly once: the voxel's row where the cell is occupied, zeros
// elsewhere. No separate zero fill, no read-modify-write.
//
// The kernel moves 16-byte chunks and never looks at the values, so one
// kernel serves every element type; the launcher is a template over the
// type (bf16 for inference, f32 for the f32 train step).
//
// What bounds it on an H100: device-memory writes. The Car grid is
// 1,408,000 cells x 128 bf16 = 360 MB per frame (720 MB in f32); the voxel
// rows read (<= 4 MB per frame in bf16) are noise beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_ids.cuh"

namespace {

constexpr int kRows = 128;     // cells per block
constexpr int kThreads = 256;

// the sorted ids of one frame's rows, as warp_lower_bound reads them
struct RowIds {
  const int* __restrict__ ids;
  __device__ int operator()(int k) const { return ids[k]; }
};

__global__ void __launch_bounds__(kThreads)
dense_build_kernel(const uint4* __restrict__ feat,  // (B, K, chunks)
                   const int* __restrict__ ids,     // (B, K) ascending
                   uint4* __restrict__ out,         // (B, n_cells, chunks)
                   int K, int n_cells, int chunks) {
  __shared__ int slot_of[kRows];
  __shared__ int range[2];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kRows;
  const int rows = min(kRows, n_cells - base);
  const int* fid = ids + (size_t)b * K;

  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int at = warp_lower_bound(RowIds{fid}, K, base + (warp ? rows : 0));
    if ((threadIdx.x & 31) == 0) range[warp] = at;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) slot_of[r] = -1;
  __syncthreads();
  for (int s = range[0] + threadIdx.x; s < range[1]; s += kThreads) {
    const int r = fid[s] - base;  // in [0, rows) for ascending ids
    if (r >= 0 && r < rows) slot_of[r] = s;
  }
  __syncthreads();

  const uint4* src = feat + (size_t)b * K * chunks;
  uint4* dst = out + ((size_t)b * n_cells + base) * chunks;
  const int n = rows * chunks;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / chunks;
    const int s = slot_of[r];
    dst[i] = s >= 0 ? src[(size_t)s * chunks + (i - r * chunks)]
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T>
int launch(const void* feat, const void* ids, void* out, int B, int K,
           int n_cells, int channels, void* stream) {
  static_assert(16 % sizeof(T) == 0, "16-byte chunks of whole elements");
  const int chunks = channels * (int)sizeof(T) / 16;
  dim3 grid((n_cells + kRows - 1) / kRows, B);
  dense_build_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)feat, (const int*)ids, (uint4*)out, K, n_cells, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// feat (B, K, C) bf16, C * 2 a multiple of 16; ids (B, K) int32.
extern "C" int dense_build_launch(const void* feat, const void* ids,
                                  void* out, int B, int K, int n_cells,
                                  int channels, void* stream) {
  return launch<__nv_bfloat16>(feat, ids, out, B, K, n_cells, channels,
                               stream);
}

// feat (B, K, C) f32, C * 4 a multiple of 16; ids (B, K) int32.
extern "C" int dense_build_f32_launch(const void* feat, const void* ids,
                                      void* out, int B, int K, int n_cells,
                                      int channels, void* stream) {
  return launch<float>(feat, ids, out, B, K, n_cells, channels, stream);
}
