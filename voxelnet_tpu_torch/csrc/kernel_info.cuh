// A built kernel's attributes on the current card, which each library's
// `*_info` entry returns for kernels/_build.py::kernel_info: info[0..3] =
// registers per thread, local (spill) bytes per thread, static shared bytes
// per block, resident blocks per SM at `threads` threads a block.

#pragma once

#include <cuda_runtime.h>

template <typename Kernel>
int kernel_attributes(Kernel* kernel, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = per_sm;
  return (int)err;
}
