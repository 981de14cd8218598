// The search that the streaming builds of a grid from sorted voxel rows
// share (dense_build.cu, and the occupancy map in sparse_conv.cu): a block
// owns consecutive cells of one frame and finds the rows that land there
// among the frame's rows, whose linear cell ids ascend.

#pragma once

#include <cuda_runtime.h>

// First index in [0, n) whose id(index) is >= target (n if none), by one
// warp: each round probes 32 evenly spaced positions and keeps the gap
// where the ids cross the target. `id` maps a row index to its cell id,
// ascending over [0, n); on ids out of order it still ends, at some index
// in [0, n].
template <typename Id>
__device__ int warp_lower_bound(const Id& id, int n, int target) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + lane * step;
    const bool below = probe < hi && id(probe) < target;
    const int c = __popc(__ballot_sync(kFull, below));
    const int new_lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = min(hi, lo + c * step);
    lo = new_lo;
  }
  const int probe = lo + lane;
  const bool below = probe < hi && id(probe) < target;
  return lo + __popc(__ballot_sync(kFull, below));
}
