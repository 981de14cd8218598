// Native host voxelizer: the C++ twin of
// voxelnet_tpu_torch/ops/voxelize.py::voxelize_np, for the
// `train.host_voxelize` pipeline, where the NumPy twin's time per frame
// can starve the card. One pass and one sort. Built at first use by
// voxelnet_tpu_torch/native/__init__.py with the host C++ compiler.
//
// Semantics (bit-equal to voxelize_np):
//   * bin: floor(float32(x + off) / float32(voxel_size)), a single-precision
//     divide as the NumPy twin and the device binning (ops/voxelize.prepare)
//     do, not a multiply by the inverse
//   * crop to the (D, H, W) grid; keep the first T points per voxel in
//     arrival order
//   * voxels emitted in ascending (z*H+y)*W+x order, padding trailing
//     (the `data.scatter_hints` contract)
//   * K > max_voxels keeps the lowest grid ids (the NumPy twin's documented
//     deviation from the ragged reference)
//   * features[..., 4:7] = stored point - centroid(stored points); the
//     centroid is a float32 sum over the slots in order divided in float32
//     by max(count, 1), as NumPy's sum over the slot axis computes it, so
//     the offsets are bit-equal too
//
// Plain C ABI; called from Python through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// floor-bin one coordinate and range-check BEFORE the int cast: a
// float->int64 cast of NaN/inf/out-of-range values is undefined behavior
// in C++ (the NumPy twin's .astype is implementation-defined and drops
// such points via its bounds check); comparing in float first is safe
// for any input and agrees with the twin on every in-range value.
inline bool bin_coord(float p, float off, float vs, int32_t dim,
                      int64_t* out) {
  const float f = std::floor((p + off) / vs);  // float32 add + divide
  if (!(f >= 0.0f && f < (float)dim)) return false;  // NaN -> false
  *out = (int64_t)f;
  return true;
}

}  // namespace

extern "C" {

// points: (n, 4) float32 [x, y, z, reflectance]
// features: (max_voxels, T, 7) float32, coords: (max_voxels, 3) int32,
// counts: (max_voxels,) int32 — all caller-allocated; this function
// zero-fills them before writing.
// Returns 0 on success; writes k (occupied voxels after the clip) and
// k_raw (occupied before the clip — saturation telemetry).
int voxelnet_voxelize_f32(
    const float* points, int64_t n,
    int32_t D, int32_t H, int32_t W,
    float vsz, float vsy, float vsx,
    float offx, float offy, float offz,
    int32_t T, int32_t max_voxels,
    float* features, int32_t* coords, int32_t* counts,
    int32_t* out_k, int32_t* out_k_raw) {
  std::memset(features, 0,
              sizeof(float) * (size_t)max_voxels * (size_t)T * 7);
  std::memset(coords, 0, sizeof(int32_t) * (size_t)max_voxels * 3);
  std::memset(counts, 0, sizeof(int32_t) * (size_t)max_voxels);
  *out_k = 0;
  *out_k_raw = 0;
  if (n <= 0 || max_voxels <= 0) return 0;
  if (n >= (int64_t)1 << 24) return 1;  // key packing limit (16M points)

  // Pass 1: bin + crop; pack (linear_id, arrival_index) into one uint64
  // so a single unstable sort yields ascending voxel ids with arrival
  // order preserved inside each voxel run.
  const int64_t cells = (int64_t)D * H * W;
  if (cells >= (int64_t)1 << 40) return 2;
  std::vector<uint64_t> keys;
  keys.reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * 4;
    int64_t vx, vy, vz;
    if (!bin_coord(p[0], offx, vsx, W, &vx) ||
        !bin_coord(p[1], offy, vsy, H, &vy) ||
        !bin_coord(p[2], offz, vsz, D, &vz))
      continue;
    uint64_t linear = (uint64_t)((vz * H + vy) * W + vx);
    keys.push_back((linear << 24) | (uint64_t)i);
  }
  std::sort(keys.begin(), keys.end());

  // Pass 2: walk runs (ascending linear id). For each stored voxel fill
  // raw points, count, centroid offsets.
  int32_t k = 0;       // voxels stored (<= max_voxels)
  int32_t k_raw = 0;   // voxels seen
  size_t i = 0;
  const size_t m = keys.size();
  while (i < m) {
    const uint64_t linear = keys[i] >> 24;
    size_t j = i;
    while (j < m && (keys[j] >> 24) == linear) ++j;
    ++k_raw;
    if (k < max_voxels) {
      const int32_t stored = (int32_t)std::min<size_t>(j - i, (size_t)T);
      float* feat = features + (size_t)k * T * 7;
      float cx = 0.0f, cy = 0.0f, cz = 0.0f;
      for (int32_t s = 0; s < stored; ++s) {
        const float* p = points + (keys[i + s] & 0xFFFFFF) * 4;
        feat[s * 7 + 0] = p[0];
        feat[s * 7 + 1] = p[1];
        feat[s * 7 + 2] = p[2];
        feat[s * 7 + 3] = p[3];
        cx += p[0];
        cy += p[1];
        cz += p[2];
      }
      const float div = (float)std::max<int32_t>(stored, 1);
      const float mx = cx / div, my = cy / div, mz = cz / div;
      for (int32_t s = 0; s < stored; ++s) {
        feat[s * 7 + 4] = feat[s * 7 + 0] - mx;
        feat[s * 7 + 5] = feat[s * 7 + 1] - my;
        feat[s * 7 + 6] = feat[s * 7 + 2] - mz;
      }
      counts[k] = stored;
      coords[k * 3 + 0] = (int32_t)(linear / ((int64_t)H * W));
      coords[k * 3 + 1] = (int32_t)((linear / W) % H);
      coords[k * 3 + 2] = (int32_t)(linear % W);
      ++k;
    }
    i = j;
  }
  *out_k = k;
  *out_k_raw = k_raw;
  return 0;
}

// Compact `points` (n, 4) to only those inside the (D, H, W) grid — the
// identical float32 bin test as the voxelizer above (and therefore
// ops/voxelize.in_grid_mask). Writes kept rows to out_points (caller
// allocates >= n rows) and returns the kept count. This is the
// data.crop_to_grid step before the max_points cap.
int64_t voxelnet_crop_f32(
    const float* points, int64_t n,
    int32_t D, int32_t H, int32_t W,
    float vsz, float vsy, float vsx,
    float offx, float offy, float offz,
    float* out_points) {
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * 4;
    int64_t vx, vy, vz;
    if (!bin_coord(p[0], offx, vsx, W, &vx) ||
        !bin_coord(p[1], offy, vsy, H, &vy) ||
        !bin_coord(p[2], offz, vsz, D, &vz))
      continue;
    std::memcpy(out_points + k * 4, p, 4 * sizeof(float));
    ++k;
  }
  return k;
}

}  // extern "C"
