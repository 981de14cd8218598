"""The vendored sample LiDAR frames (`voxelnet_tpu/data/sample_frames`),
decoded with numpy: three KITTI raw velodyne frames (drive
2011_09_26_drive_0001, frames 0/40/80) stored 5 mm-quantized."""

from __future__ import annotations

import glob
import os

import numpy as np

FRAMES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "voxelnet_tpu", "data", "sample_frames")


def sample_frames() -> list[np.ndarray]:
    """-> list of (N, 4) float32 (x, y, z, reflectance) clouds."""
    frames = []
    for f in sorted(glob.glob(os.path.join(FRAMES_DIR, "frame_*.npz"))):
        with np.load(f) as z:
            pts = np.empty((len(z["refl_u8"]), 4), np.float32)
            pts[:, :3] = z["xyz_q5mm"].astype(np.float32) * 0.005
            pts[:, 3] = z["refl_u8"].astype(np.float32) / 255.0
        frames.append(pts)
    return frames
