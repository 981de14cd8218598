"""The benchmark's inputs: LiDAR frames from the repository's vendored
KITTI sweeps, a pool of augmented batches drawn from the seed, and GT
boxes for the training mixes.

The sweeps are read as plain `.npz` files (int16 coordinates at 5 mm,
uint8 reflectance); no module of either package is imported for them.
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np


def load_sweeps(directory: str) -> list[np.ndarray]:
    """Every `frame_*.npz` under `directory` -> (N, 4) float32 clouds
    (x, y, z, reflectance), in file-name order."""
    sweeps = []
    for path in sorted(glob.glob(os.path.join(directory, "frame_*.npz"))):
        with np.load(path) as z:
            pts = np.empty((len(z["refl_u8"]), 4), np.float32)
            pts[:, :3] = z["xyz_q5mm"].astype(np.float32) * 0.005
            pts[:, 3] = z["refl_u8"].astype(np.float32) / 255.0
        sweeps.append(pts)
    if not sweeps:
        raise FileNotFoundError(f"no frame_*.npz under {directory}")
    return sweeps


def in_range(pts: np.ndarray, obj: dict) -> np.ndarray:
    """The points that fall in the configuration's voxel grid, binned as
    the voxelizer bins them (float32 floor((p - min) / size))."""
    keep = np.ones(len(pts), bool)
    for axis, key in enumerate("xyz"):
        lo, hi, size = (obj[f"{key}_min"], obj[f"{key}_max"],
                        obj[f"{key}_voxel_size"])
        n = int(round((hi - lo) / size))
        v = np.floor((pts[:, axis] + np.float32(-lo)) / np.float32(size))
        keep &= (v >= 0) & (v < n)
    return pts[keep]


def augment(sweep: np.ndarray, rng: np.random.Generator,
            mix: dict) -> np.ndarray:
    """One sweep turned about z by an angle uniform in +-rotation_deg,
    mirrored in y with probability flip, and thinned by dropping a fixed
    share of its points at random."""
    a = math.radians(rng.uniform(-mix["rotation_deg"], mix["rotation_deg"]))
    c, s = math.cos(a), math.sin(a)
    pts = sweep.copy()
    x, y = sweep[:, 0], sweep[:, 1]
    pts[:, 0] = c * x - s * y
    pts[:, 1] = s * x + c * y
    if rng.uniform() < mix["flip"]:
        pts[:, 1] = -pts[:, 1]
    keep = rng.permutation(len(pts))[: len(pts) - int(mix["drop"]
                                                       * len(pts))]
    return pts[np.sort(keep)]


def batch_pool(sweeps: list[np.ndarray], cfg: dict, mix: dict,
               rng: np.random.Generator):
    """mix['pool_batches'] batches of mix['batch'] frames: each frame one
    sweep (cycled) augmented, cropped to the grid, shuffled and cut at
    data.max_points -> [(points (B, N, 4) f32, num_points (B,) i32)]."""
    obj, max_points = cfg["object"], cfg["data"]["max_points"]
    B = mix["batch"]
    pool = []
    for i in range(mix["pool_batches"]):
        pts = np.zeros((B, max_points, 4), np.float32)
        num = np.zeros((B,), np.int32)
        for b in range(B):
            cloud = in_range(augment(sweeps[(i * B + b) % len(sweeps)], rng,
                                     mix), obj)
            cloud = cloud[rng.permutation(len(cloud))][:max_points]
            pts[b, : len(cloud)] = cloud
            num[b] = len(cloud)
        pool.append((pts, num))
    return pool


def gt_boxes(cfg: dict, labels: dict, batch: int,
             rng: np.random.Generator):
    """Boxes of the configuration's class for one batch: per frame a
    Poisson number with the class's mean a frame (at most
    data.max_gt_boxes), each of the class's mean size scaled by
    U(0.9, 1.1), centred in the grid's x-y range with a margin of 2 m, on
    the anchors' height, turned by U(-pi, pi) -> (boxes (B, G, 7) f32 as
    (x, y, z, h, w, l, yaw), mask (B, G) bool)."""
    obj, G = cfg["object"], cfg["data"]["max_gt_boxes"]
    boxes = np.zeros((batch, G, 7), np.float32)
    mask = np.zeros((batch, G), bool)
    h, w, length = labels["mean_hwl"]
    for b in range(batch):
        n = min(int(rng.poisson(labels["per_frame"])), G)
        size = np.array([h, w, length]) * rng.uniform(0.9, 1.1, (n, 3))
        boxes[b, :n, 0] = rng.uniform(obj["x_min"] + 2, obj["x_max"] - 2, n)
        boxes[b, :n, 1] = rng.uniform(obj["y_min"] + 2, obj["y_max"] - 2, n)
        boxes[b, :n, 2] = obj["anchor_z"]
        boxes[b, :n, 3:6] = size
        boxes[b, :n, 6] = rng.uniform(-math.pi, math.pi, n)
        mask[b, :n] = True
    return boxes, mask
