"""Point-cloud crop preprocessing: the port's copy of
`voxelnet_tpu/data/preprocess.py`.

Capability parity with the reference crop tool (preprocess_data.py:13-160):
keep only the velodyne points that project into the cam-2 image, writing
the cropped cloud (optionally archiving the original first). Vectorized —
the reference loops per file with full-matrix NumPy anyway.

    python -m voxelnet_tpu_torch.data.preprocess --velodyne-dir ... --calib-dir ... \
        --img-width 1242 --img-height 375 [--archive-dir ...]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from voxelnet_tpu_torch.utils import kitti


def project_velo_to_img(points: np.ndarray, P: np.ndarray, Tr: np.ndarray,
                        R: np.ndarray) -> np.ndarray:
    """(N, 3) lidar points -> (N, 3) image-plane (u, v, depth)."""
    n = len(points)
    hom = np.concatenate([points[:, :3], np.ones((n, 1), np.float32)], 1)
    cam = hom @ Tr.T @ R.T @ P.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = cam[:, :2] / cam[:, 2:3]
    return np.concatenate([np.nan_to_num(uv), cam[:, 2:3]], axis=1)


def crop_cloud_to_image(points: np.ndarray, P, Tr, R,
                        img_w: int, img_h: int) -> np.ndarray:
    uvd = project_velo_to_img(points, P, Tr, R)
    keep = ((uvd[:, 2] > 0)
            & (uvd[:, 0] >= 0) & (uvd[:, 0] < img_w)
            & (uvd[:, 1] >= 0) & (uvd[:, 1] < img_h))
    return points[keep]


def align_img_and_velo(velodyne_dir: str, calib_dir: str,
                       img_w: int = 1242, img_h: int = 375,
                       archive_dir: str | None = None) -> int:
    """Crop every .bin in velodyne_dir in place; returns #files processed."""
    count = 0
    for fname in sorted(os.listdir(velodyne_dir)):
        if not fname.endswith(".bin"):
            continue
        tag = fname[:-4]
        calib_path = os.path.join(calib_dir, tag + ".txt")
        if not os.path.exists(calib_path):
            continue
        src = os.path.join(velodyne_dir, fname)
        if archive_dir:
            os.makedirs(archive_dir, exist_ok=True)
            dst = os.path.join(archive_dir, fname)
            # never clobber an existing archive: on a re-run the source
            # is already cropped and copying it would destroy the only
            # remaining copy of the raw cloud
            if not os.path.exists(dst):
                shutil.copy2(src, dst)
        P, Tr, R = kitti.load_calib(calib_path)
        pts = kitti.read_point_cloud(src)
        cropped = crop_cloud_to_image(pts, P, Tr, R, img_w, img_h)
        cropped.astype(np.float32).tofile(src)
        count += 1
    return count


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--velodyne-dir", required=True)
    p.add_argument("--calib-dir", required=True)
    p.add_argument("--img-width", type=int, default=1242)
    p.add_argument("--img-height", type=int, default=375)
    p.add_argument("--archive-dir", default=None,
                   help="copy originals here before overwriting")
    args = p.parse_args(argv)
    n = align_img_and_velo(args.velodyne_dir, args.calib_dir,
                           args.img_width, args.img_height, args.archive_dir)
    print(f"cropped {n} point clouds")


if __name__ == "__main__":
    main()
