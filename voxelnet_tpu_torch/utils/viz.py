"""Visualization helpers (host numpy): the port's copy of
`voxelnet_tpu/utils/viz.py`, with the same four functions, names and
arguments, drawing with `utils/raster.py` instead of cv2, so it runs where
cv2 does not import.

As the reference viz utilities (voxelnet/utils.py:659-814): project
predicted/GT 3D boxes onto the camera image, render a BEV occupancy image
with boxes, and colorize probability heatmaps. Images in are BGR (as
`utils/image_io.read_png_bgr` and cv2.imread give them) and drawn in BGR;
the results are RGB, as the JAX package's are. The box lines are
anti-aliased within `raster.line`'s tolerance of cv2's LINE_AA; the
heatmap's colour map and resize are bit-equal to cv2's.
"""

from __future__ import annotations

import numpy as np

from voxelnet_tpu_torch.config import ObjectConfig
from voxelnet_tpu_torch.utils import geometry, raster

_EDGES = [(k, (k + 1) % 4) for k in range(4)] + \
         [(k + 4, (k + 1) % 4 + 4) for k in range(4)] + \
         [(k, k + 4) for k in range(4)]


def draw_boxes3d_on_image(img, boxes3d, gt_boxes3d=None,
                          color=(0, 255, 255), gt_color=(255, 0, 255),
                          thickness=1, P2=None, T_VELO_2_CAM=None,
                          R_RECT_0=None) -> np.ndarray:
    """Draw lidar boxes (and optional GT) as wireframes on a BGR image
    -> RGB. Same 12-edge rendering as voxelnet/utils.py:659-716."""
    img = np.array(img, dtype=np.uint8, order="C")

    def _draw(boxes, col):
        if boxes is None or len(boxes) == 0:
            return
        proj = geometry.lidar_box3d_to_camera_box(
            boxes, cal_projection=True, P2=P2,
            T_VELO_2_CAM=T_VELO_2_CAM, R_RECT_0=R_RECT_0)
        for qs in proj:
            for i, j in _EDGES:
                raster.line(img, (int(qs[i, 0]), int(qs[i, 1])),
                            (int(qs[j, 0]), int(qs[j, 1])), col, thickness)

    _draw(boxes3d, color)
    _draw(gt_boxes3d, gt_color)
    return raster.bgr_to_rgb(img)


def lidar_to_bev_image(points, obj: ObjectConfig,
                       factor: int = 1) -> np.ndarray:
    """(N, 4) points -> BEV occupancy image (voxelnet/utils.py:719-739)."""
    H, W = obj.height * factor, obj.width * factor
    x, y = points[:, 0], points[:, 1]
    inside = ((x > obj.x_min) & (x < obj.x_max)
              & (y > obj.y_min) & (y < obj.y_max))
    px = ((x[inside] - obj.x_min) / obj.x_voxel_size * factor).astype(int)
    py = ((y[inside] - obj.y_min) / obj.y_voxel_size * factor).astype(int)
    px = np.clip(px, 0, W - 1)
    py = np.clip(py, 0, H - 1)
    bev = np.zeros((H, W), np.float32)
    np.add.at(bev, (py, px), 1.0)
    rng = bev.max() - bev.min()
    bev = np.clip((bev - bev.min()) / max(rng, 1e-6) * 255 * 5 * factor,
                  0, 255).astype(np.uint8)
    return np.tile(bev[..., None], 3)


def _to_bev_pixels(xy, obj: ObjectConfig, factor: int):
    a = (xy[..., 0] - obj.x_min) / obj.x_voxel_size * factor
    b = (xy[..., 1] - obj.y_min) / obj.y_voxel_size * factor
    a = np.clip(a, 0, (obj.x_max - obj.x_min) / obj.x_voxel_size * factor)
    b = np.clip(b, 0, (obj.y_max - obj.y_min) / obj.y_voxel_size * factor)
    return a, b


def draw_boxes3d_on_bev(bev_img, boxes3d, obj: ObjectConfig,
                        gt_boxes3d=None, color=(0, 255, 255),
                        gt_color=(255, 0, 255), thickness=1,
                        factor: int = 1) -> np.ndarray:
    """Draw the bottom faces of lidar boxes on a BGR BEV image -> RGB
    (voxelnet/utils.py:742-788)."""
    img = np.array(bev_img, dtype=np.uint8, order="C")

    def _draw(boxes, col):
        if boxes is None or len(boxes) == 0:
            return
        corners = geometry.center_to_corner_box3d(boxes, "lidar")[:, :4, :2]
        ax, by = _to_bev_pixels(corners, obj, factor)
        for n in range(len(corners)):
            for k in range(4):
                p0 = (int(ax[n, k]), int(by[n, k]))
                p1 = (int(ax[n, (k + 1) % 4]), int(by[n, (k + 1) % 4]))
                raster.line(img, p0, p1, col, thickness)

    _draw(gt_boxes3d, gt_color)
    _draw(boxes3d, color)
    return raster.bgr_to_rgb(img)


def colorize_heatmap(values, factor: int = 4) -> np.ndarray:
    """Probability map -> JET heatmap image, RGB (voxelnet/utils.py:
    801-814). `values` is (C, H, W) or (H, W); channels are summed like
    the reference."""
    v = np.asarray(values, np.float32)
    if v.ndim == 3:
        v = v.sum(axis=0)
    vmin, vmax = float(v.min()), float(v.max())
    v = (v - vmin) / max(vmax - vmin, 1e-6)
    img = raster.bgr_to_rgb(raster.apply_jet((v * 255).astype(np.uint8)))
    return raster.resize_linear(img, factor)
