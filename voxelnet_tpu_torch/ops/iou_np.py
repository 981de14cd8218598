"""Host-side (numpy) box geometry, as `voxelnet_tpu/ops/iou_np.py`."""

from __future__ import annotations

import numpy as np


def bev_corners_np(boxes: np.ndarray) -> np.ndarray:
    """(..., 5) BEV boxes (x, y, w, l, r) -> (..., 4, 2) CCW corners, f64."""
    boxes = np.asarray(boxes, np.float64)
    x, y, w, length, r = (boxes[..., i] for i in range(5))
    sx = np.asarray([-0.5, -0.5, 0.5, 0.5])
    sy = np.asarray([0.5, -0.5, -0.5, 0.5])
    lx = length[..., None] * sx
    ly = w[..., None] * sy
    cos, sin = np.cos(r)[..., None], np.sin(r)[..., None]
    cx = cos * lx - sin * ly + x[..., None]
    cy = sin * lx + cos * ly + y[..., None]
    return np.stack([cx, cy], axis=-1)
