"""Anchor grid (numpy), as `voxelnet_tpu/ops/anchors.py` lays it out: two
anchors per feature-map cell (yaw 0 and pi/2), centres on an inclusive
linspace over the x/y range; and the anchors' axis-aligned BEV boxes, as
`voxelnet_tpu/utils/geometry.py::anchor_to_standup_box2d`."""

from __future__ import annotations

import numpy as np


def generate_anchors(obj) -> np.ndarray:
    """ObjectConfig -> anchors (feature_height, feature_width, 2, 7) f32,
    box layout (x, y, z, h, w, l, r)."""
    x = np.linspace(obj.x_min, obj.x_max, obj.feature_width)
    y = np.linspace(obj.y_min, obj.y_max, obj.feature_height)
    cx, cy = np.meshgrid(x, y)
    cx = np.tile(cx[..., None], 2)
    cy = np.tile(cy[..., None], 2)
    cz = np.full_like(cx, obj.anchor_z)
    h = np.full_like(cx, obj.anchor_h)
    w = np.full_like(cx, obj.anchor_w)
    length = np.full_like(cx, obj.anchor_l)
    r = np.zeros_like(cx)
    r[..., 1] = np.pi / 2
    return np.stack([cx, cy, cz, h, w, length, r],
                    axis=-1).astype(np.float32)


def anchors_flat(obj) -> np.ndarray:
    """(A, 7) flattened anchors, A = feature_height * feature_width * 2."""
    return generate_anchors(obj).reshape(-1, 7)


def anchor_to_standup_box2d(anchors_xywl: np.ndarray,
                            buggy: bool = False) -> np.ndarray:
    """(A, 4) anchor BEV (x, y, w, l) -> (A, 4) standup (x1, y1, x2, y2),
    f32. Even rows are yaw 0 (x extent l, y extent w), odd rows yaw 90.

    `buggy=True` reproduces the reference's zero-area boxes, whose x2/y2
    repeat x1/y1 (compat.buggy_anchor_standup)."""
    a = np.asarray(anchors_xywl, np.float64).reshape(-1, 4)
    out = np.zeros_like(a)
    x, y, w, length = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    even = np.arange(len(a)) % 2 == 0
    ext_x = np.where(even, length, w) / 2
    ext_y = np.where(even, w, length) / 2
    out[:, 0] = x - ext_x
    out[:, 1] = y - ext_y
    out[:, 2] = x - ext_x if buggy else x + ext_x
    out[:, 3] = y - ext_y if buggy else y + ext_y
    return out.astype(np.float32)
