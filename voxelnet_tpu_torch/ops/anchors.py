"""Anchor grid (numpy), as `voxelnet_tpu/ops/anchors.py` lays it out: two
anchors per feature-map cell (yaw 0 and pi/2), centres on an inclusive
linspace over the x/y range."""

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
