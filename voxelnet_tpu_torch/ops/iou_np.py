"""Host-side (numpy) box geometry and IoU matrices, as
`voxelnet_tpu/ops/iou_np.py`: exact rotated-BEV intersection by clipping
each quad's boundary segments against the other (Liang-Barsky), in f64,
for AP evaluation and host tooling."""

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


def _seg_matrix_np(subj, clip, shrink, out_transposed):
    """Shoelace contributions of subject-edge segments inside clip quads.

    subj (A, 4, 2) / clip (B, 4, 2) -> (A, B) or transposed; see
    `voxelnet_tpu/ops/iou.py::_seg_matrix` for the derivation. float64 host math, so no
    per-row origin shift is needed for stability.
    """
    big = 1e30
    p0 = subj.transpose(1, 2, 0)                      # (4, 2, A)
    d = (np.roll(subj, -1, axis=-2) - subj).transpose(1, 2, 0)
    p0x, p0y = p0[:, 0, :, None], p0[:, 1, :, None]
    dx, dy = d[:, 0, :, None], d[:, 1, :, None]

    q0 = clip.transpose(1, 2, 0)                      # (4, 2, B)
    e = (np.roll(clip, -1, axis=-2) - clip).transpose(1, 2, 0)
    q0x, q0y = q0[:, 0, None, :], q0[:, 1, None, :]
    ex, ey = e[:, 0, None, :], e[:, 1, None, :]

    c0 = (ex[None] * (p0y[:, None] - q0y[None])
          - ey[None] * (p0x[:, None] - q0x[None]))    # (pe, qe, A, B)
    cd = ex[None] * dy[:, None] - ey[None] * dx[:, None]
    par = np.abs(cd) < 1e-12
    bound = (shrink - c0) / np.where(par, 1.0, cd)
    lower = np.where(~par & (cd > 0), bound, -big)
    upper = np.where(~par & (cd < 0), bound, big)
    infeasible = (par & (c0 < shrink)).any(axis=1)    # (pe, A, B)

    t0 = np.maximum(lower.max(axis=1), 0.0)           # (pe, A, B)
    t1 = np.minimum(upper.min(axis=1), 1.0)
    keep = (t1 > t0) & ~infeasible

    ax_, ay = p0x + t0 * dx, p0y + t0 * dy
    bx, by = p0x + t1 * dx, p0y + t1 * dy
    contrib = np.where(keep, ax_ * by - bx * ay, 0.0).sum(axis=0)
    return contrib.T if out_transposed else contrib


def rotated_iou_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Rotated-BEV IoU matrix between (N, 5) and (K, 5) boxes -> (N, K).

    Boxes are (x, y, w, l, r); exact convex intersection, float64.
    """
    boxes1 = np.asarray(boxes1, np.float64).reshape(-1, 5)
    boxes2 = np.asarray(boxes2, np.float64).reshape(-1, 5)
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    c1, c2 = bev_corners_np(boxes1), bev_corners_np(boxes2)
    s = (_seg_matrix_np(c1, c2, 0.0, out_transposed=False)
         + _seg_matrix_np(c2, c1, 1e-9, out_transposed=True))
    inter = np.maximum(0.5 * s, 0.0)
    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def box3d_iou_matrix_np(boxes1: np.ndarray, boxes2: np.ndarray,
                        mode: str = "3d") -> np.ndarray:
    """(N, 7) x (K, 7) lidar boxes (x, y, z, h, w, l, r) -> (N, K) IoU.

    mode='bev' — rotated BEV IoU; mode='3d' — rotated BEV intersection
    times z-overlap over volume union. z is the box bottom (lidar
    convention, voxelnet/utils.py:596-605 corner template).
    """
    boxes1 = np.asarray(boxes1, np.float64).reshape(-1, 7)
    boxes2 = np.asarray(boxes2, np.float64).reshape(-1, 7)
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    bev_iou = rotated_iou_np(boxes1[:, [0, 1, 4, 5, 6]],
                             boxes2[:, [0, 1, 4, 5, 6]])
    if mode == "bev":
        return bev_iou
    a1 = boxes1[:, 4] * boxes1[:, 5]
    a2 = boxes2[:, 4] * boxes2[:, 5]
    # recover intersection area from IoU: I = iou * (A1 + A2) / (1 + iou)
    inter_bev = bev_iou * (a1[:, None] + a2[None, :]) / (1.0 + bev_iou)
    top = np.minimum(boxes1[:, None, 2] + boxes1[:, None, 3],
                     boxes2[None, :, 2] + boxes2[None, :, 3])
    bot = np.maximum(boxes1[:, None, 2], boxes2[None, :, 2])
    z_overlap = np.maximum(top - bot, 0.0)
    inter = inter_bev * z_overlap
    union = (a1 * boxes1[:, 3])[:, None] + (a2 * boxes2[:, 3])[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)
