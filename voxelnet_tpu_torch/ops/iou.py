"""Axis-aligned (standup) and rotated-BEV IoU, batched over leading dims.

Counterpart of `voxelnet_tpu/ops/iou.py`: the rotated IoU is the exact
boundary-segment (Liang-Barsky) formulation, written with the same
operation order so the two agree to f32 rounding.
"""

from __future__ import annotations

import torch


def standup_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                plus_one: bool = False) -> torch.Tensor:
    """(..., N, 4) and (..., K, 4) boxes (x1, y1, x2, y2) -> (..., N, K)."""
    off = 1.0 if plus_one else 0.0
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    iw = (torch.minimum(b1[..., 2], b2[..., 2])
          - torch.maximum(b1[..., 0], b2[..., 0]) + off)
    ih = (torch.minimum(b1[..., 3], b2[..., 3])
          - torch.maximum(b1[..., 1], b2[..., 1]) + off)
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    area1 = ((boxes1[..., 2] - boxes1[..., 0] + off)
             * (boxes1[..., 3] - boxes1[..., 1] + off))
    area2 = ((boxes2[..., 2] - boxes2[..., 0] + off)
             * (boxes2[..., 3] - boxes2[..., 1] + off))
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) BEV boxes (x, y, w, l, r) -> (..., 4, 2) CCW corners."""
    x, y, w, length, r = boxes.unbind(-1)
    sx = boxes.new_tensor([-0.5, -0.5, 0.5, 0.5])
    sy = boxes.new_tensor([0.5, -0.5, -0.5, 0.5])
    lx = length[..., None] * sx
    ly = w[..., None] * sy
    cos, sin = torch.cos(r)[..., None], torch.sin(r)[..., None]
    cx = cos * lx - sin * ly + x[..., None]
    cy = sin * lx + cos * ly + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def corners_to_standup(corners: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) corners -> (..., 4) axis-aligned (x1, y1, x2, y2)."""
    return torch.stack([
        corners[..., 0].amin(dim=-1), corners[..., 1].amin(dim=-1),
        corners[..., 0].amax(dim=-1), corners[..., 1].amax(dim=-1),
    ], dim=-1)


def _seg_matrix(subj, clip, origin_xy, shrink: float, out_transposed: bool):
    """Shoelace contributions of the parts of each subject quad's edges
    that lie inside each clip quad.

    subj (..., A, 4, 2), clip (..., B, 4, 2) -> (..., A, B), or (..., B, A)
    when `out_transposed`. Intermediates are (..., pe, qe, A, B): subject
    edge, clip edge, subject, clip. `origin_xy` (..., R, 2) is subtracted
    from the shoelace endpoints for f32 stability; R indexes the rows of
    the final matrix.
    """
    big = 1e30
    # subject edges: (..., pe, 1, A, 1)
    p = subj.transpose(-3, -2)                            # (..., 4, A, 2)
    d = (torch.roll(subj, -1, dims=-2) - subj).transpose(-3, -2)
    p0x, p0y = p[..., 0][..., :, None, :, None], p[..., 1][..., :, None, :, None]
    dx, dy = d[..., 0][..., :, None, :, None], d[..., 1][..., :, None, :, None]
    # clip half-planes: (..., 1, qe, 1, B)
    q = clip.transpose(-3, -2)                            # (..., 4, B, 2)
    e = (torch.roll(clip, -1, dims=-2) - clip).transpose(-3, -2)
    q0x, q0y = q[..., 0][..., None, :, None, :], q[..., 1][..., None, :, None, :]
    ex, ey = e[..., 0][..., None, :, None, :], e[..., 1][..., None, :, None, :]

    # constraints c0 + t * cd >= shrink, shape (..., pe, qe, A, B)
    c0 = ex * (p0y - q0y) - ey * (p0x - q0x)
    cd = ex * dy - ey * dx
    par = torch.abs(cd) < 1e-9
    bound = (shrink - c0) / torch.where(par, torch.ones_like(cd), cd)
    lower = torch.where(~par & (cd > 0), bound, torch.full_like(bound, -big))
    upper = torch.where(~par & (cd < 0), bound, torch.full_like(bound, big))
    infeasible = (par & (c0 < shrink)).any(dim=-3)        # (..., pe, A, B)

    t0 = torch.clamp(lower.amax(dim=-3), min=0.0)
    t1 = torch.clamp(upper.amin(dim=-3), max=1.0)
    keep = (t1 > t0) & ~infeasible

    if out_transposed:                  # rows of the result = the B axis
        ox = origin_xy[..., 0][..., None, None, :]
        oy = origin_xy[..., 1][..., None, None, :]
    else:
        ox = origin_xy[..., 0][..., None, :, None]
        oy = origin_xy[..., 1][..., None, :, None]
    p0x, p0y, dx, dy = (v.squeeze(-3) for v in (p0x, p0y, dx, dy))
    ax, ay = p0x - ox + t0 * dx, p0y - oy + t0 * dy
    bx, by = p0x - ox + t1 * dx, p0y - oy + t1 * dy
    contrib = torch.where(keep, ax * by - bx * ay,
                          torch.zeros_like(ax)).sum(dim=-3)
    return contrib.transpose(-1, -2) if out_transposed else contrib


def rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Rotated-BEV IoU between (..., N, 5) and (..., K, 5) boxes
    (x, y, w, l, r) -> (..., N, K). Clip-side segments are shrunk inward by
    1e-7 so exactly shared boundaries count once."""
    boxes1 = boxes1.to(torch.float32)
    boxes2 = boxes2.to(torch.float32)
    c1 = bev_corners(boxes1)
    c2 = bev_corners(boxes2)
    origin = c1[..., :, 0, :]
    s = (_seg_matrix(c1, c2, origin, 0.0, out_transposed=False)
         + _seg_matrix(c2, c1, origin, 1e-7, out_transposed=True))
    inter = torch.clamp(0.5 * s, min=0.0)
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
