"""Box coding between anchors and regression deltas, as
`voxelnet_tpu/ops/box_coding.py` (`decode_deltas`, `encode_boxes`). Delta
layout per anchor: (dx, dy, dz, dh, dw, dl, dr)."""

from __future__ import annotations

import math

import torch


def decode_deltas(deltas: torch.Tensor, anchors: torch.Tensor,
                  anchor_h: float, yaw_mode: str = "delta") -> torch.Tensor:
    """deltas (..., A, 7), anchors (A, 7) -> boxes (..., A, 7) as
    (x, y, z, h, w, l, r).

    yaw_mode 'delta': r = dr + anchor_r; 'sin': r = anchor_r +
    arcsin(clip(dr, -1, 1)) (train.yaw_encoding='sin')."""
    anchors = anchors.to(deltas.dtype)
    diag = torch.sqrt(anchors[:, 4] ** 2 + anchors[:, 5] ** 2)
    xy = deltas[..., 0:2] * diag[:, None] + anchors[:, 0:2]
    z = deltas[..., 2:3] * anchor_h + anchors[:, 2:3]
    hwl = torch.exp(deltas[..., 3:6]) * anchors[:, 3:6]
    dr = deltas[..., 6:7]
    if yaw_mode == "sin":
        dr = torch.asin(torch.clamp(dr, -1.0, 1.0))
    elif yaw_mode != "delta":
        raise ValueError(f"yaw_mode={yaw_mode!r}")
    return torch.cat([xy, z, hwl, dr + anchors[:, 6:7]], dim=-1)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 anchor_h: float, yaw_mode: str = "delta") -> torch.Tensor:
    """boxes (..., A, 7) aligned to anchors (A, 7) -> deltas (..., A, 7),
    the inverse of `decode_deltas`.

    yaw_mode 'delta': dr = r - anchor_r; 'sin': the residual is first
    wrapped into [-pi/2, pi/2] modulo pi, then dr = sin(residual), so a
    box and the same box turned by pi get one target."""
    anchors = anchors.to(boxes.dtype)
    diag = torch.sqrt(anchors[:, 4] ** 2 + anchors[:, 5] ** 2)
    xy = (boxes[..., 0:2] - anchors[:, 0:2]) / diag[:, None]
    z = (boxes[..., 2:3] - anchors[:, 2:3]) / anchor_h
    hwl = torch.log(torch.clamp(boxes[..., 3:6], min=1e-6) / anchors[:, 3:6])
    r = boxes[..., 6:7] - anchors[:, 6:7]
    if yaw_mode == "sin":
        r = torch.sin(r - math.pi * torch.round(r / math.pi))
    elif yaw_mode != "delta":
        raise ValueError(f"yaw_mode={yaw_mode!r}")
    return torch.cat([xy, z, hwl, r], dim=-1)
