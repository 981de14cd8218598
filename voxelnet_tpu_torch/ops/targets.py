"""Anchor target assignment, on the device and on the host, as
`voxelnet_tpu/ops/targets.py`:

  pos anchors = {IoU > pos_thresh} + {the argmax anchor of each GT with
                some positive overlap}
  neg anchors = {max IoU over valid GTs < neg_thresh}, never positive
  regression  = deltas to each anchor's best GT, on positives only

The IoU is the standup (axis-aligned BEV) IoU of the anchors and the GT
boxes' rotated corners. Padding GTs carry overlap -1. Both argmaxes take
the first maximum. `assign_targets` is batched over a leading B axis (the
JAX function is per frame under vmap).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voxelnet_tpu_torch.ops import box_coding, iou
from voxelnet_tpu_torch.ops.anchors import anchor_to_standup_box2d, anchors_flat


class TargetAssignment(NamedTuple):
    pos_mask: torch.Tensor     # (B, A) f32 0/1
    neg_mask: torch.Tensor     # (B, A) f32 0/1
    reg_targets: torch.Tensor  # (B, A, 7) f32


def anchor_standup_np(obj, buggy: bool = False) -> np.ndarray:
    """(A, 4) anchor standup boxes of a class (constant per config)."""
    a = anchors_flat(obj)
    return anchor_to_standup_box2d(a[:, [0, 1, 4, 5]], buggy=buggy)


def gt_standup(gt_boxes: torch.Tensor) -> torch.Tensor:
    """(..., G, 7) lidar GT boxes -> (..., G, 4) BEV standup boxes."""
    bev = gt_boxes[..., [0, 1, 4, 5, 6]]
    return iou.corners_to_standup(iou.bev_corners(bev))


def assign_targets(gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                   anchors: torch.Tensor, anchors_standup: torch.Tensor, *,
                   pos_iou: float, neg_iou: float, anchor_h: float,
                   iou_plus_one: bool = False,
                   yaw_mode: str = "delta") -> TargetAssignment:
    """gt_boxes (B, G, 7) padded, gt_mask (B, G) bool, anchors (A, 7),
    anchors_standup (A, 4) -> TargetAssignment. Static shapes, no host
    sync."""
    B = gt_boxes.shape[0]
    A = anchors.shape[0]
    overlaps = iou.standup_iou(anchors_standup[None], gt_standup(gt_boxes),
                               plus_one=iou_plus_one)           # (B, A, G)
    overlaps = torch.where(gt_mask[:, None, :], overlaps,
                           overlaps.new_tensor(-1.0))

    best_gt = torch.argmax(overlaps, dim=2)                     # (B, A)
    best_gt_iou = overlaps.amax(dim=2)
    best_anchor = torch.argmax(overlaps, dim=1)                 # (B, G)
    best_anchor_iou = overlaps.amax(dim=1)
    # the argmax anchor of each valid GT with positive overlap; the rest
    # go to a spare column A that is cut off
    force_at = torch.where(gt_mask & (best_anchor_iou > 0), best_anchor, A)
    force_pos = overlaps.new_zeros((B, A + 1)).scatter_(1, force_at, 1.0)

    pos = torch.maximum((best_gt_iou > pos_iou).to(overlaps.dtype),
                        force_pos[:, :A])
    any_high = (overlaps >= neg_iou).any(dim=2)
    neg = (1.0 - any_high.to(overlaps.dtype)) * (1.0 - pos)

    matched = torch.gather(gt_boxes, 1,
                           best_gt[..., None].expand(B, A, 7))  # (B, A, 7)
    deltas = box_coding.encode_boxes(matched, anchors, anchor_h,
                                     yaw_mode=yaw_mode)
    return TargetAssignment(pos, neg, deltas * pos[..., None])


def targets_to_maps(assignment: TargetAssignment,
                    feature_shape: tuple[int, int]):
    """(B, A) / (B, A, 7) -> RPN maps (B, H', W', 2), (B, H', W', 2),
    (B, H', W', 14); anchors are row-major over (H', W', 2)."""
    h, w = feature_shape
    B = assignment.pos_mask.shape[0]
    return (assignment.pos_mask.reshape(B, h, w, 2),
            assignment.neg_mask.reshape(B, h, w, 2),
            assignment.reg_targets.reshape(B, h, w, 14))


def assign_targets_np(gt_boxes: np.ndarray, gt_mask: np.ndarray,
                      anchors: np.ndarray, anchors_standup: np.ndarray, *,
                      pos_iou: float, neg_iou: float, anchor_h: float,
                      iou_plus_one: bool = False, yaw_mode: str = "delta"):
    """Numpy twin of `assign_targets` for one frame, for host-side
    precompute: -> (pos (A,), neg (A,), reg_targets (A, 7)) f32."""
    from voxelnet_tpu_torch.ops.iou_np import bev_corners_np

    gt_boxes = np.asarray(gt_boxes, np.float32)
    gt_mask = np.asarray(gt_mask, bool)

    corners = bev_corners_np(gt_boxes[:, [0, 1, 4, 5, 6]])  # (G, 4, 2)
    gt_su = np.stack([
        corners[..., 0].min(-1), corners[..., 1].min(-1),
        corners[..., 0].max(-1), corners[..., 1].max(-1)], -1)

    off = 1.0 if iou_plus_one else 0.0
    b1 = anchors_standup[:, None, :].astype(np.float64)
    b2 = gt_su[None, :, :]
    iw = np.maximum(np.minimum(b1[..., 2], b2[..., 2])
                    - np.maximum(b1[..., 0], b2[..., 0]) + off, 0.0)
    ih = np.maximum(np.minimum(b1[..., 3], b2[..., 3])
                    - np.maximum(b1[..., 1], b2[..., 1]) + off, 0.0)
    inter = iw * ih
    a1 = (b1[..., 2] - b1[..., 0] + off) * (b1[..., 3] - b1[..., 1] + off)
    a2 = (b2[..., 2] - b2[..., 0] + off) * (b2[..., 3] - b2[..., 1] + off)
    union = a1 + a2 - inter
    overlaps = np.where(union > 0, inter / union, 0.0).astype(np.float32)
    overlaps = np.where(gt_mask[None, :], overlaps, -1.0)   # (A, G)

    best_gt = overlaps.argmax(1)
    best_gt_iou = overlaps.max(1)
    best_anchor = overlaps.argmax(0)
    best_anchor_iou = overlaps.max(0)
    pos = (best_gt_iou > pos_iou).astype(np.float32)
    pos[best_anchor[gt_mask & (best_anchor_iou > 0)]] = 1.0
    any_high = (overlaps >= neg_iou).any(1)
    neg = (1.0 - any_high.astype(np.float32)) * (1.0 - pos)

    matched = gt_boxes[best_gt]                              # (A, 7)
    diag = np.sqrt(anchors[:, 4] ** 2 + anchors[:, 5] ** 2)
    dr = matched[:, 6:7] - anchors[:, 6:7]
    if yaw_mode == "sin":
        dr = np.sin(dr - np.pi * np.round(dr / np.pi))
    elif yaw_mode != "delta":
        raise ValueError(f"yaw_mode={yaw_mode!r}")
    deltas = np.concatenate([
        (matched[:, 0:2] - anchors[:, 0:2]) / diag[:, None],
        (matched[:, 2:3] - anchors[:, 2:3]) / anchor_h,
        np.log(np.maximum(matched[:, 3:6], 1e-6) / anchors[:, 3:6]),
        dr], -1).astype(np.float32)
    return pos, neg, deltas * pos[:, None]


class TargetPrecomputer:
    """Host target maps for a batch with gt_boxes/gt_mask: adds
    target_pos, target_neg (B, H', W', 2) and target_reg (B, H', W', 14),
    which the train and eval steps take instead of assigning on the
    device."""

    def __init__(self, config):
        obj = config.object
        self.anchors = np.asarray(anchors_flat(obj), np.float32)
        self.standup = anchor_standup_np(
            obj, buggy=config.compat.buggy_anchor_standup)
        self.kw = dict(pos_iou=obj.rpn_pos_iou, neg_iou=obj.rpn_neg_iou,
                       anchor_h=obj.anchor_h,
                       iou_plus_one=config.compat.iou_plus_one,
                       yaw_mode=config.train.yaw_encoding)
        self.shape = (obj.feature_height, obj.feature_width)

    def __call__(self, batch: dict) -> dict:
        h, w = self.shape
        maps = [assign_targets_np(gt_b, gt_m, self.anchors, self.standup,
                                  **self.kw)
                for gt_b, gt_m in zip(batch["gt_boxes"], batch["gt_mask"])]
        for key, i, c in (("target_pos", 0, 2), ("target_neg", 1, 2),
                          ("target_reg", 2, 14)):
            batch[key] = np.stack([m[i].reshape(h, w, c) for m in maps])
        return batch
