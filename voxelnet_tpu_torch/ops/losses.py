"""RPN losses, as `voxelnet_tpu/ops/losses.py`: alpha/beta-weighted binary
cross-entropy over positive and negative anchors plus smooth L1 on the
positives' regression, each normalised per frame by its assignment count
(clipped at 1). Computed in f32 whatever the compute dtype; the sum over
the batch is of per-frame f32 sums, in f64."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F


def smooth_l1(deltas: torch.Tensor, targets: torch.Tensor,
              sigma: float = 3.0, buggy: bool = False) -> torch.Tensor:
    """Elementwise smooth L1 with its transition at |d| = 1/sigma^2.
    `buggy=True` reproduces the reference's product of the two branches
    (compat.buggy_smooth_l1)."""
    sigma2 = sigma * sigma
    diffs = deltas - targets
    quad = 0.5 * sigma2 * diffs * diffs
    lin = torch.abs(diffs) - 0.5 / sigma2
    if buggy:
        sign = (torch.abs(diffs) < 1.0 / sigma2).to(diffs.dtype)
        return quad * lin + lin * (1.0 - sign)
    return torch.where(torch.abs(diffs) < 1.0 / sigma2, quad, lin)


class RPNLoss(NamedTuple):
    loss: torch.Tensor
    cls_loss: torch.Tensor
    reg_loss: torch.Tensor
    cls_pos_loss: torch.Tensor
    cls_neg_loss: torch.Tensor


def rpn_loss_frames(cls_out: torch.Tensor, reg_out: torch.Tensor,
                    pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                    reg_targets: torch.Tensor, *, alpha: float = 1.5,
                    beta: float = 1.0, sigma: float = 3.0,
                    from_logits: bool = True,
                    buggy_smooth_l1: bool = False) -> RPNLoss:
    """rpn_loss's terms frame by frame: an RPNLoss of (B,) f32 tensors,
    each frame's sum over its anchors."""
    f32 = torch.float32
    pos, neg = pos_mask.to(f32), neg_mask.to(f32)
    cls_out, reg_out = cls_out.to(f32), reg_out.to(f32)
    reg_targets = reg_targets.to(f32)
    frame = (1, 2, 3)

    pos_sum = torch.clamp(pos.sum(dim=frame), min=1.0)[:, None, None, None]
    neg_sum = torch.clamp(neg.sum(dim=frame), min=1.0)[:, None, None, None]
    if from_logits:
        log_p = F.logsigmoid(cls_out)
        log_not_p = F.logsigmoid(-cls_out)
    else:
        log_p = torch.log(cls_out + 1e-6)
        log_not_p = torch.log(1.0 - cls_out + 1e-6)

    cls_pos = (-pos * log_p) / pos_sum
    cls_neg = (-neg * log_not_p) / neg_sum
    cls_loss = (alpha * cls_pos + beta * cls_neg).sum(dim=frame)

    # each anchor's positive flag over its 7 regression channels
    pos_reg = torch.repeat_interleave(pos, 7, dim=-1)
    reg = smooth_l1(reg_out * pos_reg, reg_targets * pos_reg, sigma=sigma,
                    buggy=buggy_smooth_l1)
    reg_loss = (reg / pos_sum).sum(dim=frame)
    return RPNLoss(loss=cls_loss + reg_loss, cls_loss=cls_loss,
                   reg_loss=reg_loss, cls_pos_loss=cls_pos.sum(dim=frame),
                   cls_neg_loss=cls_neg.sum(dim=frame))


def sum_frames(t: torch.Tensor) -> torch.Tensor:
    """A (B,) f32 tensor of per-frame terms -> their sum in f64, which
    does not depend, to f64 rounding, on the frames' order or on their
    split across processes."""
    return t.sum(dtype=torch.float64)


def rpn_loss(cls_out: torch.Tensor, reg_out: torch.Tensor,
             pos_mask: torch.Tensor, neg_mask: torch.Tensor,
             reg_targets: torch.Tensor, **kw) -> RPNLoss:
    """cls_out (B, H', W', 2) logits (or probabilities when not
    `from_logits`), reg_out (B, H', W', 14), pos/neg masks (B, H', W', 2),
    reg_targets (B, H', W', 14) -> RPNLoss of f32 scalars: sums over the
    batch of rpn_loss_frames' terms (keywords alpha, beta, sigma,
    from_logits, buggy_smooth_l1)."""
    frames = rpn_loss_frames(cls_out, reg_out, pos_mask, neg_mask,
                             reg_targets, **kw)
    return RPNLoss(*(sum_frames(t).to(torch.float32) for t in frames))
