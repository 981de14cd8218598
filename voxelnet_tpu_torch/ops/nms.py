"""Batched score gate + exact top-k + greedy BEV NMS with fixed output
shapes, as `voxelnet_tpu/ops/nms.py::nms_bev` under `vmap`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.ops import iou as iou_ops


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, post_topk, 7) lidar boxes
    scores: torch.Tensor   # (B, post_topk)
    valid: torch.Tensor    # (B, post_topk) bool


def greedy_suppress(iou_mat: torch.Tensor, order_valid: torch.Tensor,
                    thresh: float) -> torch.Tensor:
    """Exact greedy NMS keep mask over score-sorted candidates.

    iou_mat (..., k, k), order_valid (..., k) bool -> keep (..., k).
    Iterates keep <- valid & no higher-ranked kept candidate overlaps me,
    from keep = valid, to its fixpoint, which is the greedy solution and is
    reached within the depth of the longest suppression chain. A frame that
    has converged is a fixpoint, so the batch iterates together. Each
    iteration's test waits for the device; inside a traced call
    (tracing.py) the waits count in `host.wait_ns` and the iterations in
    `nms.iters`.
    """
    k = iou_mat.shape[-1]
    rank = torch.arange(k, device=iou_mat.device)
    over = (iou_mat > thresh) & (rank[:, None] < rank[None, :])
    keep = order_valid
    prev = torch.zeros_like(keep)
    it = 0
    call = tracing.current
    while it < k and tracing.wait(call, (keep != prev).any()):
        suppressed = (over & keep[..., :, None]).any(dim=-2)
        keep, prev = order_valid & ~suppressed, keep
        it += 1
    if call is not None:
        call.add("nms.iters", it)
    return keep


def nms_bev(boxes3d: torch.Tensor, scores: torch.Tensor, *,
            score_thresh: float, iou_thresh: float, pre_topk: int,
            post_topk: int, mode: str = "rotated") -> NMSResult:
    """boxes3d (B, A, 7), scores (B, A) -> NMSResult with post_topk slots
    per frame; invalid slots are padding (under the score gate, or
    suppressed). mode 'rotated' is exact rotated-BEV IoU, 'standup' the
    axis-aligned IoU of the rotated corners' bounding boxes.

    Exact score ties keep the lower anchor index first, as lax.top_k
    does: a stable descending sort in place of torch.topk, which orders
    ties in no fixed way (an untrained net's scores tie by the dozen, and
    the greedy NMS then keeps other boxes than JAX's).
    """
    scores = scores.to(torch.float32)
    gated = torch.where(scores >= score_thresh, scores,
                        torch.full_like(scores, -1.0))
    k = min(pre_topk, scores.shape[-1])
    top_scores, top_idx = torch.sort(gated, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    cand = torch.gather(boxes3d.to(torch.float32), 1,
                        top_idx[..., None].expand(*top_idx.shape, 7))
    cand_valid = top_scores >= score_thresh
    call = tracing.current
    if call is not None:
        # pairs whose IoU is computed, and those of two candidates over
        # the score gate (a count on the device)
        call.add("nms.iou_pairs", cand_valid.numel() * k)
        live = cand_valid.sum(-1)
        call.add("nms.iou_pairs_live", (live * live).sum())

    bev = cand[..., [0, 1, 4, 5, 6]]
    with tracing.span("nms.iou"):
        if mode == "rotated":
            mat = iou_ops.rotated_iou(bev, bev)
        elif mode == "standup":
            standup = iou_ops.corners_to_standup(iou_ops.bev_corners(bev))
            mat = iou_ops.standup_iou(standup, standup)
        else:
            raise ValueError(f"unknown NMS mode {mode!r}")
    with tracing.span("nms.greedy"):
        keep = greedy_suppress(mat, cand_valid, iou_thresh)

    # compact the kept candidates to the front in score order; slot
    # post_topk is a drop slot, cut off below
    pos = torch.cumsum(keep, dim=-1) - 1
    rank = torch.where(keep & (pos < post_topk), pos,
                       torch.full_like(pos, post_topk))
    b = boxes3d.shape[0]
    out_boxes = cand.new_zeros((b, post_topk + 1, 7)).scatter_(
        1, rank[..., None].expand(*rank.shape, 7), cand)
    out_scores = cand.new_zeros((b, post_topk + 1)).scatter_(
        1, rank, top_scores)
    out_valid = torch.zeros((b, post_topk + 1), dtype=torch.bool,
                            device=cand.device).scatter_(1, rank, keep)
    return NMSResult(out_boxes[:, :post_topk], out_scores[:, :post_topk],
                     out_valid[:, :post_topk])
