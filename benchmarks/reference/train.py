"""Plain float32 training step of VoxelNet over the params dict of
`net.py`: anchor targets, the RPN loss, the gradient by autograd, the
clip by global norm and the SGD update, written from the configuration's
numbers. Imports nothing of the measured program.

Targets: a GT box and an anchor overlap by the IoU of their axis-aligned
BEV boxes (the GT's from its rotated corners); an anchor is positive
above object.rpn_pos_iou with some GT, or as the best anchor of a GT
that it overlaps at all; negative where it overlaps no GT at
object.rpn_neg_iou and is not positive; a positive's regression target
encodes its best GT. The loss of a frame: alpha times the positives'
binary cross-entropy over their count, beta times the negatives' over
theirs (each count at least 1), and the positives' smooth L1 (sigma)
over the positives' count; the batch's loss is the sum over frames.
The update: the gradient clipped to train.gradient_clip by its global
norm (left as it is below it), then p - lr * g.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmarks.reference import detect
from benchmarks.reference import net as ref

PARAM_KINDS = ("weight", "bias", "bn_weight", "bn_bias")


def param_names(cfg: dict) -> list[str]:
    """The trained leaves, in param_specs' order."""
    return [n for n, (_, kind, _) in ref.param_specs(cfg).items()
            if kind in PARAM_KINDS]


def targets(gt: torch.Tensor, gt_mask: torch.Tensor, anc: torch.Tensor,
            cfg: dict):
    """gt (B, G, 7), gt_mask (B, G) bool, anchors (A, 7) -> (pos (B, A),
    neg (B, A), reg targets (B, A, 7)), float32."""
    obj = cfg["object"]
    yaw90 = torch.arange(len(anc), device=anc.device) % 2 == 1
    ext_x = torch.where(yaw90, anc[:, 4], anc[:, 5]) / 2
    ext_y = torch.where(yaw90, anc[:, 5], anc[:, 4]) / 2
    a_lo = torch.stack([anc[:, 0] - ext_x, anc[:, 1] - ext_y], -1)
    a_hi = torch.stack([anc[:, 0] + ext_x, anc[:, 1] + ext_y], -1)
    c = detect.corners(detect.bev(gt))                  # (B, G, 4, 2)
    g_lo, g_hi = c.amin(-2), c.amax(-2)
    lo = torch.maximum(a_lo[None, :, None], g_lo[:, None])
    hi = torch.minimum(a_hi[None, :, None], g_hi[:, None])
    wh = (hi - lo).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]                     # (B, A, G)
    area_a = (a_hi - a_lo).prod(-1)[None, :, None]
    area_g = (g_hi - g_lo).prod(-1)[:, None]
    union = area_a + area_g - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    iou = torch.where(gt_mask[:, None], iou, torch.full_like(iou, -1.0))
    best_gt_iou, best_gt = iou.max(2)
    best_anchor_iou, best_anchor = iou.max(1)           # (B, G)
    pos = best_gt_iou > obj["rpn_pos_iou"]
    forced = gt_mask & (best_anchor_iou > 0)
    b = torch.arange(len(gt), device=gt.device)[:, None].expand_as(forced)
    pos[b[forced], best_anchor[forced]] = True
    neg = ~(iou >= obj["rpn_neg_iou"]).any(2) & ~pos
    matched = torch.gather(gt, 1, best_gt[..., None].expand(-1, -1, 7))
    return pos.float(), neg.float(), encode(matched, anc, cfg) * pos[
        ..., None]


def encode(boxes: torch.Tensor, anc: torch.Tensor, cfg: dict):
    """The inverse of detect.decode: boxes (..., A, 7) -> deltas."""
    diag = torch.sqrt(anc[:, 4] ** 2 + anc[:, 5] ** 2)
    xy = (boxes[..., :2] - anc[:, :2]) / diag[:, None]
    z = (boxes[..., 2:3] - anc[:, 2:3]) / cfg["object"]["anchor_h"]
    hwl = torch.log(boxes[..., 3:6].clamp(min=1e-6) / anc[:, 3:6])
    r = boxes[..., 6:7] - anc[:, 6:7]
    if cfg["train"]["yaw_encoding"] == "sin":
        r = torch.sin(r - torch.pi * torch.round(r / torch.pi))
    return torch.cat([xy, z, hwl, r], dim=-1)


def loss(cls: torch.Tensor, reg: torch.Tensor, pos, neg, reg_t,
         cfg: dict) -> dict:
    """cls (B, H', W', 2) logits, reg (B, H', W', 14), targets over (B, A)
    -> the batch's loss and its terms (each the sum of its frames'):
    loss, cls_pos_loss, cls_neg_loss, reg_loss."""
    t = cfg["train"]
    B = cls.shape[0]
    x = cls.reshape(B, -1)
    d = reg.reshape(B, -1, 7)
    n_pos = pos.sum(1).clamp(min=1.0)
    n_neg = neg.sum(1).clamp(min=1.0)
    cls_pos = (-pos * F.logsigmoid(x)).sum(1) / n_pos
    cls_neg = (-neg * F.logsigmoid(-x)).sum(1) / n_neg
    s2 = t["sigma"] ** 2
    diff = (d - reg_t) * pos[..., None]
    sl1 = torch.where(diff.abs() < 1.0 / s2, 0.5 * s2 * diff * diff,
                      diff.abs() - 0.5 / s2)
    reg_loss = sl1.sum((1, 2)) / n_pos
    total = t["alpha"] * cls_pos + t["beta"] * cls_neg + reg_loss
    return {"loss": total.sum(), "cls_pos_loss": cls_pos.sum(),
            "cls_neg_loss": cls_neg.sum(), "reg_loss": reg_loss.sum()}


def step(cfg: dict, params: dict, points, num_points, gt, gt_mask,
         lr: float, device, quant=None, frames=None) -> dict:
    """One training step on a batch, in place on `params` (leaves and
    running statistics) -> its loss, the loss's terms and the global norm
    of the gradient before the clip (floats).
    `frames`: train on these frames of the batch only, the loss scaled to
    the batch's size (a fault of the check's own: half of the batch left
    out, the mean over the rest)."""
    names = param_names(cfg)
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    net_params = dict(params, **leaves)
    scale = 1.0
    if frames is not None:
        scale = len(points) / len(frames)
        points, num_points = points[frames], num_points[frames]
        gt, gt_mask = gt[frames], gt_mask[frames]
    feats, coords, counts = ref.voxelize(points, num_points, cfg)
    net = ref.Net(cfg, net_params, "train", quant)
    with ref.full_f32():
        cls, reg = net(*(torch.from_numpy(a).to(device)
                         for a in (feats, coords, counts)))
        anc = detect.anchors(cfg, device)
        pos, neg, reg_t = targets(torch.as_tensor(gt, device=device),
                                  torch.as_tensor(gt_mask, device=device),
                                  anc, cfg)
        terms = {k: v * scale for k, v in loss(cls, reg, pos, neg, reg_t,
                                                cfg).items()}
        grads = torch.autograd.grad(terms["loss"],
                                    [leaves[n] for n in names])
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    terms["grad_norm"] = norm
    clip = cfg["train"]["gradient_clip"]
    with torch.no_grad():
        for n, g in zip(names, grads):
            if norm >= clip:
                g = g / norm * clip
            params[n].sub_(lr * g)
    return {k: float(v.detach()) for k, v in terms.items()}
