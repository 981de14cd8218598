"""Plain detection head arithmetic in float32/float64 torch: the anchor
grid, box decoding, exact rotated bird's-eye-view IoU and greedy NMS,
written from the configuration's numbers. Imports nothing of the
measured program.

Boxes are (x, y, z, h, w, l, yaw) in the LiDAR frame; a BEV box is
(x, y, w, l, yaw), its length along the heading.
"""

from __future__ import annotations

import math

import torch


def anchors(cfg: dict, device=None) -> torch.Tensor:
    """(H' * W' * 2, 7) f32: two anchors (yaw 0 and pi/2) per cell of the
    (H', W') feature map, centres on an inclusive linspace over the x and
    y ranges, row-major over (H', W', 2)."""
    obj = cfg["object"]
    r = obj["feature_ratio"]
    h = int(round((obj["y_max"] - obj["y_min"]) / obj["y_voxel_size"])) // r
    w = int(round((obj["x_max"] - obj["x_min"]) / obj["x_voxel_size"])) // r
    xs = torch.linspace(obj["x_min"], obj["x_max"], w, dtype=torch.float64)
    ys = torch.linspace(obj["y_min"], obj["y_max"], h, dtype=torch.float64)
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    out = torch.zeros((h, w, 2, 7), dtype=torch.float64)
    out[..., 0] = cx[..., None]
    out[..., 1] = cy[..., None]
    out[..., 2] = obj["anchor_z"]
    out[..., 3] = obj["anchor_h"]
    out[..., 4] = obj["anchor_w"]
    out[..., 5] = obj["anchor_l"]
    out[..., 1, 6] = math.pi / 2
    return out.reshape(-1, 7).to(torch.float32).to(device)


def decode(deltas: torch.Tensor, anc: torch.Tensor, cfg: dict):
    """deltas (..., A, 7) -> boxes (..., A, 7): centre offsets scaled by
    the anchor's BEV diagonal (z by its height), sizes by exp, yaw added
    (train.yaw_encoding 'delta') or arcsin of the clipped delta ('sin')."""
    anc = anc.to(deltas.dtype)
    diag = torch.sqrt(anc[:, 4] ** 2 + anc[:, 5] ** 2)
    xy = deltas[..., :2] * diag[:, None] + anc[:, :2]
    z = deltas[..., 2:3] * cfg["object"]["anchor_h"] + anc[:, 2:3]
    hwl = torch.exp(deltas[..., 3:6]) * anc[:, 3:6]
    dr = deltas[..., 6:7]
    if cfg["train"]["yaw_encoding"] == "sin":
        dr = torch.asin(torch.clamp(dr, -1.0, 1.0))
    return torch.cat([xy, z, hwl, dr + anc[:, 6:7]], dim=-1)


def corners(bev: torch.Tensor) -> torch.Tensor:
    """(..., 5) BEV boxes -> (..., 4, 2) corners, counter-clockwise."""
    x, y, w, length, r = bev.unbind(-1)
    lx = length[..., None] * bev.new_tensor([0.5, -0.5, -0.5, 0.5])
    ly = w[..., None] * bev.new_tensor([0.5, 0.5, -0.5, -0.5])
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    return torch.stack([c * lx - s * ly + x[..., None],
                        s * lx + c * ly + y[..., None]], dim=-1)


def _inside_edges(a: torch.Tensor, b: torch.Tensor,
                  shrink: float) -> torch.Tensor:
    """Twice the signed area swept by the parts of a's edges that lie
    inside b (by at least `shrink`): a (N, 4, 2), b (M, 4, 2) convex
    CCW -> (N, M)."""
    p = a[:, None, :, None, :]                     # (N, 1, 4, 1, 2)
    d = (torch.roll(a, -1, dims=1) - a)[:, None, :, None, :]
    q = b[None, :, None, :, :]                     # (1, M, 1, 4, 2)
    e = (torch.roll(b, -1, dims=1) - b)[None, :, None, :, :]
    # inside b's edge j: cross(e_j, p + t d - q_j) >= 0
    c0 = (e[..., 0] * (p[..., 1] - q[..., 1])
          - e[..., 1] * (p[..., 0] - q[..., 0]) - shrink)
    cd = e[..., 0] * d[..., 1] - e[..., 1] * d[..., 0]
    flat = cd.abs() < 1e-12
    t = -c0 / torch.where(flat, torch.ones_like(cd), cd)
    lo = torch.where(~flat & (cd > 0), t, torch.full_like(t, -1e30))
    hi = torch.where(~flat & (cd < 0), t, torch.full_like(t, 1e30))
    dead = (flat & (c0 < 0)).any(-1)
    t0 = lo.amax(-1).clamp(min=0.0)
    t1 = hi.amin(-1).clamp(max=1.0)
    ok = (t1 > t0) & ~dead                         # (N, M, 4)
    p, d = p[..., 0, :], d[..., 0, :]
    ax, ay = p[..., 0] + t0 * d[..., 0], p[..., 1] + t0 * d[..., 1]
    bx, by = p[..., 0] + t1 * d[..., 0], p[..., 1] + t1 * d[..., 1]
    return torch.where(ok, ax * by - bx * ay, torch.zeros_like(ax)).sum(-1)


def rotated_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """BEV IoU of (N, 5) and (M, 5) boxes -> (N, M), in float64: the
    intersection's area from the parts of each box's edges inside the
    other (the shoelace sum over the intersection's boundary; an edge
    that both boxes share counts once, from a's side)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    origin = a[:, None, :2].mean(0, keepdim=True)  # one shift for all
    ca = corners(a) - origin
    cb = corners(b) - origin
    inter = 0.5 * (_inside_edges(ca, cb, 0.0)
                   + _inside_edges(cb, ca, 1e-9).T)
    inter = inter.clamp(min=0.0)
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def bev(boxes: torch.Tensor) -> torch.Tensor:
    return boxes[..., [0, 1, 4, 5, 6]]


def nms(boxes: torch.Tensor, scores: torch.Tensor, cfg: dict):
    """One frame: boxes (A, 7), scores (A,) -> (kept boxes (k, 7), kept
    scores (k,), kept anchor indices (k,)): the anchors with score >=
    rpn.score_thres, the rpn.nms_pre_topk best (ties: lower index
    first), greedy suppression above rpn.nms_thres IoU (rotated BEV, or
    the corners' axis-aligned boxes for nms_mode 'standup'), at most
    rpn.nms_post_topk kept."""
    rpn = cfg["rpn"]
    idx = torch.nonzero(scores >= rpn["score_thres"]).flatten()
    order = torch.sort(scores[idx], descending=True, stable=True).indices
    idx = idx[order][: rpn["nms_pre_topk"]]
    cand = boxes[idx]
    if rpn["nms_mode"] == "rotated":
        iou = rotated_iou(bev(cand), bev(cand))
    else:
        c = corners(bev(cand).to(torch.float64))
        lo, hi = c.amin(1), c.amax(1)
        wh = (torch.minimum(hi[:, None], hi[None]) - torch.maximum(
            lo[:, None], lo[None])).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        area = (hi - lo).prod(-1)
        iou = inter / (area[:, None] + area[None] - inter)
    over = (iou > rpn["nms_thres"]).cpu()
    keep = []
    alive = torch.ones(len(idx), dtype=torch.bool)
    for i in range(len(idx)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) == rpn["nms_post_topk"]:
            break
        alive &= ~over[i]
    keep = torch.tensor(keep, dtype=torch.long, device=boxes.device)
    return cand[keep], scores[idx][keep], idx[keep]
