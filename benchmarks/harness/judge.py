"""The comparisons that decide `correct`: the program's detections and
training steps against the plain reference's, as numbers, each held to a
limit of its own (`benchmarks/limits/<workload>.json`).

Detections (per sampled frame; the reference's maps are computed anew
from the same points and weights). The weights put every detection
within 0.1 m of its anchor's centre and within 0.4 rad of its yaw (see
harness/weights.py), which names the anchor it came from:
  reg_gap    the widest difference, over the program's detections and
             the 7 deltas, between the regression delta that a
             detection's box implies at its anchor and the reference's
             delta there, each over its channel's gain (weights.REG_GAIN):
             in units of the head's own output, so that the centres'
             and the yaw's small deltas count as the sizes' do
  reg_scale_gap  over all sampled detections, per delta the least-squares
             slope of the implied deltas on the reference's, and of the
             7 the widest |slope - 1|: a decoding that scales a delta
             wrongly, by however little, moves it
  logit_gap  the widest difference between a detection's score, as a
             logit, and the reference's logit at its anchor, both read
             as at most LOGIT_CAP
  nms_faults the reference's own detections that no program detection
             explains, plus the program's detections that break the NMS
             contract (see `nms_faults`)
Training (the first three steps, set-up's, against the reference's):
  head_grad_dir  the widest distance, over the leaves of the two heads
             (rpn.prob_conv, rpn.reg_conv), between the directions (unit
             vectors) of the program's first clipped gradient (from the
             parameters before and after the first step) and the
             reference's: 0 alike, 1 a step that moved nothing, 2 the
             opposite way. The heads' gradients read the forward pass and
             the targets of every frame, and no backward pass through the
             deep layers
  bn_gap     the batch statistics that the first step moved into the
             running statistics of the VFE's and the middle's batch-norms:
             the widest, over their channels, of the mean's gap over the
             reference's std and the variance's gap over its variance
and, read but compared in no cell (PERF.md gives why): head_change_dir
(head_grad_dir for the change over the three steps), bn3_gap (bn_gap for
the statistics the three steps moved), grad_gap and change_gap (over all
kept leaves, the median of the gaps between the norms of the first
clipped gradient, or of the three steps' change, and the reference's,
each over the larger of the reference leaf's norm and the median
leaf's), grad_dir (the median leaf's |difference| of the first gradient,
relative as grad_gap), loss_gap (the widest relative gap of a step's
loss), loss1_gap (the first step's), neg_loss_gap (the first step's
negative-anchor loss), norm_gap (its gradient norm before the clip).
Deeper leaves are not compared: their gradients pass back through some
twenty batch-normed layers of random weights, and the program's bfloat16
(or the reference's own in bfloat16) turns their direction by 0.4-0.7 on
every seed; nor are the RPN's batch statistics, which the control moves
less than the first layers' (PERF.md). Leaves whose reference gradient
is under a thousandth of the median leaf's (a conv bias ahead of a
batch-norm, moved by round-off alone) are left out.
"""

from __future__ import annotations

import torch

from benchmarks.harness import weights
from benchmarks.reference import detect
from benchmarks.reference import train as ref_train

# what the NMS check forgives: two detections whose reference logits lie
# within LOGIT_SLACK of each other (or of the gate's) may be ranked
# either way round: half as much again as the widest logit_gap that
# sound runs read (1.35, PERF.md); an overlap this close to the NMS
# threshold may fall on either side
LOGIT_SLACK = 2.0
IOU_SLACK = 0.05
DROP_RATIO = 1e-3
# logits are compared up to this: the program's float32 scores resolve
# a logit of 12 to 0.01, and from about 16.6 on they are 1.0
LOGIT_CAP = 12.0
# the regression head's gain of each delta (both anchors of a cell alike)
GAIN = weights.REG_GAIN[:7]
HEADS = ("rpn.prob_conv.", "rpn.reg_conv.")


def anchor_of(boxes: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(P, 7) boxes -> the index of the anchor each came from: the
    nearest anchor centre on the (H', W') grid, and of its two the one of
    the nearer yaw (0 or pi/2, modulo pi)."""
    obj = cfg["object"]
    r = obj["feature_ratio"]
    h = int(round((obj["y_max"] - obj["y_min"]) / obj["y_voxel_size"])) // r
    w = int(round((obj["x_max"] - obj["x_min"]) / obj["x_voxel_size"])) // r
    ix = torch.round((boxes[:, 0] - obj["x_min"]) / (obj["x_max"]
                                                     - obj["x_min"])
                     * (w - 1)).clamp(0, w - 1).long()
    iy = torch.round((boxes[:, 1] - obj["y_min"]) / (obj["y_max"]
                                                     - obj["y_min"])
                     * (h - 1)).clamp(0, h - 1).long()
    j = torch.remainder(torch.round(boxes[:, 6] / (torch.pi / 2)), 2).long()
    return (iy * w + ix) * 2 + j


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-12, 1 - 2 ** -24)
    return torch.log(p) - torch.log1p(-p)


def detections_numbers(prog: torch.Tensor, ref_deltas: torch.Tensor,
                       ref_logits: torch.Tensor, anc: torch.Tensor,
                       cfg: dict) -> dict:
    """prog (P, 9) one frame's program output rows (box 7, score, valid);
    the reference's deltas (A, 7) and logits (A,) at every anchor, the
    anchors (A, 7) -> {reg_gap, logit_gap, nms_faults} of the frame, and
    'implied' and 'want' (P', 7): the deltas that its detections imply
    and the reference's at their anchors (for `reg_scale_gap`)."""
    valid = prog[:, 8] > 0.5
    boxes = prog[valid, :7].to(torch.float64)
    lg = logit(prog[valid, 7].to(torch.float64))
    ref_deltas = ref_deltas.to(torch.float64)
    ref_logits = ref_logits.to(torch.float64)
    anc = anc.to(torch.float64)
    idx = anchor_of(boxes, cfg)
    implied = ref_train.encode(boxes, anc[idx], cfg)
    want = ref_deltas[idx]
    if cfg["train"]["yaw_encoding"] == "sin":
        want = torch.cat([want[:, :6], want[:, 6:].clamp(-1, 1)], 1)
    gain = torch.tensor(GAIN, dtype=torch.float64, device=boxes.device)
    reg_gap = (float(((implied - want).abs() / gain).amax()) if len(idx)
               else 0.0)
    logit_gap = float((lg.clamp(max=LOGIT_CAP) - ref_logits[idx].clamp(
        max=LOGIT_CAP)).abs().amax()) if len(idx) else 0.0
    ref_boxes = detect.decode(ref_deltas, anc, cfg)
    return {"reg_gap": reg_gap, "logit_gap": logit_gap,
            "nms_faults": nms_faults(boxes, idx, ref_boxes, ref_logits,
                                     LOGIT_SLACK, cfg),
            "implied": implied, "want": want}


def reg_scale_gap(implied: torch.Tensor, want: torch.Tensor) -> float:
    """(P, 7) implied and reference deltas over all sampled detections ->
    the widest |slope - 1| of the 7 least-squares slopes through 0."""
    den = (want * want).sum(0)
    if len(want) == 0 or bool((den == 0).any()):
        return 0.0
    return float(((implied * want).sum(0) / den - 1).abs().amax())


def nms_faults(boxes, idx, ref_boxes, ref_logits, slack: float,
               cfg: dict) -> int:
    """Counted against the reference's own NMS of the frame, logits read
    as at most LOGIT_CAP:
      - a reference detection that is not among the program's (by
        anchor), unless a program detection overlaps it above nms_thres -
        IOU_SLACK with a reference logit no more than `slack` under its
        own (near-equal scores ranked the other way round), or its logit
        lies within `slack` of the gate's, or the program filled its
        nms_post_topk slots with detections that the reference scores no
        more than `slack` under it;
      - two program detections that overlap above nms_thres + IOU_SLACK;
      - a program detection whose anchor the reference puts more than
        `slack` under the gate."""
    rpn = cfg["rpn"]
    gate = float(logit(torch.tensor(rpn["score_thres"], dtype=torch.float64)))
    thres = rpn["nms_thres"]
    r_boxes, _, r_idx = detect.nms(ref_boxes, torch.sigmoid(ref_logits), cfg)
    at = ref_logits[idx].clamp(max=LOGIT_CAP)
    faults = 0
    if len(r_idx):
        r_logit = ref_logits[r_idx].clamp(max=LOGIT_CAP)
        kept = (r_idx[:, None] == idx[None]).any(1)
        if len(idx):
            iou = detect.rotated_iou(detect.bev(r_boxes), detect.bev(boxes))
            cover = ((iou > thres - IOU_SLACK)
                     & (at[None] >= r_logit[:, None] - slack)).any(1)
        else:
            cover = torch.zeros_like(kept)
        excused = r_logit < gate + slack
        if len(idx) == rpn["nms_post_topk"]:
            excused |= r_logit <= at.min() + slack
        faults += int((~kept & ~cover & ~excused).sum())
    if len(idx) > 1:
        iou = detect.rotated_iou(detect.bev(boxes), detect.bev(boxes))
        faults += int(torch.triu(iou > thres + IOU_SLACK, 1).sum())
    faults += int((at < gate - slack).sum())
    return faults


def leaf_gaps(prog: dict, ref: dict, kept: list[str]) -> list[float]:
    """Each kept leaf's |norm(prog[n]) - norm(ref[n])| over the larger of
    norm(ref[n]) and the median of the kept leaves' reference norms."""
    rn = {n: float(ref[n].double().norm()) for n in kept}
    median = float(torch.tensor(list(rn.values())).median())
    return [abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], median)
            for n in kept]


def median(values: list[float]) -> float:
    return float(torch.tensor(values, dtype=torch.float64).median())


TERMS = ("loss", "cls_neg_loss", "grad_norm")


def relative(a: float, b: float) -> float:
    """|a - b| over |b|; 0 where both are 0."""
    if b == 0:
        return 0.0 if a == 0 else float("inf")
    return abs(a - b) / abs(b)


def direction_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a / |a| - b / |b||: 0 alike, 1 where a is 0, 2 opposite."""
    nb = b.norm()
    na = a.norm()
    ua = a / na if float(na) > 0 else torch.zeros_like(a)
    return float((ua - b / nb).norm())


STATS = (".running_mean", ".running_var")
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def bn_gaps(prog: dict, ref: dict, key: str, keep: float) -> dict:
    """Each batch-norm layer -> the widest gap, over its channels, of the
    statistics that the step(s) up to snapshot `key` moved into its
    running statistics ((r_key - keep * r_p0) / (1 - keep): the batch's
    own after one step, a weighted mean of the steps' after three):
    (mean gap over the reference's std, variance gap over the reference's
    variance), each with batch-norm's eps."""
    out = {}
    for n in ref["p0"]:
        if not n.endswith(STATS[0]):
            continue
        layer = n[: -len(STATS[0])]

        def moved(s, stat):
            r0 = s["p0"][layer + stat].double()
            return (s[key][layer + stat].double() - keep * r0) / (1 - keep)

        m_p, m_r = moved(prog, STATS[0]), moved(ref, STATS[0])
        v_p, v_r = moved(prog, STATS[1]), moved(ref, STATS[1])
        out[layer] = (
            float(((m_p - m_r).abs() / (v_r.clamp(min=0) + BN_EPS).sqrt())
                  .amax()),
            float(((v_p - v_r).abs() / (v_r.clamp(min=0) + BN_EPS)).amax()))
    return out


def train_numbers(prog: dict, ref: dict, lr: float,
                  leaves: bool = False) -> dict:
    """prog and ref: {'losses': [a dict of TERMS a step], 'p0', 'p1',
    'p3': {leaf or running statistic: tensor}} -> the numbers of the
    module's docstring (and with `leaves` each kept leaf's direction gaps
    and each batch-norm layer's statistics gaps, for calibrate.py)."""
    names = [n for n in ref["p0"] if not n.endswith(STATS)]

    def grad(s, n):
        return (s["p0"][n].double() - s["p1"][n].double()) / lr

    def change(s, n):
        return s["p3"][n].double() - s["p0"][n].double()

    gr = {n: grad(ref, n) for n in names}
    norms = [float(g.norm()) for g in gr.values()]
    kept = [n for n, v in zip(names, norms) if v >= DROP_RATIO
            * median(norms)]
    heads = [n for n in kept if n.startswith(HEADS)]
    first_p, first_r = prog["losses"][0], ref["losses"][0]

    def leaf_diffs(fn):
        """Each kept leaf's |prog - ref| over the larger of its |ref| and
        the median leaf's."""
        rn = {n: float(fn(ref, n).norm()) for n in kept}
        med = median(list(rn.values()))
        return [float((fn(prog, n) - fn(ref, n)).norm()) / max(rn[n], med)
                for n in kept]

    def dirs(fn, names_):
        return {n: direction_gap(fn(prog, n), fn(ref, n)) for n in names_}

    bn1 = bn_gaps(prog, ref, "p1", BN_MOMENTUM)
    bn3 = bn_gaps(prog, ref, "p3", BN_MOMENTUM ** 3)
    out = {
        "head_grad_dir": max(dirs(grad, heads).values()),
        "head_change_dir": max(dirs(change, heads).values()),
        "bn_gap": max(max(v) for k, v in bn1.items()
                      if not k.startswith("rpn.")),
        "bn3_gap": max(max(v) for k, v in bn3.items()
                       if not k.startswith("rpn.")),
        "grad_dir": median(leaf_diffs(grad)),
        "loss_gap": max(relative(a["loss"], b["loss"]) for a, b in
                        zip(prog["losses"], ref["losses"])),
        "neg_loss_gap": relative(first_p["cls_neg_loss"],
                                 first_r["cls_neg_loss"]),
        "norm_gap": relative(first_p["grad_norm"], first_r["grad_norm"]),
        "loss1_gap": relative(first_p["loss"], first_r["loss"]),
        "grad_gap": median(leaf_gaps({n: grad(prog, n) for n in kept}, gr,
                                     kept)),
        "change_gap": median(leaf_gaps({n: change(prog, n) for n in kept},
                                       {n: change(ref, n) for n in kept},
                                       kept)),
    }
    if leaves:
        out["grad_dirs"] = dirs(grad, kept)
        out["change_dirs"] = dirs(change, kept)
        out["bn1"] = bn1
        out["bn3"] = bn3
    return out
