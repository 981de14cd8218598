"""KITTI 3D / BEV average precision evaluation: the port's copy of
`voxelnet_tpu/training/evaluate.py` (numpy), with the same results.

The KITTI devkit's metric in Python: 11-point (devkit classic / VoxelNet paper) or 40-point (modern devkit)
interpolated AP at a given IoU threshold over the KITTI difficulty buckets
(easy/moderate/hard by 2D box height, occlusion, truncation), with
rotated-BEV or full-3D IoU, devkit ignored-GT / small-detection /
DontCare-region semantics (care GTs take assignment priority; a care GT
consumed by an ignored detection leaves the denominator), and optional
AOS (average orientation similarity).

Per-frame matching: one (P, G) rotated-IoU matrix (`ops/iou_np.py`) and a
greedy sweep over the detections.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from voxelnet_tpu_torch.ops.iou_np import box3d_iou_matrix_np
from voxelnet_tpu_torch.utils import geometry

# KITTI devkit difficulty thresholds:
#   min 2D bbox height (px), max occlusion level, max truncation
DIFFICULTY = {
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}


# KITTI devkit "neighboring classes": detections matched to these are
# neither TPs nor FPs, and they never count toward num_gt.
IGNORED_NEIGHBORS = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}


@dataclass
class GroundTruth:
    boxes_lidar: np.ndarray   # (N, 7)
    bbox_height: np.ndarray   # (N,) 2D box height in px
    occlusion: np.ndarray     # (N,) int
    truncation: np.ndarray    # (N,) float
    ignored: np.ndarray = None  # (N,) bool — neighboring-class boxes
    alpha: np.ndarray = None    # (N,) observation angle (AOS; optional)
    dontcare: np.ndarray = None  # (Nd, 4) DontCare 2D regions (x1,y1,x2,y2)

    def __post_init__(self):
        if self.ignored is None:
            self.ignored = np.zeros(len(self.boxes_lidar), bool)
        if self.dontcare is None:
            self.dontcare = np.zeros((0, 4), np.float32)


def parse_gt_for_eval(label_lines, cls_name="Car",
                      T_VELO_2_CAM=None, R_RECT_0=None) -> GroundTruth:
    """Parse one frame's label lines keeping difficulty metadata.

    Neighboring classes (Van for Car, Person_sitting for Pedestrian) are
    kept but flagged `ignored`: the devkit neither requires nor penalizes
    detecting them.
    """
    neighbors = IGNORED_NEIGHBORS.get(cls_name, ())
    acc = (cls_name,) + tuple(neighbors)
    rows, hts, occ, trunc, ign, alphas, dc = [], [], [], [], [], [], []
    for line in label_lines:
        f = line.split()
        if not f:
            continue
        if f[0] == "DontCare":
            # devkit: detections inside DontCare 2D regions are neither
            # TP nor FP (cpp/evaluate_object.cpp boxoverlap criterion)
            dc.append([float(v) for v in f[4:8]])
            continue
        if f[0] not in acc:
            continue
        h, w, l, x, y, z, r = (float(v) for v in f[8:15])
        rows.append((x, y, z, h, w, l, r))
        hts.append(float(f[7]) - float(f[5]))   # y2 - y1
        occ.append(int(float(f[2])))
        trunc.append(float(f[1]))
        ign.append(f[0] in neighbors)
        alphas.append(float(f[3]))
    cam = np.asarray(rows, np.float32).reshape(-1, 7)
    lidar = (geometry.camera_to_lidar_boxes(cam, T_VELO_2_CAM, R_RECT_0)
             .astype(np.float32) if len(cam) else cam)
    return GroundTruth(lidar, np.asarray(hts, np.float32),
                       np.asarray(occ, np.int32),
                       np.asarray(trunc, np.float32),
                       np.asarray(ign, bool),
                       np.asarray(alphas, np.float32),
                       np.asarray(dc, np.float32).reshape(-1, 4))


def box3d_iou(box1: np.ndarray, box2: np.ndarray, mode: str = "3d") -> float:
    """IoU of two (x, y, z, h, w, l, r) lidar boxes (scalar convenience)."""
    return float(box3d_iou_matrix_np(
        np.asarray(box1).reshape(1, 7),
        np.asarray(box2).reshape(1, 7), mode)[0, 0])


def _frame_matches(pred_boxes, pred_scores, gt_boxes, iou_thresh, mode,
                   det_small=None, care=None, ious=None):
    """Greedy score-ordered matching against the full (P, G) IoU matrix.

    Devkit assignment order (cpp/evaluate_object.cpp):
      * detections flagged `det_small` (below the difficulty's min 2D
        height) match *after* all regular detections, so they cannot
        steal a GT from a real detection;
      * care (valid) GTs take priority over don't-care GTs — an ignored
        neighbor-class / harder-bucket GT only absorbs a detection that
        matches NO available care GT above threshold, even at lower IoU.
    Pass a precomputed `ious` (P, G) matrix to skip recomputation.
    Returns (tp_flags, matched_gt_idx).
    """
    P, G = len(pred_boxes), len(gt_boxes)
    tp = np.zeros(P, bool)
    gt_idx = np.full(P, -1, np.int32)
    if P == 0 or G == 0:
        return tp, gt_idx
    if ious is None:
        ious = box3d_iou_matrix_np(pred_boxes, gt_boxes, mode)  # (P, G)
    if det_small is None:
        det_small = np.zeros(P, bool)
    if care is None:
        care = np.ones(G, bool)
    # regular detections first (by descending score), then small ones
    order = np.lexsort((-np.asarray(pred_scores), det_small))
    matched = np.zeros(G, bool)
    for pi in order:
        avail = (~matched) & (ious[pi] >= iou_thresh)
        if not avail.any():
            continue
        cand = avail & care
        if not cand.any():
            cand = avail                  # only don't-care GTs remain
        row = np.where(cand, ious[pi], -1.0)
        gi = int(np.argmax(row))
        matched[gi] = True
        tp[pi] = True
        gt_idx[pi] = gi
    return tp, gt_idx


def _in_dontcare_region(boxes2d: np.ndarray, dontcare: np.ndarray,
                        min_overlap: float = 0.5) -> np.ndarray:
    """(P,) bool: detection 2D boxes whose intersection with any DontCare
    region exceeds `min_overlap` of the DETECTION's area (the devkit's
    boxoverlap criterion=1: denominator is the detection box)."""
    x1 = np.maximum(boxes2d[:, None, 0], dontcare[None, :, 0])
    y1 = np.maximum(boxes2d[:, None, 1], dontcare[None, :, 1])
    x2 = np.minimum(boxes2d[:, None, 2], dontcare[None, :, 2])
    y2 = np.minimum(boxes2d[:, None, 3], dontcare[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = np.clip((boxes2d[:, 2] - boxes2d[:, 0])
                   * (boxes2d[:, 3] - boxes2d[:, 1]), 1e-6, None)
    return (inter / area[:, None] > min_overlap).any(axis=1)


def _interp_ap(recall, precision, num_points: int) -> float:
    """KITTI interpolated AP: max precision at recall >= r, averaged over
    the sample points. 11-point uses r in {0, 0.1, ..., 1.0} (classic
    devkit, the VoxelNet paper's metric); 40-point uses r in
    {1/40, 2/40, ..., 1.0} (modern devkit, skips r=0)."""
    if num_points == 11:
        samples = np.linspace(0, 1, 11)
    elif num_points == 40:
        samples = np.linspace(1.0 / 40, 1.0, 40)
    else:
        raise ValueError(f"num_points must be 11 or 40, got {num_points}")
    ap = 0.0
    for r in samples:
        mask = recall >= r
        ap += (precision[mask].max() if mask.any() else 0.0) / len(samples)
    return float(ap)


def evaluate_ap(frames: list[dict], iou_thresh: float = 0.7,
                mode: str = "3d",
                difficulties=("easy", "moderate", "hard"),
                num_points: int = 11,
                compute_aos: bool = False) -> dict:
    """Compute AP over frames.

    Each frame dict: pred_boxes (P, 7), pred_scores (P,),
    gt (GroundTruth); optional pred_heights (P,) projected 2D box heights
    in px (enables the devkit small-detection rule: detections shorter
    than the difficulty's min height are neither TP nor FP) and
    pred_alphas (P,) observation angles (enables AOS).

    Returns {difficulty: AP}; with compute_aos=True also
    {difficulty + "_aos": AOS} for frames that carry pred_alphas.
    """
    # the (P, G) IoU matrix does not depend on the difficulty bucket —
    # compute it once per frame (3x less work than per-difficulty)
    frame_ious = []
    for fr in frames:
        pb = np.asarray(fr["pred_boxes"]).reshape(-1, 7)
        gb = fr["gt"].boxes_lidar
        frame_ious.append(
            box3d_iou_matrix_np(pb, gb, mode)
            if len(pb) and len(gb) else None)

    results = {}
    for diff in difficulties:
        min_h, max_occ, max_trunc = DIFFICULTY[diff]
        scores_all, tp_all, sim_all, num_gt = [], [], [], 0
        for fr, ious in zip(frames, frame_ious):
            gt: GroundTruth = fr["gt"]
            care = ((gt.bbox_height >= min_h)
                    & (gt.occlusion <= max_occ)
                    & (gt.truncation <= max_trunc)
                    & ~gt.ignored)
            num_gt += int(care.sum())
            pred_boxes = np.asarray(fr["pred_boxes"]).reshape(-1, 7)
            pred_scores = np.asarray(fr["pred_scores"]).reshape(-1)
            if len(pred_boxes) == 0:
                continue
            pred_heights = fr.get("pred_heights")
            det_small = (np.asarray(pred_heights).reshape(-1) < min_h
                         if pred_heights is not None
                         else np.zeros(len(pred_boxes), bool))
            tp, gt_idx = _frame_matches(
                pred_boxes, pred_scores, gt.boxes_lidar, iou_thresh, mode,
                det_small, care, ious)
            # devkit ignore rules — dropped from the PR curve entirely:
            #   * matched to a don't-care GT (neighbor class / harder bucket)
            #   * detection below the min 2D height (matched or not)
            #   * unmatched detection inside a DontCare 2D region
            safe_idx = np.where(gt_idx >= 0, gt_idx, 0)
            matched_care = np.zeros(len(pred_boxes), bool)
            if len(care):
                matched_care = tp & care[safe_idx]
            matched_dont_care = tp & ~matched_care
            in_dontcare = np.zeros(len(pred_boxes), bool)
            pred_boxes2d = fr.get("pred_boxes2d")
            if len(gt.dontcare) and pred_boxes2d is not None:
                # devkit: the DontCare absorption threshold is the same
                # MIN_OVERLAP[metric][class] used for matching, not a
                # fixed 0.5 (cpp/evaluate_object.cpp computeStatistics)
                in_dontcare = (~tp) & _in_dontcare_region(
                    np.asarray(pred_boxes2d, np.float32).reshape(-1, 4),
                    gt.dontcare, min_overlap=iou_thresh)
            ignore = matched_dont_care | det_small | in_dontcare
            # a care GT consumed by a below-min-height detection leaves
            # the denominator: the devkit counts neither TP nor FN there
            num_gt -= int((matched_care & det_small).sum())
            keep = ~ignore
            scores_all.append(pred_scores[keep])
            tp_all.append(matched_care[keep])
            if compute_aos:
                pred_alphas = fr.get("pred_alphas")
                sim = np.zeros(len(pred_boxes))
                if pred_alphas is not None and gt.alpha is not None \
                        and len(gt.alpha):
                    delta = (np.asarray(pred_alphas).reshape(-1)
                             - gt.alpha[safe_idx])
                    sim = np.where(matched_care,
                                   (1.0 + np.cos(delta)) / 2.0, 0.0)
                sim_all.append(sim[keep])
        if num_gt == 0:
            results[diff] = float("nan")
            if compute_aos:
                results[diff + "_aos"] = float("nan")
            continue
        if not scores_all:
            results[diff] = 0.0
            if compute_aos:
                results[diff + "_aos"] = 0.0
            continue
        scores = np.concatenate(scores_all)
        tps = np.concatenate(tp_all)
        order = np.argsort(-scores)
        tps = tps[order]
        cum_tp = np.cumsum(tps)
        recall = cum_tp / num_gt
        ranks = np.arange(len(tps)) + 1
        precision = cum_tp / ranks
        results[diff] = _interp_ap(recall, precision, num_points)
        if compute_aos:
            sims = np.concatenate(sim_all)[order]
            # orientation "precision": cumulative similarity over rank
            o_prec = np.cumsum(sims) / ranks
            results[diff + "_aos"] = _interp_ap(recall, o_prec, num_points)
    return results
