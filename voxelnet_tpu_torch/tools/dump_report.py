"""What a directory of label dumps says about the misses: the recall
behind an AP, split by the ground truth's yaw.

    python -m voxelnet_tpu_torch.tools.dump_report DUMP [DUMP ...]
        [--class-name Car] [--iou 0.5]

DUMP is a `tools/synthetic_smoke.py --dump-labels` directory (preds/data/
and gt/ of KITTI label files, read as `cli.eval` reads them). For the
moderate ground truth it prints the recall at BEV IoU `--iou`, the best
BEV IoU of each miss, the yaw error of the detection nearest to each
miss, the recall and mean yaw error in bands of ground-truth yaw, and the
false positives (detections matching no GT at `--iou`) with score >= 0.9.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from voxelnet_tpu_torch.cli.eval import load_frames_from_dirs
from voxelnet_tpu_torch.ops.iou_np import box3d_iou_matrix_np
from voxelnet_tpu_torch.training.evaluate import DIFFICULTY

YAW_BANDS = np.round(np.arange(-1.5, 1.51, 0.3), 1)


def report(dump: str, class_name: str = "Car", iou: float = 0.5) -> dict:
    """-> {'gt', 'moderate', 'recall', 'miss_iou', 'miss_dyaw_deg',
    'bands': [(lo, hi, n, recall, mean dyaw deg)], 'fp', 'fp_high'}."""
    frames = load_frames_from_dirs(os.path.join(dump, "preds", "data"),
                                   os.path.join(dump, "gt"), class_name)
    min_h, max_occ, max_trunc = DIFFICULTY["moderate"]
    rows, fp, fp_high = [], 0, 0
    for fr in frames:
        gt, pb, ps = fr["gt"], fr["pred_boxes"], fr["pred_scores"]
        gb = gt.boxes_lidar
        ious = (box3d_iou_matrix_np(pb, gb, "bev") if len(pb) and len(gb)
                else np.zeros((len(pb), len(gb))))
        care = ((gt.bbox_height >= min_h) & (gt.occlusion <= max_occ)
                & (gt.truncation <= max_trunc))
        for g in np.flatnonzero(care):
            j = int(ious[:, g].argmax()) if len(pb) else -1
            best = float(ious[j, g]) if j >= 0 else 0.0
            dyaw = float(pb[j, 6] - gb[g, 6]) if j >= 0 else np.nan
            rows.append((gb[g, 6], best, np.degrees(dyaw)))
        unmatched = (ious.max(axis=1) < iou if ious.shape[1]
                     else np.ones(len(pb), bool))
        fp += int(unmatched.sum())
        fp_high += int((unmatched & (ps >= 0.9)).sum())
    r = np.asarray(rows, np.float64).reshape(-1, 3)
    hit = r[:, 1] >= iou
    bands = []
    for lo, hi in zip(YAW_BANDS[:-1], YAW_BANDS[1:]):
        m = (r[:, 0] >= lo) & (r[:, 0] < hi)
        if m.any():
            bands.append((float(lo), float(hi), int(m.sum()),
                          float(hit[m].mean()), float(np.nanmean(r[m, 2]))))
    return {"gt": sum(len(f["gt"].boxes_lidar) for f in frames),
            "moderate": len(r), "recall": float(hit.mean()) if len(r)
            else float("nan"), "miss_iou": np.sort(r[~hit, 1]).tolist(),
            "miss_dyaw_deg": r[~hit, 2].tolist(), "bands": bands,
            "fp": fp, "fp_high": fp_high}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dumps", nargs="+")
    p.add_argument("--class-name", default="Car")
    p.add_argument("--iou", type=float, default=0.5)
    args = p.parse_args(argv)
    out = []
    for dump in args.dumps:
        r = report(dump, args.class_name, args.iou)
        out.append(r)
        miss = r["miss_iou"]
        print(f"{dump}: {r['moderate']} moderate GT of {r['gt']}, recall "
              f"{r['recall']:.3f} at BEV IoU {args.iou}; {len(miss)} misses"
              + (f", best IoU {min(miss):.2f}-{max(miss):.2f}, yaw error "
                 f"{min(r['miss_dyaw_deg']):.0f} to "
                 f"{max(r['miss_dyaw_deg']):.0f} deg" if miss else "")
              + f"; {r['fp']} false positives, {r['fp_high']} at score "
              f">= 0.9")
        for lo, hi, n, rec, dyaw in r["bands"]:
            print(f"  GT yaw [{lo:+.1f}, {hi:+.1f}): {n:3d} GT, recall "
                  f"{rec:.2f}, mean yaw error {dyaw:+.1f} deg")
    return out


if __name__ == "__main__":
    main()
