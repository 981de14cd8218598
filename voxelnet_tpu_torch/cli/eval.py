"""Evaluation CLI of the port, as `voxelnet_tpu/cli/eval.py` (the same
flags and JSON): KITTI 3D / BEV AP (11 or 40 points, easy/moderate/hard,
optional AOS) of a directory of prediction label files against a
ground-truth label directory. Host-only (numpy).

    python -m voxelnet_tpu_torch.cli.eval --preds exps/.../preds/10/data \
        --gt /data/kitti/MD_KITTI/validation/label_2
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from voxelnet_tpu_torch.training.evaluate import (evaluate_ap,
                                                  parse_gt_for_eval)
from voxelnet_tpu_torch.utils import kitti


def frame_from_lines(pred_lines: list[str], gt_lines: list[str],
                     cls_name: str, T=None, R=None, where: str = "") -> dict:
    """One frame of prediction and ground-truth label lines -> the frame
    dict of training/evaluate.evaluate_ap, as this CLI scores it."""
    # split + filter prediction lines ONCE so all columns stay paired
    fields = [ln.split() for ln in pred_lines]
    keep = [(ln, fs) for ln, fs in zip(pred_lines, fields)
            if fs and fs[0] == cls_name]
    for _, fs in keep:
        if len(fs) != 16:
            raise ValueError(
                f"{where}: prediction line has {len(fs)} fields — "
                "expected 16 (15 KITTI fields + trailing score); a "
                "15-field file would silently rank detections by "
                "rotation_y")
    pred_lines = [ln for ln, _ in keep]
    fields = [fs for _, fs in keep]
    # cls_name="" accepts every (pre-filtered) line, preserving order
    pred_boxes = kitti.parse_label_lines(pred_lines, "", "lidar", T, R)
    scores = np.array([float(fs[-1]) for fs in fields], np.float32)
    # 2D boxes (devkit small-detection + DontCare rules) + alphas
    # (AOS) from the emitted lines; heights of 0 mean the dump had no
    # calib to project with -> rules unavailable for this frame
    boxes2d = np.array([[float(v) for v in fs[4:8]] for fs in fields],
                       np.float32).reshape(-1, 4)
    heights = boxes2d[:, 3] - boxes2d[:, 1]
    alphas = np.array([float(fs[3]) for fs in fields], np.float32)
    frame = {
        "pred_boxes": pred_boxes,
        "pred_scores": scores,
        "pred_alphas": alphas,
        "gt": parse_gt_for_eval(gt_lines, cls_name, T, R),
    }
    if len(heights) == 0 or (heights > 0).any():
        frame["pred_heights"] = heights
        frame["pred_boxes2d"] = boxes2d
    return frame


def load_frames_from_dirs(preds_dir: str, gt_dir: str, cls_name: str,
                          calib_dir: str | None = None) -> list[dict]:
    frames = []
    for fname in sorted(os.listdir(preds_dir)):
        if not fname.endswith(".txt"):
            continue
        gt_path = os.path.join(gt_dir, fname)
        if not os.path.exists(gt_path):
            continue
        T = R = None
        if calib_dir:
            calib_path = os.path.join(calib_dir, fname)
            if os.path.exists(calib_path):
                _, T, R = kitti.load_calib(calib_path)
        with open(os.path.join(preds_dir, fname)) as f:
            pred_lines = f.readlines()
        with open(gt_path) as f:
            gt_lines = f.readlines()
        frames.append(frame_from_lines(pred_lines, gt_lines, cls_name, T, R,
                                       fname))
    return frames


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preds", type=str, required=True,
                   help="directory of predicted KITTI label files")
    p.add_argument("--gt", type=str, required=True,
                   help="directory of ground-truth label files")
    p.add_argument("--calib-dir", type=str, default=None)
    p.add_argument("--class-name", type=str, default="Car")
    p.add_argument("--iou", type=float, default=0.7)
    p.add_argument("--mode", type=str, default="3d", choices=("3d", "bev"))
    p.add_argument("--ap-points", type=int, default=11, choices=(11, 40),
                   help="11 = classic devkit / VoxelNet paper; 40 = modern")
    p.add_argument("--aos", action="store_true",
                   help="also report average orientation similarity")
    args = p.parse_args(argv)

    frames = load_frames_from_dirs(args.preds, args.gt, args.class_name,
                                   args.calib_dir)
    if not frames:
        raise SystemExit("no matching prediction/GT frames found")
    ap = evaluate_ap(frames, iou_thresh=args.iou, mode=args.mode,
                     num_points=args.ap_points, compute_aos=args.aos)
    print(json.dumps({
        "class": args.class_name, "iou": args.iou, "mode": args.mode,
        "frames": len(frames),
        # NaN (no ground truth in a difficulty bucket) -> null: keep the
        # output strictly valid JSON
        **{f"AP_{k}": (None if v != v else v) for k, v in ap.items()},
    }, indent=2))


if __name__ == "__main__":
    main()
