"""Box-level comparison of two directories of KITTI prediction dumps: the
port's copy of `scripts/ab_compare_dumps.py`, with its flags, its output
and its arithmetic.

An AP comparison of two inference stacks loses its power where AP is near
zero (untrained or random weights). This compares the dumps of the same
weights through two stacks directly: per frame, boxes are matched
greedily by BEV IoU, and the tool reports the match rate, the mean
matched IoU and how far the matched scores agree, a measure of stack
parity independent of how good the weights are.

    python -m voxelnet_tpu_torch.tools.ab_compare_dumps --a torch_preds/ \\
        --b jax_preds/ --calib-dir .../validation/calib [--iou 0.7]

Prints one JSON line: frames, boxes_a, boxes_b, matched, match_rate,
mean_matched_bev_iou, mean_abs_score_diff, p95_abs_score_diff (the last
three null when nothing matched). A frame is a file name present in both
directories; its calibration is the file of the same name in
--calib-dir. `write_dumps` and `write_calib_dir` write such directories
from (B, P, 7) lidar boxes and their scores.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from voxelnet_tpu_torch.config import CalibConfig
from voxelnet_tpu_torch.data.raw_to_kitti import detection_calib_text
from voxelnet_tpu_torch.ops.iou_np import box3d_iou_matrix_np
from voxelnet_tpu_torch.utils import kitti


def load_dump(path: str, calib: str) -> tuple[np.ndarray, np.ndarray]:
    """A dump file -> ((N, 7) lidar boxes, (N,) f32 scores); a line
    without a 16th field scores 1.0."""
    _, Tr, R = kitti.load_calib(calib)
    with open(path) as f:
        lines = f.readlines()
    boxes = kitti.parse_label_lines(lines, "", "lidar", Tr, R)
    scores = []
    for ln in lines:
        parts = ln.split()
        scores.append(float(parts[15]) if len(parts) > 15 else 1.0)
    return boxes.reshape(-1, 7), np.asarray(scores, np.float32)


def compare(a: str, b: str, calib_dir: str, iou: float = 0.7) -> dict:
    """Match each frame's boxes of dump dir `a` greedily, in descending
    score, to the unused box of `b` of highest BEV IoU, kept when that IoU
    is at least `iou` -> the JSON line's dict (rounded to 4 places)."""
    tags = sorted(set(os.listdir(a)) & set(os.listdir(b)))
    n_a = n_b = n_match = 0
    ious, score_diffs = [], []
    for tag in tags:
        calib = os.path.join(calib_dir, tag)
        ba, sa = load_dump(os.path.join(a, tag), calib)
        bb, sb = load_dump(os.path.join(b, tag), calib)
        n_a += len(ba)
        n_b += len(bb)
        if not len(ba) or not len(bb):
            continue
        m = box3d_iou_matrix_np(ba, bb, mode="bev")
        used = np.zeros(len(bb), bool)
        for i in np.argsort(-sa):
            j = int(np.argmax(np.where(used, -1.0, m[i])))
            if m[i, j] >= iou and not used[j]:
                used[j] = True
                n_match += 1
                ious.append(float(m[i, j]))
                score_diffs.append(float(abs(sa[i] - sb[j])))
    return {
        "frames": len(tags),
        "boxes_a": n_a,
        "boxes_b": n_b,
        "matched": n_match,
        "match_rate": round(n_match / max(min(n_a, n_b), 1), 4),
        "mean_matched_bev_iou": round(float(np.mean(ious)), 4) if ious
        else None,
        "mean_abs_score_diff": round(float(np.mean(score_diffs)), 4)
        if score_diffs else None,
        "p95_abs_score_diff": round(float(np.percentile(score_diffs, 95)),
                                    4) if score_diffs else None,
    }


def frame_tag(i: int) -> str:
    return f"{i:06d}.txt"


def write_dumps(out_dir: str, boxes, scores, valid,
                class_name: str = "Car") -> list[str]:
    """One label file a frame (`frame_tag(b)`) of the valid (B, P, 7)
    lidar boxes with their scores, in the default calibration -> the
    tags."""
    os.makedirs(out_dir, exist_ok=True)
    boxes, scores = np.asarray(boxes), np.asarray(scores)
    valid = np.asarray(valid, bool)
    tags = []
    for b in range(len(boxes)):
        pb, ps = boxes[b][valid[b]], scores[b][valid[b]]
        tags.append(frame_tag(b))
        with open(os.path.join(out_dir, tags[-1]), "w") as f:
            f.writelines(kitti.boxes_to_label_lines(
                pb, [class_name] * len(pb), scores=ps, coordinate="lidar"))
    return tags


def write_calib_dir(calib_dir: str, tags) -> None:
    """The default calibration (the one `write_dumps` writes in) as a
    KITTI calib file for each tag."""
    cal = CalibConfig()
    text = detection_calib_text(cal.MATRIX_P2()[:3], cal.R_RECT_0()[:3, :3],
                                cal.T_VELO_2_CAM()[:3])
    os.makedirs(calib_dir, exist_ok=True)
    for tag in tags:
        with open(os.path.join(calib_dir, tag), "w") as f:
            f.write(text)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="dump dir A (e.g. torch)")
    ap.add_argument("--b", required=True, help="dump dir B (e.g. jax)")
    ap.add_argument("--calib-dir", required=True)
    ap.add_argument("--iou", type=float, default=0.7,
                    help="BEV IoU threshold for a match")
    args = ap.parse_args(argv)
    print(json.dumps(compare(args.a, args.b, args.calib_dir, args.iou)))


if __name__ == "__main__":
    main()
