"""KITTI label and calibration file I/O (host side, NumPy): the port's
copy of `voxelnet_tpu/utils/kitti.py`. Box-count outputs are explicit so
the pipeline can pad to static shapes.
"""

from __future__ import annotations

import numpy as np

from voxelnet_tpu_torch.utils import geometry

# classes accepted as ground truth per detection class
# (reference: voxelnet/utils.py:185-192 — Car accepts Van too)
ACCEPTED_CLASSES = {
    "Car": ("Car", "Van"),
    "Pedestrian": ("Pedestrian",),
    "Cyclist": ("Cyclist",),
}


def parse_label_lines(lines, cls_name: str = "Car",
                      coordinate: str = "camera",
                      T_VELO_2_CAM=None, R_RECT_0=None) -> np.ndarray:
    """Parse KITTI `label_2` text lines into (N, 7) boxes.

    Box layout is (x, y, z, h, w, l, r) in the requested coordinate frame.
    KITTI label fields order the last 7 numeric entries (h, w, l, x, y, z, ry)
    in camera coordinates; the reorder matches voxelnet/utils.py:199-200.
    An empty `cls_name` accepts every class (used by augmentation).
    """
    if cls_name and cls_name not in ACCEPTED_CLASSES:
        # an unknown name must not silently behave like the
        # accept-everything wildcard reserved for cls_name=""
        raise ValueError(
            f"unknown class {cls_name!r}; expected one of "
            f"{sorted(ACCEPTED_CLASSES)} or '' for all classes")
    acc = ACCEPTED_CLASSES.get(cls_name, ())
    boxes = []
    for line in lines:
        anno = line.split()
        if not anno:
            continue
        if acc == () or anno[0] in acc:
            # positional fields 8-14 are (h, w, l, x, y, z, ry) — unlike the
            # reference's anno[-7:] (voxelnet/utils.py:199) this also parses
            # 16-field prediction lines that carry a trailing score.
            h, w, l, x, y, z, r = (float(v) for v in anno[8:15])
            boxes.append((x, y, z, h, w, l, r))
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
    if coordinate == "lidar" and len(boxes):
        boxes = geometry.camera_to_lidar_boxes(
            boxes, T_VELO_2_CAM, R_RECT_0).astype(np.float32)
    return boxes


def parse_label_classes(lines) -> list[str]:
    """Class name of each label line (all classes, no filtering)."""
    return [line.split()[0] for line in lines if line.split()]


def labels_to_gt_box3d(batch_lines, cls_name: str = "Car",
                       coordinate: str = "lidar",
                       T_VELO_2_CAM=None, R_RECT_0=None) -> list[np.ndarray]:
    """Batch version: list of label-line lists -> list of (Ni, 7) arrays.

    Equivalent to voxelnet/utils.py:176-209 (`label_to_gt_box_3d`).
    """
    return [
        parse_label_lines(lines, cls_name, coordinate,
                          T_VELO_2_CAM, R_RECT_0)
        for lines in batch_lines
    ]


def pad_gt_boxes(boxes: np.ndarray, max_boxes: int):
    """Pad (N, 7) -> ((max_boxes, 7), (max_boxes,) validity mask).

    Static-shape bucketing for on-device target assignment — boxes beyond
    `max_boxes` are dropped (rare: KITTI frames have <=30 objects).
    """
    out = np.zeros((max_boxes, 7), np.float32)
    mask = np.zeros((max_boxes,), np.bool_)
    n = min(len(boxes), max_boxes)
    out[:n] = boxes[:n]
    mask[:n] = True
    return out, mask


def boxes_to_label_lines(boxes3d, classes, scores=None, coordinate="lidar",
                         P2=None, T_VELO_2_CAM=None, R_RECT_0=None) -> list[str]:
    """Emit one frame's (N, 7) boxes as KITTI label-format lines.

    Matches the 15/16-field format of voxelnet/utils.py:817-866
    (`box3d_to_label`) for a single frame: class, 3 zeros (trunc/occ/alpha),
    2D box from projection, then (h, w, l, x, y, z, r) in camera coords and
    optionally the score.
    """
    boxes3d = np.asarray(boxes3d, np.float32).reshape(-1, 7)
    lines = []
    if len(boxes3d) == 0:
        return lines

    if coordinate == "camera":
        cam_boxes = boxes3d
        lidar_boxes = geometry.camera_to_lidar_boxes(
            boxes3d, T_VELO_2_CAM, R_RECT_0)
    else:
        lidar_boxes = boxes3d
        cam_boxes = geometry.lidar_to_camera_boxes(
            boxes3d, T_VELO_2_CAM, R_RECT_0)

    boxes2d = geometry.lidar_box3d_to_camera_box(
        lidar_boxes, cal_projection=False, P2=P2,
        T_VELO_2_CAM=T_VELO_2_CAM, R_RECT_0=R_RECT_0)

    for i in range(len(boxes3d)):
        x, y, z, h, w, l, r = cam_boxes[i]
        # observation angle (KITTI alpha, [-pi, pi]); the reference emits a
        # hardcoded 0 here (voxelnet/utils.py:844) which would make AOS
        # meaningless — real alpha is required for the evaluator's
        # orientation similarity
        alpha = float((r - np.arctan2(x, z) + np.pi) % (2 * np.pi) - np.pi)
        fields = [0.0, 0.0, alpha, *boxes2d[i], h, w, l, x, y, z, r]
        if scores is not None:
            fields.append(float(scores[i]))
        body = " ".join(f"{float(v):.4f}" for v in fields)
        lines.append(f"{classes[i]} {body}\n")
    return lines


def load_calib(calib_path: str):
    """Load a KITTI calib txt -> (P2 (4,4), Tr_velo_to_cam (4,4), R_rect (4,4)).

    Same row conventions as voxelnet/utils.py:556-573.
    """
    with open(calib_path) as f:
        lines = [line.split()[1:] for line in f.readlines()][:-1]

    P = np.array(lines[2], np.float32).reshape(3, 4)
    P = np.concatenate([P, np.zeros((1, 4), np.float32)], axis=0)

    Tr = np.array(lines[5], np.float32).reshape(3, 4)
    Tr = np.concatenate(
        [Tr, np.array([[0, 0, 0, 1]], np.float32)], axis=0)

    R = np.eye(4, dtype=np.float32)
    R[:3, :3] = np.array(lines[4][:9], np.float32).reshape(3, 3)
    return P, Tr, R


def read_point_cloud(path: str) -> np.ndarray:
    """Read a KITTI velodyne .bin -> (N, 4) float32 (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
