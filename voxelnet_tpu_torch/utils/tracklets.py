"""KITTI *raw* dataset tracklet XML parser: the port's copy of
`voxelnet_tpu/utils/tracklets.py`.

Capability parity with the reference parser (utils/parse_tracklet_xml.py:
1-215): read `tracklet_labels.xml` from a raw drive into Tracklet objects
(object type, size, per-frame pose / truncation / occlusion / amt-state),
plus the per-frame expansion helper used by the visualizers. Implemented
with xml.etree (stdlib) over the boost-serialization layout instead of the
reference's minidom walk.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from xml.etree import ElementTree

import numpy as np

STATE_UNSET, STATE_INTERP, STATE_LABELED = 0, 1, 2
OCC_UNSET, OCC_VISIBLE, OCC_PARTLY, OCC_FULLY = 255, 0, 1, 2
TRUNC_UNSET, TRUNC_IN_IMAGE, TRUNC_TRUNCATED, TRUNC_OUT_IMAGE = 255, 0, 1, 2


@dataclass
class Tracklet:
    """One annotated object track over a frame range."""

    object_type: str = ""
    size: np.ndarray = field(
        default_factory=lambda: np.zeros(3))      # (h, w, l)
    first_frame: int = 0
    trans: np.ndarray = None      # (n, 3) x, y, z
    rots: np.ndarray = None       # (n, 3) rx, ry, rz
    states: np.ndarray = None     # (n,)
    occs: np.ndarray = None       # (n, 2) occlusion, occlusion_kf
    truncs: np.ndarray = None     # (n,)
    amt_occs: np.ndarray = None   # (n, 2) or None
    amt_borders: np.ndarray = None  # (n, 3) or None
    num_frames: int = 0

    def __len__(self):
        return self.num_frames

    def __iter__(self):
        """Yield (trans, rot, state, occ, trunc, amt_occ, amt_border,
        absolute_frame) per annotated frame — same tuple surface as the
        reference's iterator (utils/parse_tracklet_xml.py:103-139)."""
        for i in range(self.num_frames):
            yield (
                self.trans[i], self.rots[i], self.states[i], self.occs[i],
                self.truncs[i],
                None if self.amt_occs is None else self.amt_occs[i],
                None if self.amt_borders is None else self.amt_borders[i],
                self.first_frame + i,
            )


def _float_or(elem, name, default=np.nan):
    child = elem.find(name)
    return float(child.text) if child is not None else default


def parse_xml(path: str) -> list[Tracklet]:
    """Parse tracklet_labels.xml -> list of Tracklet."""
    root = ElementTree.parse(path).getroot()
    tracklets_elem = root.find("tracklets")
    if tracklets_elem is None:
        raise ValueError(f"{path}: no <tracklets> element")

    out = []
    for item in tracklets_elem.findall("item"):
        t = Tracklet()
        t.object_type = item.findtext("objectType", "")
        t.size = np.array([_float_or(item, "h"), _float_or(item, "w"),
                           _float_or(item, "l")])
        t.first_frame = int(item.findtext("first_frame", "0"))

        poses = item.find("poses")
        pose_items = [] if poses is None else poses.findall("item")
        n = len(pose_items)
        t.num_frames = n
        t.trans = np.full((n, 3), np.nan)
        t.rots = np.full((n, 3), np.nan)
        t.states = np.full((n,), STATE_UNSET, dtype=np.uint8)
        t.occs = np.full((n, 2), OCC_UNSET, dtype=np.uint8)
        t.truncs = np.full((n,), TRUNC_UNSET, dtype=np.uint8)
        has_amt = False
        amt_occs = np.full((n, 2), np.nan)
        amt_borders = np.full((n, 3), np.nan)

        for i, pose in enumerate(pose_items):
            t.trans[i] = [_float_or(pose, "tx"), _float_or(pose, "ty"),
                          _float_or(pose, "tz")]
            t.rots[i] = [_float_or(pose, "rx"), _float_or(pose, "ry"),
                         _float_or(pose, "rz")]
            t.states[i] = int(_float_or(pose, "state", STATE_UNSET))
            t.occs[i] = [int(_float_or(pose, "occlusion", OCC_UNSET)),
                         int(_float_or(pose, "occlusion_kf", OCC_UNSET))]
            t.truncs[i] = int(_float_or(pose, "truncation", TRUNC_UNSET))
            if pose.find("amt_occlusion") is not None:
                has_amt = True
                amt_occs[i] = [_float_or(pose, "amt_occlusion"),
                               _float_or(pose, "amt_occlusion_kf")]
                amt_borders[i] = [_float_or(pose, "amt_border_l"),
                                  _float_or(pose, "amt_border_r"),
                                  _float_or(pose, "amt_border_kf")]
        if has_amt:
            t.amt_occs = amt_occs
            t.amt_borders = amt_borders
        out.append(t)
    return out


def tracklets_per_frame(tracklets: list[Tracklet], num_frames: int):
    """Expand tracklets into per-frame corner boxes (raw-drive viz).

    Returns (frame -> list of (8, 3) corner arrays,
             frame -> list of object types), like the reference's
    `load_tracklets_for_frames` (utils/visualize.py).
    """
    frame_boxes = {f: [] for f in range(num_frames)}
    frame_types = {f: [] for f in range(num_frames)}
    for t in tracklets:
        h, w, l = t.size
        template = np.array([
            [-l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2],
            [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2],
            [0, 0, 0, 0, h, h, h, h],
        ])
        for trans, rot, state, occ, trunc, _a, _b, frame in t:
            if frame >= num_frames:
                continue
            yaw = rot[2]
            rot_mat = np.array([
                [np.cos(yaw), -np.sin(yaw), 0.0],
                [np.sin(yaw), np.cos(yaw), 0.0],
                [0.0, 0.0, 1.0],
            ])
            corners = (rot_mat @ template).T + trans
            frame_boxes[frame].append(corners)
            frame_types[frame].append(t.object_type)
    return frame_boxes, frame_types
