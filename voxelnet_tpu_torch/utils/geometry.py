"""Vectorized box / coordinate geometry (host side, NumPy): the port's
copy of `voxelnet_tpu/utils/geometry.py`, with the same arithmetic.

Box conventions (same as the reference / KITTI):
  * camera box:  (x, y, z, h, w, l, ry) — y is the box *bottom*.
  * lidar box:   (x, y, z, h, w, l, rz) — z is the box *bottom*.
  * 3D corners:  (N, 8, 3), bottom face first (indices 0-3), top face 4-7.
  * BEV 2D box:  (x, y, w, l, r) in lidar coordinates.
  * standup box: axis-aligned (x1, y1, x2, y2).
"""

from __future__ import annotations

import numpy as np

from voxelnet_tpu_torch.config import CalibConfig

_DEFAULT_CALIB = CalibConfig()


def _calib_mats(T_VELO_2_CAM=None, R_RECT_0=None):
    if T_VELO_2_CAM is None:
        T_VELO_2_CAM = _DEFAULT_CALIB.T_VELO_2_CAM()
    if R_RECT_0 is None:
        R_RECT_0 = _DEFAULT_CALIB.R_RECT_0()
    return np.asarray(T_VELO_2_CAM, np.float64), np.asarray(R_RECT_0, np.float64)


def angle_in_limit(angle):
    """Wrap angles into [-pi/2, pi/2), snapping near -pi/2 up to +pi/2.

    Vectorized analog of the reference's while-loop version
    (voxelnet/utils.py:133-143).
    """
    angle = np.asarray(angle, dtype=np.float64)
    wrapped = np.mod(angle + np.pi / 2, np.pi) - np.pi / 2
    snap = np.abs(wrapped + np.pi / 2) < (5.0 / 180.0 * np.pi)
    return np.where(snap, np.pi / 2, wrapped)


# ---------------------------------------------------------------------------
# point transforms
# ---------------------------------------------------------------------------

def camera_to_lidar_points(points, T_VELO_2_CAM=None, R_RECT_0=None):
    """(N, 3) rectified-camera points -> (N, 3) lidar points."""
    T, R = _calib_mats(T_VELO_2_CAM, R_RECT_0)
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    out = hom @ np.linalg.inv(R).T @ np.linalg.inv(T).T
    return out[:, :3]


def lidar_to_camera_points(points, T_VELO_2_CAM=None, R_RECT_0=None):
    """(N, 3) lidar points -> (N, 3) rectified-camera points."""
    T, R = _calib_mats(T_VELO_2_CAM, R_RECT_0)
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    out = hom @ T.T @ R.T
    return out[:, :3]


# ---------------------------------------------------------------------------
# box transforms
# ---------------------------------------------------------------------------

def camera_to_lidar_boxes(boxes, T_VELO_2_CAM=None, R_RECT_0=None):
    """(N, 7) camera boxes -> (N, 7) lidar boxes.

    rz = wrap(-ry - pi/2), matching voxelnet/utils.py:162-172.
    """
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    xyz = camera_to_lidar_points(boxes[:, :3], T_VELO_2_CAM, R_RECT_0)
    rz = angle_in_limit(-boxes[:, 6] - np.pi / 2)
    return np.concatenate([xyz, boxes[:, 3:6], rz[:, None]], axis=1)


def lidar_to_camera_boxes(boxes, T_VELO_2_CAM=None, R_RECT_0=None):
    """(N, 7) lidar boxes -> (N, 7) camera boxes (voxelnet/utils.py:869-879)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    xyz = lidar_to_camera_points(boxes[:, :3], T_VELO_2_CAM, R_RECT_0)
    ry = angle_in_limit(-boxes[:, 6] - np.pi / 2)
    return np.concatenate([xyz, boxes[:, 3:6], ry[:, None]], axis=1)


# ---------------------------------------------------------------------------
# center <-> corner
# ---------------------------------------------------------------------------

# Unit corner template: columns are x (length axis), y (width axis),
# z (height axis, 0 at bottom). Bottom face corners 0-3, top face 4-7;
# matches the winding of voxelnet/utils.py:316-319.
_CORNER_SIGNS_X = np.array([-1, -1, 1, 1, -1, -1, 1, 1], np.float64) * 0.5
_CORNER_SIGNS_Y = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64) * 0.5
_CORNER_Z = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float64)


def center_to_corner_box3d(boxes, coordinate="lidar",
                           T_VELO_2_CAM=None, R_RECT_0=None):
    """(N, 7) center boxes -> (N, 8, 3) corners, fully vectorized.

    Equivalent semantics to voxelnet/utils.py:576-616 (and its duplicate at
    294-341): compute corners in lidar space, then convert per-corner when
    `coordinate == 'camera'`.
    """
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    if coordinate == "camera":
        boxes = camera_to_lidar_boxes(boxes, T_VELO_2_CAM, R_RECT_0)

    n = len(boxes)
    h, w, l, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 5], boxes[:, 6]
    # (N, 8) local corner offsets
    local_x = l[:, None] * _CORNER_SIGNS_X[None, :]
    local_y = w[:, None] * _CORNER_SIGNS_Y[None, :]
    local_z = h[:, None] * _CORNER_Z[None, :]
    cos, sin = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    gx = cos * local_x - sin * local_y + boxes[:, 0:1]
    gy = sin * local_x + cos * local_y + boxes[:, 1:2]
    gz = local_z + boxes[:, 2:3]
    corners = np.stack([gx, gy, gz], axis=-1)  # (N, 8, 3)

    if coordinate == "camera":
        flat = lidar_to_camera_points(
            corners.reshape(-1, 3), T_VELO_2_CAM, R_RECT_0)
        corners = flat.reshape(n, 8, 3)
    return corners.astype(np.float32)


def corner_to_center_box3d(corners, coordinate="camera",
                           T_VELO_2_CAM=None, R_RECT_0=None):
    """(N, 8, 3) corners -> (N, 7) center boxes (averaging estimator).

    Vectorized analog of the reference's per-ROI loop
    (voxelnet/dataset.py:305-384, 'average version'). Input corners in the
    given coordinate; estimation runs in camera coords like the reference.
    """
    corners = np.asarray(corners, np.float64).reshape(-1, 8, 3)
    if coordinate == "lidar":
        corners = lidar_to_camera_points(
            corners.reshape(-1, 3), T_VELO_2_CAM, R_RECT_0).reshape(-1, 8, 3)

    # camera coords: x right, y down (height axis), z forward.
    h = np.abs((corners[:, :4, 1] - corners[:, 4:, 1]).sum(axis=1) / 4)

    def _xz_dist(i, j):
        d = corners[:, i, [0, 2]] - corners[:, j, [0, 2]]
        return np.sqrt((d ** 2).sum(axis=1))

    w = (_xz_dist(0, 3) + _xz_dist(1, 2) + _xz_dist(4, 7) + _xz_dist(5, 6)) / 4
    l = (_xz_dist(0, 1) + _xz_dist(2, 3) + _xz_dist(4, 5) + _xz_dist(6, 7)) / 4
    x = corners[:, :, 0].mean(axis=1)
    y = corners[:, :4, 1].mean(axis=1)   # bottom face
    z = corners[:, :, 2].mean(axis=1)

    ry = (
        np.arctan2(corners[:, 2, 0] - corners[:, 1, 0],
                   corners[:, 2, 2] - corners[:, 1, 2])
        + np.arctan2(corners[:, 6, 0] - corners[:, 5, 0],
                     corners[:, 6, 2] - corners[:, 5, 2])
        + np.arctan2(corners[:, 3, 0] - corners[:, 0, 0],
                     corners[:, 3, 2] - corners[:, 0, 2])
        + np.arctan2(corners[:, 7, 0] - corners[:, 4, 0],
                     corners[:, 7, 2] - corners[:, 4, 2])
        + np.arctan2(corners[:, 0, 2] - corners[:, 1, 2],
                     corners[:, 1, 0] - corners[:, 0, 0])
        + np.arctan2(corners[:, 4, 2] - corners[:, 5, 2],
                     corners[:, 5, 0] - corners[:, 4, 0])
        + np.arctan2(corners[:, 3, 2] - corners[:, 2, 2],
                     corners[:, 2, 0] - corners[:, 3, 0])
        + np.arctan2(corners[:, 7, 2] - corners[:, 6, 2],
                     corners[:, 6, 0] - corners[:, 7, 0])
    ) / 8

    swap = w > l
    w_, l_ = np.where(swap, l, w), np.where(swap, w, l)
    ry = np.where(swap, angle_in_limit(ry + np.pi / 2), ry)

    out = np.stack([x, y, z, h, w_, l_, ry], axis=1)
    if coordinate == "lidar":
        out = camera_to_lidar_boxes(out, T_VELO_2_CAM, R_RECT_0)
    return out.astype(np.float32)


def center_to_corner_box2d(boxes, coordinate="lidar",
                           T_VELO_2_CAM=None, R_RECT_0=None):
    """(N, 5) BEV boxes (x, y, w, l, r) -> (N, 4, 2) bottom-face corners.

    Equivalent to voxelnet/utils.py:242-256.
    """
    boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
    boxes3d = np.zeros((len(boxes), 7))
    boxes3d[:, [0, 1, 4, 5, 6]] = boxes
    corners = center_to_corner_box3d(boxes3d, coordinate,
                                     T_VELO_2_CAM, R_RECT_0)
    return corners[:, 0:4, 0:2]


def corner_to_standup_box2d(corners):
    """(N, C, 2) corners -> (N, 4) axis-aligned (x1, y1, x2, y2).

    Equivalent to voxelnet/utils.py:230-239.
    """
    corners = np.asarray(corners, np.float64)
    return np.stack([
        corners[:, :, 0].min(axis=1),
        corners[:, :, 1].min(axis=1),
        corners[:, :, 0].max(axis=1),
        corners[:, :, 1].max(axis=1),
    ], axis=1).astype(np.float32)


def anchor_to_standup_box2d(anchors_xywl, buggy: bool = False):
    """(A, 4) anchor BEV (x, y, w, l) -> (A, 4) standup (x1, y1, x2, y2).

    Anchors alternate yaw 0 / yaw 90 along the row axis (even rows yaw 0).
    For yaw 0 the x-extent is l and the y-extent is w; for yaw 90, swapped.

    `buggy=True` reproduces the reference defect where x2/y2 repeat x1/y1
    producing zero-area boxes (voxelnet/utils.py:217-225); the default is
    the corrected geometry.
    """
    a = np.asarray(anchors_xywl, np.float64).reshape(-1, 4)
    out = np.zeros_like(a)
    x, y, w, l = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    # half-extents per anchor, alternating with yaw
    ext_x = np.where(np.arange(len(a)) % 2 == 0, l, w) / 2
    ext_y = np.where(np.arange(len(a)) % 2 == 0, w, l) / 2
    out[:, 0] = x - ext_x
    out[:, 1] = y - ext_y
    if buggy:
        out[:, 2] = x - ext_x
        out[:, 3] = y - ext_y
    else:
        out[:, 2] = x + ext_x
        out[:, 3] = y + ext_y
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# projection to image
# ---------------------------------------------------------------------------

def lidar_box3d_to_camera_box(boxes3d, cal_projection=False, P2=None,
                              T_VELO_2_CAM=None, R_RECT_0=None):
    """Project (N, 7) lidar boxes into the cam-2 image plane.

    Returns (N, 8, 2) corner projections when `cal_projection` else (N, 4)
    integer 2D boxes. Vectorized analog of voxelnet/utils.py:620-656.
    """
    boxes3d = np.asarray(boxes3d, np.float64).reshape(-1, 7)
    num = len(boxes3d)
    if P2 is None:
        P2 = _DEFAULT_CALIB.MATRIX_P2()
    P2 = np.asarray(P2, np.float64)

    corners = center_to_corner_box3d(
        boxes3d, "lidar", T_VELO_2_CAM, R_RECT_0).astype(np.float64)
    cam = lidar_to_camera_points(
        corners.reshape(-1, 3), T_VELO_2_CAM, R_RECT_0)
    hom = np.concatenate([cam, np.ones((len(cam), 1))], axis=1)
    pts = (hom @ P2.T)
    pts = np.nan_to_num(pts)
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = pts[:, :2] / pts[:, 2:3]
    uv = np.nan_to_num(uv).reshape(num, 8, 2)

    if cal_projection:
        return uv.astype(np.float32)
    boxes2d = np.zeros((num, 4), np.int32)
    if num:
        boxes2d[:, 0] = uv[:, :, 0].min(axis=1).astype(np.int32)
        boxes2d[:, 1] = uv[:, :, 1].min(axis=1).astype(np.int32)
        boxes2d[:, 2] = uv[:, :, 0].max(axis=1).astype(np.int32)
        boxes2d[:, 3] = uv[:, :, 1].max(axis=1).astype(np.int32)
    return boxes2d


# ---------------------------------------------------------------------------
# rigid transforms for augmentation
# ---------------------------------------------------------------------------

def point_transform(points, tx=0.0, ty=0.0, tz=0.0, rz=0.0, ry=0.0, rx=0.0):
    """Translate then rotate (rx, ry, rz order) a set of (N, 3) points.

    Same composition as voxelnet/dataset.py:264-302.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    pts = pts + np.array([tx, ty, tz])
    # Row-vector matrices copied in *convention* from the reference (its
    # p @ M composition effectively rotates by -theta); matched exactly so
    # augmentation produces identical geometry.
    if rx:
        c, s = np.cos(rx), np.sin(rx)
        m = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        pts = pts @ m
    if ry:
        c, s = np.cos(ry), np.sin(ry)
        m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pts = pts @ m
    if rz:
        c, s = np.cos(rz), np.sin(rz)
        m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pts = pts @ m
    return pts.astype(np.float32)


def box_transform(boxes, tx=0.0, ty=0.0, tz=0.0, rz=0.0, coordinate="lidar"):
    """Apply a rigid transform to (N, 7) center boxes via their corners.

    Analog of voxelnet/dataset.py:254-261.
    """
    corners = center_to_corner_box3d(boxes, coordinate=coordinate)
    moved = point_transform(
        corners.reshape(-1, 3), tx, ty, tz, rz=rz).reshape(-1, 8, 3)
    return corner_to_center_box3d(moved, coordinate=coordinate)
