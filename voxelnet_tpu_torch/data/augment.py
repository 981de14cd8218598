"""Point-cloud augmentation (VoxelNet paper sec. 3.2): the port's copy of
`voxelnet_tpu/data/augment.py`, drawing from the same Generator in the same
order, so an example is bit-equal to the JAX package's.

As the reference's `pcl_augmentation` (voxelnet/dataset.py:122-219), with
the same branch probabilities it either
(a) perturbs each GT box independently with a BEV collision check,
(b) applies a global rotation in [-pi/4, pi/4], or
(c) applies a global scale in [0.95, 1.05].

Differences (documented): collision checking uses exact rotated-rectangle
IoU (geometry, vectorized) instead of the reference's cv2 polygon
rasterization onto an image-sized buffer (dataset.py:222-240), and the RNG
is an explicit np.random.Generator instead of a re-seeded global
(dataset.py:123 — reference reseeds per sample). The
`compat.raster_collision` flag routes the collision check through
`raster_iou_2d`, which reproduces the reference's raster quantization
bit-for-bit (int-truncated grid-pixel corners, image-sized buffer) on the
port's numpy rasterizer (utils/raster.py), so it needs no cv2.
"""

from __future__ import annotations

import numpy as np

from voxelnet_tpu_torch.utils import geometry, raster


def _poly_clip(subject: list, a: np.ndarray, b: np.ndarray) -> list:
    """Sutherland-Hodgman: clip polygon by half-plane left of edge a->b."""
    out = []
    d = b - a
    for i, cur in enumerate(subject):
        nxt = subject[(i + 1) % len(subject)]
        c_cur = d[0] * (cur[1] - a[1]) - d[1] * (cur[0] - a[0])
        c_nxt = d[0] * (nxt[1] - a[1]) - d[1] * (nxt[0] - a[0])
        if c_cur >= 0:
            out.append(cur)
        if (c_cur >= 0) != (c_nxt >= 0):
            t = c_cur / (c_cur - c_nxt)
            out.append(cur + t * (nxt - cur))
    return out


def rotated_iou_2d(box1: np.ndarray, box2: np.ndarray) -> float:
    """IoU of two (x, y, w, l, r) rotated BEV boxes (host, exact)."""
    c1 = geometry.center_to_corner_box2d(box1[None])[0]
    c2 = geometry.center_to_corner_box2d(box2[None])[0]
    poly = [c1[i].astype(np.float64) for i in range(4)]
    for e in range(4):
        if not poly:
            break
        poly = _poly_clip(poly, c2[e].astype(np.float64),
                          c2[(e + 1) % 4].astype(np.float64))
    if len(poly) < 3:
        inter = 0.0
    else:
        arr = np.array(poly)
        x, y = arr[:, 0], arr[:, 1]
        inter = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))
    a1 = float(box1[2] * box1[3])
    a2 = float(box2[2] * box2[3])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def raster_iou_2d(box1: np.ndarray, box2: np.ndarray, obj_config,
                  image_hw: tuple[int, int] = (375, 1242)) -> float:
    """Reference-parity BEV IoU of the two boxes' rasters.

    Reproduces voxelnet/dataset.py:222-240 `calc_iou2d` exactly: corners
    -> BEV grid-index pixels ((p - min) / voxel_size, clipped to the grid
    extent), int32-TRUNCATED, rasterized as cv2.fillConvexPoly rasterizes
    them onto an IMAGE-sized (H=375, W=1242) buffer — note the buffer is
    image-sized while coords are grid-sized, so for the Car grid rows
    375..400 fall off the buffer (a reference quirk this mode carries).
    IoU = shared / (shared + exclusive) pixels; 0.0 when both rasters are
    identical-or-empty (the reference's `indiv == 0` early-out).

    The rasters come from `utils/raster.py::polygon_pixels`, bit-equal to
    cv2.fillConvexPoly, as the pixel sets of the two polygons' rows: no
    buffer of the image's size is allocated.
    """
    h, w = image_hw
    corners = geometry.center_to_corner_box2d(
        np.stack([box1, box2]).astype(np.float32))       # (2, 4, 2)
    pixels = []
    for c in corners:
        a = (c[:, 0] - obj_config.x_min) / obj_config.x_voxel_size
        b = (c[:, 1] - obj_config.y_min) / obj_config.y_voxel_size
        a = np.clip(a, 0, (obj_config.x_max - obj_config.x_min)
                    / obj_config.x_voxel_size)
        b = np.clip(b, 0, (obj_config.y_max - obj_config.y_min)
                    / obj_config.y_voxel_size)
        pix = np.stack([a, b], axis=-1).astype(np.int32)
        pixels.append(raster.polygon_pixels(pix, h, w))
    share = np.intersect1d(pixels[0], pixels[1], assume_unique=True).size
    indiv = pixels[0].size + pixels[1].size - 2 * share
    if indiv == 0:
        return 0.0
    return float(share / (indiv + share))


def augment_pointcloud(points: np.ndarray, gt_boxes_cam: np.ndarray,
                       rng: np.random.Generator,
                       collision_iou=None):
    """Apply one randomly chosen augmentation.

    Args:
      points: (N, 4) lidar points (modified copy returned).
      gt_boxes_cam: (G, 7) GT boxes in camera coordinates.
      rng: numpy Generator.
      collision_iou: optional fn(box1, box2) -> float overriding the
        exact rotated IoU for the per-box collision check (the
        compat.raster_collision mode passes raster_iou_2d here).

    Returns (points, gt_boxes_cam, tag_suffix).
    """
    if collision_iou is None:
        collision_iou = rotated_iou_2d
    points = points.copy()
    gt_boxes_cam = np.asarray(gt_boxes_cam, np.float32).reshape(-1, 7)
    choice = rng.integers(0, 10)

    if choice >= 7 and not len(gt_boxes_cam):
        # reference parity: a boxless frame drawn into the per-box branch
        # is a NO-OP (voxelnet/dataset.py:141-191 loops over zero boxes),
        # not a reroute into global scaling
        return points, gt_boxes_cam, "aug_1"

    if choice >= 7:
        # per-box perturbation with collision check (dataset.py:143-191)
        lidar_boxes = geometry.camera_to_lidar_boxes(gt_boxes_cam)
        corners = geometry.center_to_corner_box3d(lidar_boxes, "lidar")
        for idx in range(len(lidar_boxes)):
            for _attempt in range(100):
                t_rz = rng.uniform(-np.pi / 10, np.pi / 10)
                t_x, t_y, t_z = rng.normal(size=3)
                moved = geometry.box_transform(
                    lidar_boxes[idx:idx + 1], t_x, t_y, t_z, t_rz, "lidar")[0]
                collision = any(
                    collision_iou(moved[[0, 1, 4, 5, 6]],
                                  lidar_boxes[j][[0, 1, 4, 5, 6]]) > 0
                    for j in range(idx)
                )
                if not collision:
                    box_c = corners[idx]
                    lo, hi = box_c.min(axis=0), box_c.max(axis=0)
                    inside = np.all(
                        (points[:, :3] >= lo) & (points[:, :3] <= hi), axis=1)
                    points[inside, :3] = geometry.point_transform(
                        points[inside, :3], t_x, t_y, t_z, rz=t_rz)
                    lidar_boxes[idx] = moved
                    break
        gt_boxes_cam = geometry.lidar_to_camera_boxes(
            lidar_boxes).astype(np.float32)
        tag = f"aug_1_{rng.integers(1, 1024)}"

    elif 4 <= choice < 7:
        # global rotation (dataset.py:193-201)
        angle = rng.uniform(-np.pi / 4, np.pi / 4)
        points[:, :3] = geometry.point_transform(points[:, :3], rz=angle)
        if len(gt_boxes_cam):
            lidar_boxes = geometry.camera_to_lidar_boxes(gt_boxes_cam)
            lidar_boxes = geometry.box_transform(
                lidar_boxes, 0, 0, 0, angle, "lidar")
            gt_boxes_cam = geometry.lidar_to_camera_boxes(
                lidar_boxes).astype(np.float32)
        tag = f"aug_2_{angle:.4f}".replace(".", "_")

    else:
        # global scaling (dataset.py:203-210)
        factor = rng.uniform(0.95, 1.05)
        points[:, :3] *= factor
        if len(gt_boxes_cam):
            lidar_boxes = geometry.camera_to_lidar_boxes(gt_boxes_cam)
            lidar_boxes[:, :6] *= factor
            gt_boxes_cam = geometry.lidar_to_camera_boxes(
                lidar_boxes).astype(np.float32)
        tag = f"aug_3_{factor:.4f}".replace(".", "_")

    return points, gt_boxes_cam, tag
