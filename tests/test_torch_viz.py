"""The port's viz on its cv2-free rasterizer and PNG I/O, against cv2 and
the JAX package on the CPU (`voxelnet_tpu_torch/utils/{raster,image_io,
viz}.py`, `data/augment.py::raster_iou_2d`, the trainer's image dumps).

Tolerances: `fill_convex_poly`, `raster_iou_2d`, `apply_jet`,
`resize_linear`, `lidar_to_bev_image`, `colorize_heatmap` and the PNG
reader are bit-equal to cv2 / the JAX package. `raster.line` (LINE_AA)
is held to its docstring's tolerance of cv2: where both change pixels,
the changed sets are within 1 pixel of each other (symmetric Hausdorff);
where cv2 changes none the port changes at most 2; the mean absolute
difference over the pixels either changes is at most 24 levels a line
and at most 4 over all lines. The box drawings of `viz` (many lines,
crossing at the corners) are held to the same Hausdorff distance and to
a mean of at most 8 levels over the pixels either changes."""

import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.spatial import cKDTree
from torch_port_helpers import (LABEL_LINES, TINY, configs, merged,
                                write_mini_kitti)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu.data import augment as jax_augment
from voxelnet_tpu.utils import viz as jax_viz
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.data import augment
from voxelnet_tpu_torch.utils import image_io, raster, viz

# the AA-line tolerance of raster.line (its docstring)
HAUSDORFF_PX = 1.0
EMPTY_MAX_PX = 2
MEAN_LINE = 24.0
MEAN_ALL = 4.0
MEAN_DRAWING = 8.0


# --- fill_convex_poly and raster_iou_2d: bit-equal ---------------------------

def _cv2_fill(pts, h, w):
    buf = np.zeros((h, w, 3))
    return cv2.fillConvexPoly(buf, np.asarray(pts, np.int32),
                              color=(1, 1, 1))


def _assert_fill_equal(pts, h=40, w=50):
    want = _cv2_fill(pts, h, w)
    got = raster.fill_convex_poly(np.zeros((h, w, 3)),
                                  np.asarray(pts, np.int32), (1, 1, 1))
    np.testing.assert_array_equal(got, want, err_msg=str(pts))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(st.integers(-15, 65), st.integers(-15, 55)),
                min_size=1, max_size=6))
def test_fill_convex_poly_equals_cv2(pts):
    """Any int polygon, clipped or not, convex or not: cv2's pixels."""
    _assert_fill_equal(pts)


@settings(max_examples=150, deadline=None)
@given(st.floats(-10, 60), st.floats(-10, 50), st.floats(0.5, 30),
       st.floats(0.5, 30), st.floats(-3.2, 3.2))
def test_fill_convex_poly_rotated_rectangles(cx, cy, w, l, r):
    """The raster check's polygons: truncated rotated rectangles."""
    c, s = np.cos(r), np.sin(r)
    corners = np.array([[-w, -l], [w, -l], [w, l], [-w, l]]) / 2
    pts = (corners @ np.array([[c, s], [-s, c]]) + [cx, cy])
    _assert_fill_equal(pts.astype(np.int32))


@pytest.mark.parametrize("pts", [
    [(3, 7), (20, 7), (9, 7), (30, 7)],          # every corner on one row
    [(5, 5), (5, 5), (5, 5), (5, 5)],            # one pixel
    [(5, 5), (12, 9), (12, 9), (4, 15)],         # a repeated vertex
    [(10, 30), (40, 35), (45, 60), (12, 70)],    # rows past the buffer
    [(-20, -5), (70, -3), (60, 80), (-9, 70)],   # past every side
    [(0, 39), (49, 39), (49, 45), (0, 45)],      # from the last row out
    [(8, 3), (9, 3)],                            # two vertices: a segment
    [(8, 3)],                                    # one vertex
])
def test_fill_convex_poly_degenerate(pts):
    _assert_fill_equal(pts)


def _box(x, y, w=1.6, l=3.9, r=0.0):
    return np.array([x, y, w, l, r], np.float32)


@pytest.mark.parametrize("class_name", ["Car", "Pedestrian", "Cyclist"])
def test_raster_iou_equals_jax(class_name):
    """Box pairs on the class's grid, near enough to overlap, clipped at
    the grid's edges: bit-equal to the JAX package's cv2 version (which
    rasterizes onto the reference's 375 x 1242 image buffer, so the Car
    grid's rows 375-399 fall off it)."""
    obj = get_config(class_name).object
    rng = np.random.default_rng(11)
    size = {"Car": (1.6, 3.9), "Pedestrian": (0.6, 0.8),
            "Cyclist": (0.6, 1.8)}[class_name]
    pairs = []
    for _ in range(60):
        x = rng.uniform(obj.x_min - 2, obj.x_max + 2)
        y = rng.uniform(obj.y_min - 2, obj.y_max + 2)
        a = _box(x, y, *np.multiply(size, rng.uniform(0.7, 1.3, 2)),
                 rng.uniform(-np.pi, np.pi))
        b = _box(x + rng.normal(0, size[1] / 2), y + rng.normal(0, size[0]),
                 *np.multiply(size, rng.uniform(0.7, 1.3, 2)),
                 rng.uniform(-np.pi, np.pi))
        pairs.append((a, b))
    pairs += [(_box(20, 0), _box(20, 0)), (_box(10, -10), _box(40, 10)),
              (_box(20, 0), _box(20, 0.8)), (_box(-30, 0), _box(20, 0)),
              (_box(30, 39.5), _box(30.5, 39.0, r=0.3))]
    overlapping = 0
    for a, b in pairs:
        want = jax_augment.raster_iou_2d(a, b, obj)
        got = augment.raster_iou_2d(a, b, obj)
        assert got == want, (a, b, got, want)
        overlapping += want > 0
    assert overlapping >= 20


def test_raster_iou_reference_quirks():
    """tests/test_compat_modes.py's cases, on the port."""
    obj = get_config("Car").object
    assert augment.raster_iou_2d(_box(20, 0), _box(20, 0), obj) == 0.0
    assert augment.raster_iou_2d(_box(10, -10), _box(40, 10), obj) == 0.0
    exact = augment.rotated_iou_2d(_box(20, 0), _box(20, 0.8))
    got = augment.raster_iou_2d(_box(20, 0), _box(20, 0.8), obj)
    assert got > 0 and abs(got - exact) < 0.1
    assert augment.raster_iou_2d(_box(-30, 0), _box(20, 0), obj) == 0.0


def test_raster_collision_runs_without_cv2(tmp_path, monkeypatch):
    """compat.raster_collision on the port with cv2 unimportable: every
    augmented example over 3 epochs equals the JAX dataset's (which
    rasterizes with cv2, run first)."""
    from voxelnet_tpu.data import dataset as jax_dataset
    from voxelnet_tpu_torch.data import dataset

    root = write_mini_kitti(str(tmp_path / "kitti"),
                            splits=(("training", 4),), n_points=2000,
                            seed=7, labels=LABEL_LINES)
    jcfg, tcfg = configs(overrides=merged(
        TINY, train={"augment": True}, compat={"raster_collision": True}))
    want_ds = jax_dataset.KITTIDataset(root + "/training", jcfg,
                                       augment=True, seed=2)
    want = []
    for epoch in range(3):
        want_ds.set_epoch(epoch)
        want += [want_ds[i] for i in range(len(want_ds))]
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    got_ds = dataset.KITTIDataset(root + "/training", tcfg, augment=True,
                                  seed=2)
    branches = set()
    for epoch in range(3):
        got_ds.set_epoch(epoch)
        for i in range(len(got_ds)):
            got, w = got_ds[i], want[epoch * len(got_ds) + i]
            assert got.tag == w.tag
            branches.add(got.tag.split("_")[2])
            np.testing.assert_array_equal(got.points, w.points)
            np.testing.assert_array_equal(got.gt_boxes, w.gt_boxes)
    assert "1" in branches                  # the collision-checked branch


# --- line (LINE_AA): within the stated tolerance -----------------------------

def _changed(img, bg):
    return np.argwhere((img != bg).any(-1))


def _line_gap(got, want, bg):
    """(symmetric Hausdorff distance of the changed pixels or None when
    one side changed none, changed counts, mean |diff| over the pixels
    either changes)."""
    cg, cw = _changed(got, bg), _changed(want, bg)
    mask = (got != bg).any(-1) | (want != bg).any(-1)
    mean = (float(np.abs(got.astype(int) - want)[mask].mean())
            if mask.any() else 0.0)
    if len(cg) and len(cw):
        h = max(cKDTree(cg).query(cw)[0].max(),
                cKDTree(cw).query(cg)[0].max())
        return h, (len(cg), len(cw)), mean
    return None, (len(cg), len(cw)), mean


def _assert_line_like(got, want, bg, means):
    h, (ng, nw), mean = _line_gap(got, want, bg)
    if h is None:
        assert nw == 0 and ng <= EMPTY_MAX_PX, (ng, nw)
    else:
        assert h <= HAUSDORFF_PX, h
    assert mean <= MEAN_LINE, mean
    means.append(mean)


def test_line_within_tolerance_of_cv2():
    rng = np.random.default_rng(0)
    means = []
    for t in range(400):
        lo, hi = [(-20, 100), (5, 55), (-3000, 3000)][t % 3]
        p0 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        p1 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        if t % 3 == 1:                     # short lines
            p1 = (p0[0] + int(rng.integers(-6, 7)),
                  p0[1] + int(rng.integers(-6, 7)))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        bg = rng.integers(0, 256, 3).astype(np.uint8)
        want = np.empty((60, 80, 3), np.uint8)
        want[:] = bg
        got = want.copy()
        cv2.line(want, p0, p1, color, 1, cv2.LINE_AA)
        raster.line(got, p0, p1, color)
        _assert_line_like(got, want, bg, means)
    assert np.mean(means) <= MEAN_ALL
    with pytest.raises(ValueError, match="thickness 1"):
        raster.line(np.zeros((4, 4, 3), np.uint8), (0, 0), (3, 3), (1, 1, 1),
                    thickness=2)


# --- apply_jet, resize_linear: bit-equal -------------------------------------

def test_apply_jet_and_resize_equal_cv2():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        raster.apply_jet(gray), cv2.applyColorMap(gray, cv2.COLORMAP_JET))
    rng = np.random.default_rng(1)
    for shape in [(200, 176, 3), (7, 9, 3), (1, 1, 3), (5, 3), (2, 3, 3)]:
        img = rng.integers(0, 256, shape, np.uint8)
        for factor in (1, 2, 3, 4):
            want = cv2.resize(img, (shape[1] * factor, shape[0] * factor))
            np.testing.assert_array_equal(raster.resize_linear(img, factor),
                                          want, err_msg=f"{shape} x{factor}")
    bgr = rng.integers(0, 256, (4, 5, 3), np.uint8)
    np.testing.assert_array_equal(raster.bgr_to_rgb(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))


# --- viz against the JAX package's -------------------------------------------

def test_viz_functions_match_jax():
    cfg = get_config("Car")
    obj = cfg.object
    rng = np.random.default_rng(2)
    boxes = np.array([[12.0, 2.0, -1.6, 1.5, 1.6, 3.9, 0.3],
                      [25.0, -6.0, -1.5, 1.6, 1.7, 4.2, -1.1]], np.float32)
    gt = np.array([[12.3, 1.8, -1.6, 1.5, 1.6, 3.9, 0.25]], np.float32)
    points = np.concatenate([rng.uniform([0, -40, -3], [70.4, 40, 1],
                                         (4000, 3)),
                             rng.uniform(0, 1, (4000, 1))], 1
                            ).astype(np.float32)

    bg = np.array([17, 40, 90], np.uint8)
    img = np.empty((375, 1242, 3), np.uint8)
    img[:] = bg
    means = []
    front = viz.draw_boxes3d_on_image(img, boxes, gt)
    want = jax_viz.draw_boxes3d_on_image(img.copy(), boxes, gt)
    _assert_line_like(front, want, bg[::-1], means)

    bev = viz.lidar_to_bev_image(points, obj, factor=2)
    np.testing.assert_array_equal(bev, jax_viz.lidar_to_bev_image(
        points, obj, factor=2))
    blank = np.zeros_like(bev)
    drawn = viz.draw_boxes3d_on_bev(blank, boxes, obj, gt_boxes3d=gt,
                                    factor=2)
    want = jax_viz.draw_boxes3d_on_bev(blank.copy(), boxes, obj,
                                       gt_boxes3d=gt, factor=2)
    _assert_line_like(drawn, want, np.zeros(3, np.uint8), means)

    probs = rng.uniform(0, 1, (2, 200, 176)).astype(np.float32)
    np.testing.assert_array_equal(viz.colorize_heatmap(probs, factor=2),
                                  jax_viz.colorize_heatmap(probs, factor=2))
    assert max(means) <= MEAN_DRAWING


# --- PNG I/O -----------------------------------------------------------------

def _png(rows_by_filter, width, bpp, ctype, depth=8, interlace=0):
    """A PNG from raw scanlines, each row filtered as its tag says."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h = len(rows_by_filter)
    ihdr = struct.pack(">IIBBBBB", width, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows_by_filter)))
            + chunk(b"IEND", b""))


def _filter_rows(img: np.ndarray) -> list:
    """Scanlines of img (H, W, C) uint8 with filters 0-4 in turn."""
    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        kind = y % 5
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur
    return rows


def test_png_reader_equals_cv2_imread(tmp_path):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:48, 0:70]
    smooth = np.stack([xx * 3, yy * 5, xx + yy], -1) % 256
    img = (smooth + rng.integers(0, 9, smooth.shape)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    for arr in (img, img[..., 0], np.concatenate([img, img[..., :1]], -1),
                rng.integers(0, 256, (9, 13, 3), np.uint8)):
        for level in (0, 3, 9):             # libpng picks its filters
            cv2.imwrite(path, arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
            np.testing.assert_array_equal(image_io.read_png_bgr(path),
                                          cv2.imread(path))
    # every filter type, in runs of each, for RGB, RGBA and grey
    for arr, ctype in ((img, 2), (np.concatenate([img, img[..., :1]], -1),
                                  6), (img[..., :1], 0)):
        with open(path, "wb") as f:
            f.write(_png(_filter_rows(arr), arr.shape[1], arr.shape[2],
                         ctype))
        np.testing.assert_array_equal(image_io.read_png_bgr(path),
                                      cv2.imread(path))


def test_png_round_trip_and_refusals(tmp_path):
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (31, 45, 3), np.uint8)
    path = str(tmp_path / "w.png")
    image_io.write_png_rgb(path, rgb)
    np.testing.assert_array_equal(image_io.read_png_bgr(path), rgb[..., ::-1])
    np.testing.assert_array_equal(cv2.imread(path), rgb[..., ::-1])

    def write(data):
        with open(path, "wb") as f:
            f.write(data)

    rows = [b"\x00" + bytes(6)] * 2
    for kw, match in (({"depth": 16}, "bit depth 16"),
                      ({"ctype": 3}, "colour type 3"),
                      ({"ctype": 4}, "colour type 4"),
                      ({"interlace": 1}, "interlace 1")):
        write(_png(rows, 2, 3, **dict({"ctype": 2}, **kw)))
        with pytest.raises(ValueError, match=match):
            image_io.read_png_bgr(path)
    good = _png(rows, 2, 3, 2)
    write(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png_bgr(path)
    write(b"\xff\xd8\xff\xe0 a JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png_bgr(path)
    with pytest.raises(FileNotFoundError):
        image_io.read_png_bgr(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_png_rgb(path, rgb.astype(np.float32))


# --- the trainer's image dumps and TensorBoard images, without cv2 -----------

CALIB = """P0: 700 0 600 0 0 700 180 0 0 0 1 0
P1: 700 0 600 0 0 700 180 0 0 0 1 0
P2: 700 0 600 0 0 700 180 0 0 0 1 0
P3: 700 0 600 0 0 700 180 0 0 0 1 0
R0_rect: 1 0 0 0 1 0 0 0 1
Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0
Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0
"""


class _Images:
    """A summary writer that keeps the images it is given."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, img.shape, step))

    def add_scalar(self, *args):
        pass

    def close(self):
        pass


def test_trainer_dumps_images_without_cv2(tmp_path, monkeypatch):
    """One Trainer epoch with `num_vis_dump=3`, augmentation and the raster
    collision check, cv2 unimportable: the three val frames' images are
    written and read back as PNGs of the expected sizes (the frames whose
    camera image is missing or an empty placeholder get no front view),
    and the sampled validation writes its three TensorBoard images."""
    from voxelnet_tpu_torch.training.trainer import Trainer

    data = write_mini_kitti(str(tmp_path / "kitti"),
                            splits=(("training", 4), ("validation", 3)),
                            labels=LABEL_LINES[:2])
    calib_dir = tmp_path / "calib"
    calib_dir.mkdir()
    for i in range(3):
        (calib_dir / f"{i:06d}.txt").write_text(CALIB)
    rng = np.random.default_rng(5)
    image_io.write_png_rgb(os.path.join(data, "validation", "image_2",
                                        "000000.png"),
                           rng.integers(0, 256, (120, 400, 3), np.uint8))
    os.remove(os.path.join(data, "validation", "image_2", "000001.png"))
    cfg = get_config("Car", **merged(
        TINY, object={"x_min": 3.2, "x_max": 9.6, "y_min": -3.2,
                      "y_max": 3.2},
        train={"augment": True, "num_epochs": 1},
        compat={"raster_collision": True},
        data={"calib_dir": str(calib_dir)}, rpn={"score_thres": 0.0}))
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    with Trainer(cfg, data + "/training", data + "/validation",
                 exp_dir=str(tmp_path / "exp"), device="cpu") as tr:
        tr.summary = _Images()
        tr.train(print_interval=1000, summary_interval=1000, val_interval=1,
                 num_vis_dump=3)
        images = tr.summary.images
    vis = tmp_path / "exp" / "vis" / "1"
    assert sorted(os.listdir(vis)) == [
        "000000_bv.png", "000000_front.png", "000000_heatmap.png",
        "000001_bv.png", "000001_heatmap.png", "000002_bv.png",
        "000002_heatmap.png"]
    obj = cfg.object
    shapes = {name: image_io.read_png_bgr(str(vis / name)).shape
              for name in os.listdir(vis)}
    assert shapes["000000_front.png"] == (120, 400, 3)
    assert shapes["000001_bv.png"] == (obj.height * 2, obj.width * 2, 3)
    assert shapes["000001_heatmap.png"] == (obj.feature_height * 2,
                                            obj.feature_width * 2, 3)
    tags = {tag for tag, _, _ in images}
    assert tags == {"predict/front_view_rgb", "predict/bird_view_lidar",
                    "predict/bird_view_heatmap"}
    assert ("predict/front_view_rgb", (3, 120, 400), 1) in images
