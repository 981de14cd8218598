"""The port's host data path against the JAX package on the CPU: the KITTI
dataset and its batches (bit-equal, with and without augmentation, in the
int16 wire format and in f32, with the raster collision check), the
batch plan and the threaded pipeline, KITTI label I/O, box geometry, the
host IoU matrices, and the config's YAML override files and snapshot.
Inputs are made with numpy from a seed at the tiny grid."""

import glob
import os
import threading
import time

import numpy as np
import pytest
import yaml
from torch_port_helpers import LABEL_LINES, TINY, configs, merged, \
    write_mini_kitti

from voxelnet_tpu.data import dataset as jax_dataset
from voxelnet_tpu.data.pipeline import LazyBatchIterator as JaxLazy
from voxelnet_tpu.ops import iou_np as jax_iou_np
from voxelnet_tpu.utils import geometry as jax_geometry
from voxelnet_tpu.utils import kitti as jax_kitti
from voxelnet_tpu_torch.data import dataset
from voxelnet_tpu_torch.data.pipeline import LazyBatchIterator
from voxelnet_tpu_torch.ops import iou_np
from voxelnet_tpu_torch.utils import geometry, kitti, yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Six frames of 3000 points with all five label lines."""
    root = tmp_path_factory.mktemp("kitti")
    return str(write_mini_kitti(root, splits=(("training", 6),),
                                n_points=3000, seed=3, labels=LABEL_LINES))


def _assert_examples_equal(got, want):
    for name in ("tag", "num_points", "label_lines", "image_path",
                 "points_clipped", "gt_clipped"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("points", "gt_boxes", "gt_mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


MODES = {
    "i16q": {"train": {"upload_points": "i16q"}},
    "f32": {"train": {"upload_points": "f32"}},
    "augment": {"train": {"augment": True}},
    "augment_f32": {"train": {"augment": True, "upload_points": "f32"}},
    "raster": {"train": {"augment": True},
               "compat": {"raster_collision": True}},
    # the cap below the cropped cloud: shuffle + truncate, clip flags
    "capped": {"data": {"max_points": 1024, "max_gt_boxes": 1}},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_dataset_matches_jax(kitti_root, mode):
    """Every example over 4 epochs (the augmentation's three branches all
    drawn) and every collated batch, bit-equal to the JAX dataset's."""
    overrides = merged(TINY, **MODES[mode])
    jcfg, tcfg = configs(overrides=overrides)
    aug = tcfg.train.augment
    want_ds = jax_dataset.KITTIDataset(kitti_root + "/training", jcfg,
                                       augment=aug, seed=5)
    got_ds = dataset.KITTIDataset(kitti_root + "/training", tcfg,
                                  augment=aug, seed=5)
    assert got_ds.tags == want_ds.tags and len(got_ds) == 6
    suffixes = set()
    for epoch in range(4):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        for i in range(len(got_ds)):
            got, want = got_ds[i], want_ds[i]
            _assert_examples_equal(got, want)
            suffixes.add(got.tag.split("_")[2] if aug else "")
        for got_b, want_b in zip(
                dataset.make_batch_iterator(got_ds, 4, seed=epoch,
                                            drop_remainder=False),
                jax_dataset.make_batch_iterator(want_ds, 4, seed=epoch,
                                                drop_remainder=False)):
            _assert_batches_equal(got_b, want_b)
    want_dtype = np.int16 if mode in ("i16q", "capped") else np.float32
    assert got.points.dtype == want_dtype
    if aug:
        assert suffixes == {"1", "2", "3"}
    if mode == "capped":
        assert got.points_clipped and got.gt_clipped


def test_host_voxelize_is_refused(kitti_root):
    """Host voxelization with a voxelizer the port does not have."""
    _, tcfg = configs(overrides=merged(TINY, data={"host_voxelizer": "cuda"}))
    with pytest.raises(ValueError, match="host voxelizer"):
        dataset.KITTIDataset(kitti_root + "/training", tcfg,
                             host_voxelize=True)


@pytest.mark.parametrize("n,bs,shuffle,drop,shard", [
    (10, 4, True, True, None), (10, 4, False, False, None),
    (3, 4, True, False, None), (12, 4, True, False, (1, 2)),
    (7, 2, True, True, (0, 2))])
def test_plan_batches_matches_jax(n, bs, shuffle, drop, shard):
    got = dataset.plan_batches(n, bs, shuffle, 7, drop, shard)
    want = jax_dataset.plan_batches(n, bs, shuffle, 7, drop, shard)
    assert len(got) == len(want)
    for (gi, gn), (wi, wn) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gn == wn


def test_lazy_iterator_same_stream_for_any_worker_count(kitti_root):
    """1, 2 and 5 workers give the JAX pipeline's stream (one worker)."""
    jcfg, tcfg = configs()
    want_ds = jax_dataset.KITTIDataset(kitti_root + "/training", jcfg)
    got_ds = dataset.KITTIDataset(kitti_root + "/training", tcfg)
    want = list(JaxLazy(want_ds, 2, seed=3, workers=1,
                        drop_remainder=False))
    assert len(want) == 3
    for workers in (1, 2, 5):
        got = list(LazyBatchIterator(got_ds, 2, seed=3, workers=workers,
                                     depth=1, drop_remainder=False))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_lazy_iterator_close_stops_its_workers(kitti_root):
    """A consumer that stops after one batch: close() ends every worker,
    those blocked on the full output queue included."""
    _, tcfg = configs()
    ds = dataset.KITTIDataset(kitti_root + "/training", tcfg)
    it = LazyBatchIterator(ds, 1, seed=0, workers=3, depth=1)
    next(it)
    time.sleep(0.2)             # the workers fill the output queue
    it.close()
    assert not any(t.is_alive() for t in it._threads)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("batch-worker")]


def test_pipeline_error_is_raised_and_stops_the_workers(kitti_root):
    _, tcfg = configs()
    ds = dataset.KITTIDataset(kitti_root + "/training", tcfg)

    def fail(batch):
        raise OSError("unreadable frame")

    it = LazyBatchIterator(ds, 1, workers=2, depth=1, transform=fail)
    with pytest.raises(OSError, match="unreadable"):
        list(it)
    assert not any(t.is_alive() for t in it._threads)


def test_kitti_labels_round_trip_as_jax(tmp_path):
    """parse -> emit is string-equal to the JAX package's, in both
    frames, with scores, with the mean calib and with a calib file."""
    calib = tmp_path / "calib.txt"
    rng = np.random.default_rng(0)
    rows = [f"P{i}: " + " ".join(f"{v:.6e}" for v in rng.normal(0, 1, 12))
            for i in range(4)]
    rows.append("R0_rect: " + " ".join(f"{v:.6e}" for v in np.eye(3).ravel()
                                        + rng.normal(0, 0.01, 9)))
    rows.append("Tr_velo_to_cam: " + " ".join(
        f"{v:.6e}" for v in rng.normal(0, 1, 12)))
    rows.append("Tr_imu_to_velo: " + " ".join(["0"] * 12))
    calib.write_text("\n".join(rows) + "\n")
    mats = kitti.load_calib(str(calib))
    for g, w in zip(mats, jax_kitti.load_calib(str(calib))):
        np.testing.assert_array_equal(g, w)
    P, Tr, R = mats
    lines = list(LABEL_LINES)
    assert kitti.parse_label_classes(lines) == \
        jax_kitti.parse_label_classes(lines)
    for cls in ("Car", "Pedestrian", ""):
        for coord in ("camera", "lidar"):
            for calib_args in ({}, {"T_VELO_2_CAM": Tr, "R_RECT_0": R}):
                got = kitti.parse_label_lines(lines, cls, coord, **calib_args)
                want = jax_kitti.parse_label_lines(lines, cls, coord,
                                                   **calib_args)
                np.testing.assert_array_equal(got, want)
                names = [cls or "Car"] * len(got)
                scores = rng.uniform(0, 1, len(got))
                for kw in ({}, {"scores": scores, "P2": P, **calib_args}):
                    assert kitti.boxes_to_label_lines(
                        got, names, coordinate=coord, **kw) == \
                        jax_kitti.boxes_to_label_lines(
                            want, names, coordinate=coord, **kw)
    boxes = kitti.parse_label_lines(lines, "", "lidar")
    for cap in (2, 8):
        for g, w in zip(kitti.pad_gt_boxes(boxes, cap),
                        jax_kitti.pad_gt_boxes(boxes, cap)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="unknown class"):
        kitti.parse_label_lines(lines, "Truck")


def test_geometry_matches_jax():
    """Every host geometry function on the same f32 inputs, rtol=0."""
    rng = np.random.default_rng(1)
    boxes = np.concatenate([rng.uniform(-20, 20, (16, 3)),
                            rng.uniform(0.5, 5, (16, 3)),
                            rng.uniform(-4, 4, (16, 1))], 1).astype(np.float32)
    pts = rng.uniform(-30, 30, (64, 3)).astype(np.float32)
    corners = geometry.center_to_corner_box3d(boxes)
    calls = [
        ("angle_in_limit", (boxes[:, 6] * 2,), {}),
        ("camera_to_lidar_points", (pts,), {}),
        ("lidar_to_camera_points", (pts,), {}),
        ("camera_to_lidar_boxes", (boxes,), {}),
        ("lidar_to_camera_boxes", (boxes,), {}),
        ("center_to_corner_box3d", (boxes, "camera"), {}),
        ("center_to_corner_box3d", (boxes, "lidar"), {}),
        ("corner_to_center_box3d", (corners, "lidar"), {}),
        ("corner_to_center_box3d", (corners, "camera"), {}),
        ("center_to_corner_box2d", (boxes[:, [0, 1, 4, 5, 6]],), {}),
        ("corner_to_standup_box2d", (corners[:, :4, :2],), {}),
        ("anchor_to_standup_box2d", (boxes[:, :4],), {}),
        ("anchor_to_standup_box2d", (boxes[:, :4], True), {}),
        ("lidar_box3d_to_camera_box", (boxes,), {}),
        ("lidar_box3d_to_camera_box", (boxes, True), {}),
        ("point_transform", (pts, 0.5, -0.3, 0.1, 0.4, 0.2, 0.1), {}),
        ("box_transform", (boxes, 0.5, -0.3, 0.1, 0.4), {}),
    ]
    for name, args, kw in calls:
        got = getattr(geometry, name)(*args, **kw)
        want = getattr(jax_geometry, name)(*args, **kw)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_host_iou_matrices_match_jax():
    rng = np.random.default_rng(2)
    b1 = np.concatenate([rng.uniform(0, 6, (12, 3)),
                         rng.uniform(1, 4, (12, 3)),
                         rng.uniform(-3, 3, (12, 1))], 1)
    b2 = b1[rng.permutation(12)[:9]] + rng.normal(0, 0.5, (9, 7))
    b2[:, 3:6] = np.abs(b2[:, 3:6]) + 0.5
    for mode in ("3d", "bev"):
        want = jax_iou_np.box3d_iou_matrix_np(b1, b2, mode)
        np.testing.assert_array_equal(
            iou_np.box3d_iou_matrix_np(b1, b2, mode), want)
        assert (want > 0).sum() >= 5
    np.testing.assert_array_equal(
        iou_np.rotated_iou_np(b1[:, [0, 1, 4, 5, 6]], b2[:, [0, 1, 4, 5, 6]]),
        jax_iou_np.rotated_iou_np(b1[:, [0, 1, 4, 5, 6]],
                                  b2[:, [0, 1, 4, 5, 6]]))
    assert iou_np.rotated_iou_np(b1[:0, :5], b2[:, :5]).shape == (0, 9)


# --- config override files and snapshot -----------------------------------

def _override_files():
    files = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(files) >= 5
    return files


SKILL_FILE = """object: {x_max: 12.8, y_min: -6.4, y_max: 6.4}
data: {max_points: 2048, max_voxels: 256, max_gt_boxes: 8}
train: {batch_size: 2, num_epochs: 2}
val: {batch_size: 2}
"""


@pytest.mark.parametrize("path", _override_files() + ["skill"],
                         ids=lambda p: os.path.basename(p))
def test_override_files_merge_as_jax(path, tmp_path):
    if path == "skill":
        path = tmp_path / "mini.yaml"
        path.write_text(SKILL_FILE)
    for class_name in ("Car", "Cyclist"):
        jcfg, tcfg = configs(class_name, overrides={})
        want = jcfg.merge_from_file(str(path)).to_dict()
        assert tcfg.merge_from_file(str(path)).to_dict() == want


@pytest.mark.parametrize("overrides", [{}, merged(
    TINY, train={"lr": 1e-5, "remat": "seams"},
    data={"dir": "/data/it's here"})], ids=["preset", "knobs"])
def test_snapshot_loads_as_the_jax_dump(overrides, tmp_path):
    """The port's config.yaml text: yaml.safe_load gives the JAX
    dump_yaml's dict, the subset reader gives the same, and from_dict /
    merge_from_file of it give back the config (lists where the dataclass
    held tuples, as yaml gives the JAX package)."""
    jcfg, tcfg = configs("Pedestrian", overrides)
    text = tcfg.dump_yaml()
    want = yaml.safe_load(jcfg.dump_yaml())
    assert yaml.safe_load(text) == want
    assert yaml_subset.load(text) == want
    path = tmp_path / "config.yaml"
    path.write_text(text)
    assert tcfg.merge_from_file(str(path)).to_dict() == \
        jcfg.merge_from_file(str(path)).to_dict()
    assert type(tcfg).from_dict(want).to_dict() == \
        type(jcfg).from_dict(want).to_dict()


@pytest.mark.parametrize("text", [
    "a: 017", "a: 0x1f", "a: 1_000", "a: 1e-3", "a: 2024-01-02",
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "- a: 1",
    "? a\n: 1", "---\na: 1", "a:\n\tb: 1", "a: {b: 1", "a: 'x",
    "a: 1\na: 2", "a: [1, 2] x", "a: 1:30"])
def test_yaml_subset_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


def test_yaml_subset_reads_as_pyyaml():
    text = ("# comment\nobject:   # trailing\n  x_max: 12.8\n  name: 'it''s'\n"
            "train: {augment: yes, lr: .5, remat: \"full\", seed: -3}\n"
            "list:\n- 1\n- [2.0, .inf, -.Inf, ~]\n- 'a # not a comment'\n"
            "nested: [[1, 2], [3, {k: v}]]\nempty: {}\nnothing:\n"
            "bools: [on, Off, TRUE, no, null, Null]\n")
    assert yaml_subset.load(text) == yaml.safe_load(text)
    assert yaml_subset.load("") is None
    assert yaml_subset.load("[1, 2]") == [1, 2]
