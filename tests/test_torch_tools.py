"""The port's KITTI data tools against the JAX package's on the same
fixtures (tests/test_tools.py, tests/test_raw_to_kitti.py,
tests/test_raw_drive.py): the split, crop and raw-drive trees are
byte-equal to the JAX tools' (label and calib text, point files,
symlinks' targets), the tracklet parser returns the same tracklets, and
the raw-drive viewer reads its images without cv2, which only its video
clip needs."""

import os
import shutil
import sys

import cv2
import numpy as np
import pytest

from tests.test_raw_to_kitti import fake_raw_drive  # noqa: F401 (fixture)
from tests.test_tools import kitti_training  # noqa: F401 (fixture)
from voxelnet_tpu.data import preprocess as jax_preprocess
from voxelnet_tpu.data import raw_to_kitti as jax_raw_to_kitti
from voxelnet_tpu.data import split as jax_split
from voxelnet_tpu.utils import raw_drive as jax_raw_drive
from voxelnet_tpu.utils import tracklets as jax_tracklets
from voxelnet_tpu_torch.data import preprocess, raw_to_kitti, split
from voxelnet_tpu_torch.utils import raw_drive, tracklets


def _tree(root: str) -> dict:
    """{relative path: bytes, or ('link', target) for a symlink}."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.readlink(p))
            else:
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("symlink", [False, True])
def test_split_tree_is_the_jax_tools(kitti_training, tmp_path,  # noqa: F811
                                     symlink):
    args = (["000000", "000001", "000009"], ["000002", "000003"])
    want = jax_split.rearrange(str(kitti_training), str(tmp_path / "jax"),
                               *args, symlink=symlink)
    got = split.rearrange(str(kitti_training), str(tmp_path / "port"),
                          *args, symlink=symlink)
    assert got == want == {"training": 2, "validation": 2, "missing": 1}
    tree = _tree(str(tmp_path / "port"))
    assert tree == _tree(str(tmp_path / "jax")) and len(tree) == 12


def test_split_cli(kitti_training, tmp_path, capsys):  # noqa: F811
    (tmp_path / "train.txt").write_text("000000\n000001\n")
    (tmp_path / "val.txt").write_text("000002\n\n")
    split.main(["--kitti-dir", str(kitti_training), "--out-dir",
                str(tmp_path / "out"), "--train-split",
                str(tmp_path / "train.txt"), "--val-split",
                str(tmp_path / "val.txt")])
    assert "'training': 2, 'validation': 1" in capsys.readouterr().out


def test_preprocess_crops_as_the_jax_tool(kitti_training,  # noqa: F811
                                          tmp_path, capsys):
    velo = str(kitti_training / "velodyne")
    calib = str(kitti_training / "calib")
    jax_velo = str(tmp_path / "jax_velodyne")
    shutil.copytree(velo, jax_velo)
    n_want = jax_preprocess.align_img_and_velo(
        jax_velo, calib, archive_dir=str(tmp_path / "jax_archive"))
    preprocess.main(["--velodyne-dir", velo, "--calib-dir", calib,
                     "--archive-dir", str(tmp_path / "archive")])
    assert capsys.readouterr().out == f"cropped {n_want} point clouds\n"
    assert _tree(velo) == _tree(jax_velo) and len(_tree(velo)) == 4
    assert _tree(str(tmp_path / "archive")) == _tree(
        str(tmp_path / "jax_archive"))
    # a second run keeps the archive of the raw clouds
    preprocess.align_img_and_velo(velo, calib,
                                  archive_dir=str(tmp_path / "archive"))
    assert _tree(str(tmp_path / "archive")) == _tree(
        str(tmp_path / "jax_archive"))
    pts = np.random.default_rng(0).uniform(-20, 20, (50, 4)).astype(
        np.float32)
    from voxelnet_tpu_torch.utils import kitti

    P, Tr, R = kitti.load_calib(os.path.join(calib, "000000.txt"))
    np.testing.assert_array_equal(
        preprocess.project_velo_to_img(pts, P, Tr, R),
        jax_preprocess.project_velo_to_img(pts, P, Tr, R))


@pytest.mark.parametrize("kw", [
    {"split_mode": "block", "val_frac": 0.5},
    {"split_mode": "interleave", "val_every": 2, "symlink": False},
])
def test_raw_to_kitti_tree_is_the_jax_tools(fake_raw_drive,  # noqa: F811
                                            tmp_path, kw):
    want = jax_raw_to_kitti.convert_drive(fake_raw_drive, "0001",
                                          str(tmp_path / "jax"), **kw)
    got = raw_to_kitti.convert_drive(fake_raw_drive, "0001",
                                     str(tmp_path / "port"), **kw)
    assert got == want and got["objects"] == 4
    tree = _tree(str(tmp_path / "port"))
    assert tree == _tree(str(tmp_path / "jax"))
    assert sum(k.startswith(os.path.join("training", "label_2"))
               for k in tree) == got["training"]


def test_raw_to_kitti_cli_and_text(fake_raw_drive, tmp_path,  # noqa: F811
                                   capsys):
    raw_to_kitti.main(["--raw-root", fake_raw_drive, "--out-dir",
                       str(tmp_path / "out"), "--copy"])
    assert capsys.readouterr().out == (
        "{'training': 3, 'validation': 1, 'objects': 4}\n")
    P2, R0, Tr = raw_to_kitti.load_raw_calib(fake_raw_drive)
    assert raw_to_kitti.detection_calib_text(P2, R0, Tr) == \
        jax_raw_to_kitti.detection_calib_text(P2, R0, Tr)
    frame = [("Car", (1.5, 1.6, 3.9), (18.0, 2.0, -1.2), 0.3, 0),
             ("Van", (2.0, 1.9, 5.0), (9.0, -3.0, -1.0), -2.9, 255),
             ("Car", (1.5, 1.6, 3.9), (-5.0, 0.0, -1.0), 0.0, 1)]
    assert raw_to_kitti.tracklet_label_lines(frame, P2, R0, Tr, 1242, 375) \
        == jax_raw_to_kitti.tracklet_label_lines(frame, P2, R0, Tr, 1242,
                                                 375)


def test_tracklets_are_the_jax_parsers(fake_raw_drive):  # noqa: F811
    xml = os.path.join(fake_raw_drive, "2011_09_26_drive_0001_sync",
                       "tracklet_labels.xml")
    got, want = tracklets.parse_xml(xml), jax_tracklets.parse_xml(xml)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.object_type == w.object_type and len(g) == len(w)
        for field in ("size", "trans", "rots", "states", "occs", "truncs"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
        assert g.amt_occs is w.amt_occs is None
    boxes, types = tracklets.tracklets_per_frame(got, 4)
    want_boxes, want_types = jax_tracklets.tracklets_per_frame(want, 4)
    assert types == want_types
    for f in range(4):
        np.testing.assert_array_equal(np.asarray(boxes[f]),
                                      np.asarray(want_boxes[f]))


@pytest.fixture
def raw_root(fake_raw_drive):  # noqa: F811
    """The fixture drive with 4 frames of 4 cameras (48 x 64 PNGs)."""
    sync = os.path.join(fake_raw_drive, "2011_09_26_drive_0001_sync")
    rng = np.random.default_rng(1)
    for cam in range(4):
        d = os.path.join(sync, f"image_{cam:02d}", "data")
        os.makedirs(d, exist_ok=True)
        for i in range(4):
            cv2.imwrite(os.path.join(d, f"{i:010d}.png"),
                        rng.integers(0, 255, (48, 64, 3), np.uint8))
    return os.path.dirname(fake_raw_drive)


def test_raw_drive_reads_the_jax_viewers_frames(raw_root, monkeypatch):
    want = jax_raw_drive.RawDrive(raw_root, "2011_09_26", "0001")
    want_images = [want.image(i, cam) for i in range(4) for cam in range(4)]
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    got = raw_drive.RawDrive(raw_root, "2011_09_26", "0001")
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got.velo(2), want.velo(2))
    for k, img in enumerate(want_images):
        np.testing.assert_array_equal(got.image(k // 4, k % 4), img)
    boxes, types = got.tracklets()
    assert types[0] == ["Car", "Car"] and len(boxes[0]) == 2


def test_raw_drive_figures_without_cv2(raw_root, tmp_path, monkeypatch):
    """The stats figure and the GIF clip need no cv2; the video clip says
    that its VideoWriter does."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    drive = raw_drive.RawDrive(raw_root, "2011_09_26", "0001")
    out = raw_drive.display_frame_statistics(
        drive, 0, str(tmp_path / "stats.png"), points_step=16)
    assert os.path.getsize(out) > 1000
    out = raw_drive.create_clip_pcl(drive, str(tmp_path / "clip.gif"),
                                    max_frames=2, points_step=32)
    assert os.path.getsize(out) > 1000
    with pytest.raises(ImportError, match="cv2.VideoWriter"):
        raw_drive.create_clip_boxes(drive, str(tmp_path / "boxes.avi"))


def test_raw_drive_video_clip(raw_root, tmp_path, capsys):
    """With cv2 the box clip is written through the CLI (its overlays are
    drawn by raster.line)."""
    out = str(tmp_path / "boxes.avi")
    raw_drive.main(["clip-boxes", "--drive-dir", raw_root, "--date",
                    "2011_09_26", "--drive", "0001", "--out", out,
                    "--max-frames", "2"])
    assert capsys.readouterr().out == out + "\n"
    assert os.path.getsize(out) > 500
