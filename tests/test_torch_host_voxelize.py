"""The port's host voxelizer on the CPU: `voxelize_np` against the JAX
package's (integers and features exactly equal), its C++ twin
(voxelnet_tpu_torch/native, built with the host compiler into
voxelnet_tpu_torch/_build/) against it, mirroring
tests/test_native_voxelize.py but bit-equal, the `host_voxelize` dataset's
batches against the JAX dataset's, and a train step on host voxel buffers
against the step on the batch's points."""

import os

import numpy as np
import pytest
import torch
from torch_port_helpers import (LABEL_LINES, TINY, configs, jax_variables,
                                merged, random_points, torch_model,
                                write_mini_kitti)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu.data import dataset as jax_dataset
from voxelnet_tpu.ops import voxelize as jax_vox
from voxelnet_tpu_torch import convert, native
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.data import dataset
from voxelnet_tpu_torch.kernels._build import BUILD_DIR
from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec,
                                             resolve_host_voxelizer,
                                             voxelize_np)

FIELDS = ("features", "coords", "counts", "num_voxels", "num_voxels_raw")


def _assert_voxels_equal(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        assert np.array_equal(g, w), name


def _random_cloud(rng, n=50000, with_cluster=True):
    """tests/test_native_voxelize.py's cloud: in and out of the Car grid,
    and a dense cluster that fills one voxel past T."""
    pts = rng.uniform([-10, -45, -4, 0], [80, 45, 2, 1],
                      size=(n, 4)).astype(np.float32)
    if with_cluster:
        cluster = pts[:300].copy()
        cluster[:, :3] = pts[0, :3] + rng.normal(
            0, 0.05, (300, 3)).astype(np.float32)
        pts = np.concatenate([pts, cluster])
    return pts


def _lattice():
    """tests/test_torch_voxelize.py's voxel-boundary lattice of the tiny
    grid (multiples of the voxel size)."""
    grid = np.stack(np.meshgrid(np.arange(0, 12.8, 0.2),
                                np.arange(-6.4, 6.4, 0.4),
                                np.arange(-3.0, 1.0, 0.4)), -1).reshape(-1, 3)
    pts = np.zeros((len(grid), 4), np.float32)
    pts[:, :3] = grid
    pts[:, 3] = np.linspace(0, 1, len(grid))
    return pts


@pytest.fixture(scope="module")
def car_spec():
    return VoxelGridSpec.from_object_config(get_config("Car").object)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "lattice",
                                  "capped", "uncapped"])
def test_voxelize_np_matches_jax(case):
    jcfg, tcfg = configs()
    jspec = jax_vox.VoxelGridSpec.from_object_config(jcfg.object)
    tspec = VoxelGridSpec.from_object_config(tcfg.object)
    K = tcfg.data.max_voxels
    if case == "lattice":
        pts = _lattice()
    else:
        seed = int(case[-1]) if case.startswith("seed") else 3
        pts = random_points(np.random.default_rng(seed), jcfg, 1, 2000)[0][0]
    if case == "capped":
        K = 64
    if case == "uncapped":
        K = None
    got = voxelize_np(pts, tspec, K)
    want = jax_vox.voxelize_np(pts, jspec, K)
    _assert_voxels_equal(got, want)
    assert got.num_voxels > 0
    if case == "capped":
        assert got.num_voxels_raw > got.num_voxels == 64


def test_voxelize_np_shuffle_matches_jax():
    jcfg, tcfg = configs()
    pts = random_points(np.random.default_rng(4), jcfg, 1, 2000)[0][0]
    got = voxelize_np(pts, VoxelGridSpec.from_object_config(tcfg.object),
                      256, shuffle=True, rng=np.random.default_rng(1))
    want = jax_vox.voxelize_np(
        pts, jax_vox.VoxelGridSpec.from_object_config(jcfg.object), 256,
        shuffle=True, rng=np.random.default_rng(1))
    _assert_voxels_equal(got, want)


# --- the C++ twin ------------------------------------------------------------

def test_native_builds_into_the_port_build_dir():
    assert native.available(), native.load_error()
    lib = native.build()
    assert os.path.dirname(lib) == BUILD_DIR
    assert lib.endswith(".so") and os.path.exists(lib)
    assert native.compiler() and "--version" not in native.compiler()
    assert not os.path.exists(os.path.join(os.path.dirname(native.SRC),
                                           "_voxelize.so"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_numpy_twin(car_spec, seed):
    pts = _random_cloud(np.random.default_rng(seed))
    _assert_voxels_equal(native.voxelize_native(pts, car_spec, 12288),
                         voxelize_np(pts, car_spec, max_voxels=12288))


def test_native_max_voxels_clip(car_spec):
    pts = _random_cloud(np.random.default_rng(3), n=80000)
    got = native.voxelize_native(pts, car_spec, 256)
    assert got.num_voxels == 256 and got.num_voxels_raw > 256
    _assert_voxels_equal(got, voxelize_np(pts, car_spec, max_voxels=256))


def test_native_empty_and_all_outside(car_spec):
    for pts in (np.zeros((0, 4), np.float32),
                np.full((100, 4), -1000.0, np.float32)):
        got = native.voxelize_native(pts, car_spec, 64)
        assert got.num_voxels == 0 and got.num_voxels_raw == 0
        assert not got.features.any() and not got.counts.any()
        _assert_voxels_equal(got, voxelize_np(pts, car_spec, 64))


def test_native_keeps_arrival_order(car_spec):
    base = np.array([10.0, 0.0, -1.0], np.float32)
    pts = np.stack([np.r_[base + 0.001, 0.25],
                    np.r_[base + 0.002, 0.75]]).astype(np.float32)
    got = native.voxelize_native(pts, car_spec, 8)
    assert got.num_voxels == 1 and got.counts[0] == 2
    assert got.features[0, 0, 3] == np.float32(0.25)
    assert got.features[0, 1, 3] == np.float32(0.75)


def test_native_boundary_binning_matches():
    """The tiny grid's lattice, and test_native_voxelize.py's row of x on
    voxel boundaries of the Car grid."""
    _, tcfg = configs()
    tiny = VoxelGridSpec.from_object_config(tcfg.object)
    _assert_voxels_equal(native.voxelize_native(_lattice(), tiny, 4096),
                         voxelize_np(_lattice(), tiny, 4096))
    car = VoxelGridSpec.from_object_config(get_config("Car").object)
    vz, vy, vx = car.voxel_size_zyx
    ox, oy, oz = car.offset_xyz
    pts = np.zeros((60, 4), np.float32)
    pts[:, 0] = (np.arange(0, 60, dtype=np.float32) * np.float32(vx)
                 - np.float32(ox))
    pts[:, 1] = -np.float32(oy) + np.float32(vy) / 2
    pts[:, 2] = -np.float32(oz) + np.float32(vz) / 2
    _assert_voxels_equal(native.voxelize_native(pts, car, 128),
                         voxelize_np(pts, car, 128))


def test_native_crop_matches_mask(car_spec):
    from voxelnet_tpu_torch.ops.voxelize import crop_points, in_grid_mask

    pts = _random_cloud(np.random.default_rng(11), n=30000)
    ref = pts[in_grid_mask(pts, car_spec)]
    np.testing.assert_array_equal(native.crop_in_grid(pts, car_spec), ref)
    np.testing.assert_array_equal(crop_points(pts, car_spec), ref)
    assert native.crop_in_grid(np.zeros((0, 4), np.float32),
                               car_spec).shape == (0, 4)


def test_resolver(capsys, monkeypatch):
    assert resolve_host_voxelizer("numpy") is voxelize_np
    assert resolve_host_voxelizer("native") is native.voxelize_native
    assert resolve_host_voxelizer("auto") is native.voxelize_native
    assert "'auto': native (" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no such host voxelizer"):
        resolve_host_voxelizer("cuda")
    # a library that does not build: 'native' raises, 'auto' takes numpy
    # and says why
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "native voxelizer unavailable: "
                        "no compiler")
    with pytest.raises(RuntimeError, match="no compiler"):
        resolve_host_voxelizer("native")
    assert resolve_host_voxelizer("auto") is voxelize_np
    assert "'auto': numpy (native: native voxelizer unavailable" in \
        capsys.readouterr().out


# --- the host_voxelize dataset and train step --------------------------------

@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return str(write_mini_kitti(root, splits=(("training", 4),),
                                n_points=3000, seed=3, labels=LABEL_LINES))


@pytest.mark.parametrize("voxelizer", ["numpy", "native"])
@pytest.mark.parametrize("mode", ["f32", "i16q", "augment"])
def test_host_voxelize_batches_match_jax(kitti_root, voxelizer, mode):
    """Every batch over 2 epochs bit-equal to the JAX dataset's with its
    numpy voxelizer (the JAX C++ twin sums centroids in f64 and may
    differ by an ulp in the offsets; the port's twin is bit-equal to
    numpy), voxel buffers included; i16q points stay f32, as in JAX."""
    train = {"f32": {"upload_points": "f32"}, "i16q": {},
             "augment": {"augment": True}}[mode]
    jcfg, _ = configs(overrides=merged(TINY, train=train,
                                       data={"host_voxelizer": "numpy"}))
    _, tcfg = configs(overrides=merged(TINY, train=train,
                                       data={"host_voxelizer": voxelizer}))
    aug = tcfg.train.augment
    want_ds = jax_dataset.KITTIDataset(kitti_root + "/training", jcfg,
                                       augment=aug, host_voxelize=True,
                                       seed=5)
    got_ds = dataset.KITTIDataset(kitti_root + "/training", tcfg,
                                  augment=aug, host_voxelize=True, seed=5)
    for epoch in range(2):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        pairs = list(zip(
            dataset.make_batch_iterator(got_ds, 2, seed=epoch),
            jax_dataset.make_batch_iterator(want_ds, 2, seed=epoch)))
        assert len(pairs) == 2
        for got, want in pairs:
            assert got.keys() == want.keys()
            for key, w in want.items():
                if isinstance(w, np.ndarray):
                    assert got[key].dtype == w.dtype, key
                    np.testing.assert_array_equal(got[key], w, err_msg=key)
                else:
                    assert got[key] == w, key
    assert got["points"].dtype == np.float32
    assert got["voxel_features"].shape == (2, 256, 35, 7)
    assert got["voxel_counts"].sum() > 0


def test_step_on_host_voxels_equals_step_on_points(kitti_root):
    """A train step on a host_voxelize dataset batch (its voxel buffers)
    equals the step on the same batch's points voxelized on the device,
    exactly: metrics and every weight and BN stat (upload_points='f32')."""
    from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                        make_train_step)

    jcfg, tcfg = configs(overrides=merged(TINY,
                                          train={"upload_points": "f32"}))
    variables = jax_variables(jcfg, seed=13)
    ds = dataset.KITTIDataset(kitti_root + "/training", tcfg,
                              host_voxelize=True)
    batch = next(dataset.make_batch_iterator(ds, 2, seed=0))
    step = make_train_step(tcfg, device="cpu")

    def run(b):
        state = create_train_state(tcfg, torch_model(tcfg, variables),
                                   device="cpu")
        _, metrics = step(state, b)
        return metrics, convert.to_jax_variables(state.model.state_dict())

    keys = ("gt_boxes", "gt_mask")
    want, want_vars = run({k: batch[k] for k in keys + ("points",
                                                        "num_points")})
    got, got_vars = run({k: batch[k] for k in keys + (
        "voxel_features", "voxel_coords", "voxel_counts")})
    # both keep the lowest voxel ids of frames over max_voxels
    assert "voxels_clipped" not in got and int(want["voxels_clipped"]) == 2
    for name in got:
        assert float(got[name]) == float(want[name]), name
    for group in ("params", "batch_stats"):
        flat_w = dict(convert._flatten(want_vars[group]))
        for path, leaf in convert._flatten(got_vars[group]):
            np.testing.assert_array_equal(leaf, flat_w[path],
                                          err_msg=str(path))
    assert torch.is_tensor(got["loss"])
