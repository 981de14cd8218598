"""The port's voxelizer front end (voxelnet_tpu_torch/ops/voxelize.py) and
its numpy host helpers against the JAX package: every integer output and
the sorted point stream must be exactly equal."""

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import TINY, configs, merged, random_points
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu.ops import anchors as jax_anchors
from voxelnet_tpu.ops import voxelize as jax_vox
from voxelnet_tpu_torch.ops import anchors, voxelize


def _jax_prepare(points, num_points, spec, max_voxels, jit=True):
    fn = jax.vmap(lambda p, n: jax_vox._pallas_prepare(
        p, n, spec, max_voxels, layout="planar"))
    out = (jax.jit(fn) if jit else fn)(points, num_points)
    return [np.asarray(x) for x in out]


def _cases():
    rng = np.random.default_rng(0)
    jcfg, _ = configs()
    pts, n = random_points(rng, jcfg, 2, 1800)
    yield "random", pts, n, TINY
    # points on voxel boundaries (multiples of the voxel size), where a
    # reciprocal multiply would bin differently from the divide
    grid = np.stack(np.meshgrid(np.arange(0, 12.8, 0.2),
                                np.arange(-6.4, 6.4, 0.4),
                                np.arange(-3.0, 1.0, 0.4)), -1).reshape(-1, 3)
    edge = np.zeros((1, 2048, 4), np.float32)
    m = min(len(grid), 2048)
    edge[0, :m, :3] = grid[:m]
    yield "boundaries", edge, np.asarray([m], np.int32), TINY
    # more occupied voxels than max_voxels: the lowest ids are kept
    over = merged(TINY, data={"max_voxels": 64})
    yield "overflow", pts, n, over
    # one empty frame beside a full one
    empty_n = np.asarray([0, 1800], np.int32)
    yield "empty", pts, empty_n, TINY
    # dense clusters: many points per voxel, counts clipped at T
    dense = np.zeros((1, 2048, 4), np.float32)
    dense[0, :, :3] = rng.uniform([5.0, 0.0, -1.0], [5.4, 0.4, -0.6],
                                  (2048, 3))
    yield "crowded", dense, np.asarray([2048], np.int32), TINY


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_prepare_matches_jax(case):
    _, pts, n, overrides = case
    jcfg, tcfg = configs(overrides=overrides)
    jspec = jax_vox.VoxelGridSpec.from_object_config(jcfg.object)
    tspec = voxelize.VoxelGridSpec.from_object_config(tcfg.object)
    K = jcfg.data.max_voxels
    # Eager for points on voxel boundaries: under jit, XLA on the CPU turns
    # the divide by the constant voxel size into a reciprocal multiply and
    # bins 9 of 64 lattice points one voxel higher than numpy's
    # floor(x / s), the semantics both packages document (voxelize_np,
    # in_grid_mask); eager JAX keeps the divide.
    want = _jax_prepare(pts, n, jspec, K, jit=case[0] != "boundaries")
    got = voxelize.prepare(torch.from_numpy(pts), torch.from_numpy(n),
                           tspec, K)
    names = ("sorted_planar", "run_start", "counts", "coords", "num_voxels",
             "num_voxels_raw")
    for name, w, g in zip(names, want, got):
        assert g.dtype == (torch.float32 if name == "sorted_planar"
                           else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if case[0] == "overflow":
        assert (got.num_voxels_raw > got.num_voxels).all()
    if case[0] == "boundaries":
        host = jax_vox.voxelize_np(pts[0, :n[0]], jspec, K)
        np.testing.assert_array_equal(got.coords[0].numpy(), host.coords)
        np.testing.assert_array_equal(got.counts[0].numpy(), host.counts)
    if case[0] == "empty":
        assert int(got.num_voxels[0]) == 0 and int(got.counts[0].sum()) == 0


def test_host_helpers_match_jax():
    jcfg, tcfg = configs()
    rng = np.random.default_rng(3)
    pts, _ = random_points(rng, jcfg, 1, 2000)
    cloud = pts[0, :2000]
    jspec = jax_vox.VoxelGridSpec.from_object_config(jcfg.object)
    tspec = voxelize.VoxelGridSpec.from_object_config(tcfg.object)
    assert tuple(jspec) == tuple(tspec)
    np.testing.assert_array_equal(voxelize.in_grid_mask(cloud, tspec),
                                  jax_vox.in_grid_mask(cloud, jspec))
    for shuffle in (False, True):
        w = jax_vox.pad_points(cloud, 1024, np.random.default_rng(5), shuffle)
        g = voxelize.pad_points(cloud, 1024, np.random.default_rng(5),
                                shuffle)
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]


@pytest.mark.parametrize("class_name", ["Car", "Pedestrian"])
def test_anchors_match_jax(class_name):
    jcfg, tcfg = configs(class_name, overrides={})
    np.testing.assert_array_equal(anchors.anchors_flat(tcfg.object),
                                  jax_anchors.anchors_flat(jcfg.object))


def test_sample_frames_match_jax():
    from voxelnet_tpu.data.sample import sample_frames as jax_frames
    from voxelnet_tpu_torch.data.sample import sample_frames

    got, want = sample_frames(), jax_frames()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
