"""The port's two kernel modules against the JAX package's Pallas kernels
run in interpret mode: the fused voxel-table + VFE (kernels/vfe_fused.py)
and the streaming dense-grid build (kernels/dense_build.py). On the CPU a
wrapper runs its plain torch version; tests/test_torch_cuda.py holds the
CUDA kernels against the plain versions on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, assert_bf16_close, configs,
                                jax_variables, merged, random_points,
                                torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu.kernels.vfe_fused import voxelize_vfe_fused
from voxelnet_tpu.models.scatter import scatter_to_dense_streamed
from voxelnet_tpu.ops.voxelize import VoxelGridSpec as JaxSpec
from voxelnet_tpu_torch.kernels import _build, dense_build, vfe_fused
from voxelnet_tpu_torch.ops import voxelize


def _vfe_inputs(seed, n, T, crowd):
    jcfg, tcfg = configs(overrides=merged(TINY, object={
        "points_per_voxel": T}))
    rng = np.random.default_rng(seed)
    pts, num = random_points(rng, jcfg, 2, n)
    # a crowded cluster of `crowd` points over 4 voxels of the lowest depth
    # slice (kept under the voxel cap, which keeps the lowest ids) so some
    # voxels hold T points
    pts[0, :crowd, :3] = rng.uniform([2.0, 1.0, -2.95], [2.4, 1.4, -2.65],
                                     (crowd, 3))
    return jcfg, tcfg, pts, num


def _folded(model):
    fln = model.feature_net
    return (*vfe_fused.fold_layer(fln.vfe1.fcn, fln.vfe1.bn, 8),
            *vfe_fused.fold_layer(fln.vfe2.fcn, fln.vfe2.bn, 32))


@pytest.mark.parametrize("seed,n,T,crowd", [
    pytest.param(0, 1800, 35, 300, id="0-1800"),
    pytest.param(1, 400, 35, 300, id="1-400"),
    # 100 points per voxel: a crowded voxel spans several warps' rows
    pytest.param(2, 1800, 100, 700, id="2-1800-T100"),
])
def test_vfe_plain_matches_pallas_interpret(seed, n, T, crowd):
    jcfg, tcfg, pts, num = _vfe_inputs(seed, n, T, crowd)
    variables = jax_variables(jcfg, seed)
    K = jcfg.data.max_voxels
    want, wcoords, wcounts = voxelize_vfe_fused(
        jnp.asarray(pts), jnp.asarray(num), JaxSpec.from_object_config(
            jcfg.object), K, variables["params"]["feature_net"],
        variables["batch_stats"]["feature_net"], interpret=True)

    spec = voxelize.VoxelGridSpec.from_object_config(tcfg.object)
    prep = voxelize.prepare(torch.from_numpy(pts), torch.from_numpy(num),
                            spec, K)
    model = torch_model(tcfg, variables)
    with torch.no_grad():
        got = vfe_fused.vfe_fused(
            prep.sorted_planar, prep.run_start, prep.num_voxels, prep.counts,
            *_folded(model), tcfg.object.points_per_voxel)
        via_module = model.feature_net(prep)
    assert got.dtype == torch.bfloat16 and got.shape == (2, K, 128)
    np.testing.assert_array_equal(prep.coords.numpy(), np.asarray(wcoords))
    np.testing.assert_array_equal(prep.counts.numpy(), np.asarray(wcounts))
    assert_bf16_close(got, np.asarray(want.astype(jnp.float32)))
    assert torch.equal(via_module, got)
    assert int((prep.counts == T).sum()) > 0


def _dense_case(rng, D, H, W, K, C, B, nv):
    feats = rng.normal(0, 1, (B, K, C)).astype(np.float32)
    feats = np.array(jnp.asarray(feats, jnp.bfloat16).astype(jnp.float32))
    coords = np.zeros((B, K, 3), np.int32)
    counts = np.zeros((B, K), np.int32)
    for b in range(B):
        ids = np.sort(rng.choice(D * H * W, nv[b], replace=False))
        coords[b, :nv[b]] = np.stack(
            [ids // (H * W), (ids // W) % H, ids % W], -1)
        counts[b, :nv[b]] = 1
    return feats, coords, counts


@pytest.mark.parametrize("grid,K,nv", [
    ((4, 16, 16), 64, (40, 0)),       # a frame and an empty frame
    ((1, 8, 16), 128, (128, 128)),    # every cell occupied
    ((10, 8, 12), 96, (96, 7)),       # a full K and a sparse frame
])
def test_dense_plain_matches_pallas_interpret(grid, K, nv):
    from voxelnet_tpu_torch.models.scatter import (
        scatter_to_dense_streamed as torch_streamed)

    rng = np.random.default_rng(sum(grid) + K)
    feats, coords, counts = _dense_case(rng, *grid, K, 128, 2, nv)
    want = scatter_to_dense_streamed(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(coords),
        jnp.asarray(counts), grid, interpret=True)
    got = torch_streamed(torch.from_numpy(feats).to(torch.bfloat16),
                         torch.from_numpy(coords), torch.from_numpy(counts),
                         grid)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _refuse_plain(monkeypatch):
    """Pretend the tensors are not CPU tensors and fail if a plain
    version runs: a wrapper given non-CPU tensors must launch or raise."""
    monkeypatch.setattr(_build, "on_cpu", lambda t: False)

    def boom(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")

    monkeypatch.setattr(vfe_fused, "vfe_fused_plain", boom)
    monkeypatch.setattr(dense_build, "dense_build_plain", boom)


def test_vfe_wrapper_raises_instead_of_falling_back(monkeypatch):
    _refuse_plain(monkeypatch)
    planar = torch.zeros(1, 4, 64)
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        vfe_fused.vfe_fused(planar, torch.zeros(1, 8, **i32),
                            torch.zeros(1, **i32), torch.zeros(1, 8, **i32),
                            torch.zeros(16, 8), torch.zeros(16, 3),
                            torch.zeros(64, 32), torch.zeros(64, 3), 35)
    assert vfe_fused.launches == 0


def test_dense_wrapper_raises_instead_of_falling_back(monkeypatch):
    _refuse_plain(monkeypatch)
    with pytest.raises(ValueError, match="CUDA"):
        dense_build.dense_build(torch.zeros(1, 8, 128, dtype=torch.bfloat16),
                                torch.zeros(1, 8, dtype=torch.int32), 64)
    assert dense_build.launches == 0
