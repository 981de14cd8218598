"""The run-copy voxel table (kernels/run_copy.py), the explicit voxel table
(ops/voxelize.voxelize_table) and the dense grid's gradient
(kernels/dense_build.dense_build_autograd) against the JAX package: its
three Pallas run-copy kernels and `dense_build_pallas`'s VJP, in interpret
mode. On the CPU the wrappers run their plain torch versions;
tests/test_torch_cuda.py holds the CUDA kernels against those on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import configs, random_points
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu.kernels.dense_build import dense_build_pallas
from voxelnet_tpu.kernels.voxelize_pallas import (build_voxel_table,
                                                  build_voxel_table_planar,
                                                  build_voxel_table_planar_t)
from voxelnet_tpu.ops.voxelize import VoxelGridSpec as JaxSpec
from voxelnet_tpu.ops.voxelize import (dequantize_points_i16,
                                       quantize_points_i16,
                                       voxelize_batch_jax)
from voxelnet_tpu_torch.kernels import _build, dense_build, run_copy
from voxelnet_tpu_torch.ops import voxelize


def _frames(case: str):
    """(jax cfg, port cfg, points (2, N, 4), num (2,)) at the tiny grid
    (K = 256 voxel slots, T = 35):
      dense   - ~1900 occupied voxels per frame, far over max_voxels;
      crowded - a 600-point cluster in a few voxels of the lowest depth
                slice (kept under the cap): runs far longer than T;
      sparse  - 60 and 0 points: most slots empty (run start N)."""
    jcfg, tcfg = configs()
    rng = np.random.default_rng({"dense": 0, "crowded": 1, "sparse": 2}[case])
    if case == "sparse":
        pts, num = random_points(rng, jcfg, 2, 60)
        num[1] = 0
    else:
        pts, num = random_points(rng, jcfg, 2, 1900)
    if case == "crowded":
        pts[:, :600, :3] = rng.uniform([2.0, 1.0, -2.95], [2.5, 1.5, -2.65],
                                       (2, 600, 3))
    return jcfg, tcfg, pts, num


def _prepared(tcfg, pts, num):
    spec = voxelize.VoxelGridSpec.from_object_config(tcfg.object)
    return voxelize.prepare(torch.from_numpy(pts), torch.from_numpy(num),
                            spec, tcfg.data.max_voxels)


@pytest.mark.parametrize("case", ["dense", "crowded", "sparse"])
def test_run_copy_plain_matches_all_three_pallas_layouts(case):
    """Bit-equal to the rows, slot-stride and voxel-major Pallas run-copy
    kernels (each brought to (B, K, T, 4)), on the same sorted stream."""
    jcfg, tcfg, pts, num = _frames(case)
    prep = _prepared(tcfg, pts, num)
    K, T = tcfg.data.max_voxels, tcfg.object.points_per_voxel
    got = run_copy.run_copy(prep.sorted_planar, prep.run_start, T).numpy()
    assert got.shape == (2, K, T, 4) and got.dtype == np.float32

    planar = jnp.asarray(prep.sorted_planar.numpy())
    rows = jnp.transpose(planar, (0, 2, 1))
    starts = jnp.asarray(prep.run_start.numpy())
    want_rows = build_voxel_table(rows, starts, K, T, interpret=True)
    want_planar = build_voxel_table_planar(rows, starts, K, T,
                                           interpret=True)
    want_t = build_voxel_table_planar_t(planar, starts, K, T,
                                        interpret=True)[:, :, :T, :]
    np.testing.assert_array_equal(got, np.asarray(want_rows))
    np.testing.assert_array_equal(got, np.asarray(want_planar))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.transpose(want_t, (0, 3, 2, 1))))

    counts = prep.counts.numpy()
    if case == "crowded":
        assert (counts == T).sum() >= 5
    if case == "dense":
        assert (prep.num_voxels_raw.numpy() > K).all()
    if case == "sparse":
        assert int(prep.num_voxels[1]) == 0
        assert not got[1].any()


@pytest.mark.parametrize("case", ["dense", "crowded", "sparse"])
def test_voxelize_table_matches_jax(case):
    """Integers exactly; features within 1e-6 (the centroid's f32 sum in
    another order)."""
    jcfg, tcfg, pts, num = _frames(case)
    spec = voxelize.VoxelGridSpec.from_object_config(tcfg.object)
    got = voxelize.voxelize_table(torch.from_numpy(pts),
                                  torch.from_numpy(num), spec,
                                  tcfg.data.max_voxels)
    want = voxelize_batch_jax(jnp.asarray(pts), jnp.asarray(num),
                              JaxSpec.from_object_config(jcfg.object),
                              jcfg.data.max_voxels, "pallas_interpret")
    for name in ("coords", "counts", "num_voxels", "num_voxels_raw"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.features.shape == want.features.shape
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features), rtol=0, atol=1e-6)


def test_dequantize_points_i16_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-60, 60, (2, 64, 4)).astype(np.float32)
    pts[..., 3] = rng.uniform(0, 1, (2, 64))
    q = quantize_points_i16(pts)
    got = voxelize.dequantize_points_i16(torch.from_numpy(q))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(dequantize_points_i16(q)))
    f32 = torch.from_numpy(pts)
    assert voxelize.dequantize_points_i16(f32) is f32


def _dense_rows(rng, n_cells, K, C, nv):
    ids = np.full((2, K), n_cells, np.int32)
    for b in range(2):
        ids[b, :nv[b]] = np.sort(rng.choice(n_cells, nv[b], replace=False))
    feat = rng.normal(0, 1, (2, K, C)).astype(np.float32)
    return feat, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid,K,nv", [((4, 16, 16), 64, (40, 0)),
                                       ((1, 8, 16), 128, (128, 128))])
def test_dense_gradient_matches_jax_vjp(dtype, grid, K, nv):
    """The forward and the row-gather backward both exactly equal to
    `dense_build_pallas` and its custom VJP (interpret mode)."""
    rng = np.random.default_rng(K)
    n = int(np.prod(grid))
    feat, ids = _dense_rows(rng, n, K, 128, nv)
    cot = rng.normal(0, 1, (2, n, 128)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    want, vjp = jax.vjp(lambda f: dense_build_pallas(
        f, jnp.asarray(ids), n, interpret=True), jnp.asarray(feat, jdt))
    (want_grad,) = vjp(jnp.asarray(cot, jdt))

    x = torch.from_numpy(feat).to(tdt).requires_grad_()
    out = dense_build.dense_build_autograd(x, torch.from_numpy(ids), n)
    out.backward(torch.from_numpy(cot).to(tdt))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(want_grad.astype(jnp.float32)))
    if nv[0] < K:       # padding rows get exactly zero
        assert not x.grad[0, nv[0]:].any()


def test_run_copy_wrapper_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(_build, "on_cpu", lambda t: False)

    def boom(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")

    monkeypatch.setattr(run_copy, "run_copy_plain", boom)
    with pytest.raises(ValueError, match="CUDA"):
        run_copy.run_copy(torch.zeros(1, 4, 64),
                          torch.zeros(1, 8, dtype=torch.int32), 35)
    assert run_copy.launches == 0
