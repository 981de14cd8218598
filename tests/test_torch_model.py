"""The port's middle stack + RPN (models/middle.py, models/rpn.py,
models/bn_fold.py) against the flax modules at f32 on converted weights,
and the weight bridge (convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import TINY, configs, jax_variables, merged, torch_model
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu.models.bn_fold import fold_bn_variables
from voxelnet_tpu.models.middle import MiddleLayers
from voxelnet_tpu.models.rpn import RPN
from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.models.voxelnet import (VoxelNet,
                                                prepare_for_inference)

# a 10 x 32 x 32 grid keeps the conv stacks cheap on the CPU
SMALL = merged(TINY, object={"x_max": 6.4, "y_min": -3.2, "y_max": 3.2})


def _jax_logits(variables, dense, block1_stride, fold_bn):
    def run(v, x):
        p, s = v["params"], v["batch_stats"]
        bev = MiddleLayers(dtype=jnp.float32, fold_bn=fold_bn).apply(
            {"params": p["middle"], "batch_stats": s["middle"]}, x, False)
        return RPN(block1_stride=block1_stride, dtype=jnp.float32,
                   fold_bn=fold_bn).apply(
            {"params": p["rpn"], "batch_stats": s["rpn"]}, bev, False)

    v = fold_bn_variables(variables) if fold_bn else variables
    return [np.asarray(x) for x in jax.jit(run)(v, dense)]


@pytest.mark.parametrize("fold_bn", [True, False], ids=["fold", "nofold"])
@pytest.mark.parametrize("block1_stride", [2, 1])
def test_middle_rpn_logits_match_jax(fold_bn, block1_stride):
    overrides = merged(SMALL, rpn={"block1_stride": block1_stride})
    jcfg, tcfg = configs(overrides=overrides)
    variables = jax_variables(jcfg, seed=block1_stride)
    D, H, W = jcfg.object.grid_size
    rng = np.random.default_rng(block1_stride)
    dense = np.zeros((2, D, H, W, 128), np.float32)
    occupied = rng.random((2, D, H, W)) < 0.05
    dense[occupied] = rng.normal(0, 1, (int(occupied.sum()), 128))
    want_cls, want_reg = _jax_logits(variables, dense, block1_stride, fold_bn)

    net = prepare_for_inference(torch_model(tcfg, variables), fold_bn,
                                torch.float32)
    with torch.no_grad():
        cls, reg = net.rpn(net.middle(torch.from_numpy(dense)))
    assert cls.dtype == reg.dtype == torch.float32
    assert cls.shape == want_cls.shape and reg.shape == want_reg.shape
    # f32 through ~20 conv layers in two summation orders: the difference
    # measures up to 3.2e-6 of the logits' own spread; held to 1e-4 of it
    for got, want in ((cls.numpy(), want_cls), (reg.numpy(), want_reg)):
        spread = float(want.std())
        assert spread > 1e-2
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * spread)


def test_weight_bridge_round_trip():
    jcfg, tcfg = configs()
    variables = jax_variables(jcfg, seed=3)
    state = convert.from_jax_variables(variables)
    model = VoxelNet(tcfg)
    model.load_state_dict(state)          # strict: every key maps
    back = convert.to_jax_variables(model.state_dict())
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_npz_round_trip(tmp_path):
    jcfg, _ = configs()
    variables = jax_variables(jcfg, seed=4)
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, variables)
    back = convert.load_npz(path)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(variables)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("class_name", ["Car", "Pedestrian"])
def test_presets_convert(class_name):
    """Full-size presets: every flax leaf maps to a torch key of the same
    size (strict load)."""
    jcfg, tcfg = configs(class_name, overrides={})
    model = VoxelNet(tcfg)
    model.load_state_dict(convert.from_jax_variables(jax_variables(jcfg)))
    assert model.feature_net.points_per_voxel == jcfg.object.points_per_voxel
