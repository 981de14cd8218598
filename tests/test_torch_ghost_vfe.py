"""`compat.bn_over_padding`, the reference's ghost-activation VFE, against
the JAX package on the CPU: the table VFE in eval and train mode (BN
statistics over every slot, unmasked maxima) against flax
`FeatureLearningNet(bn_over_padding=True)`, and inference with the flag
(run-copy table + table VFE, no fused kernel) against the JAX inference
function, which takes its XLA path for the flag."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, configs, jax_variables, merged,
                                random_points, step_batch, torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.config import get_config, resolve_plan
from voxelnet_tpu_torch.models.vfe import FeatureLearningNet
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, voxelize_table

GHOST = merged(TINY, compat={"bn_over_padding": True})
# The ghost BN's statistics run over every slot, padding included, and
# XLA:CPU sums flax's f32 statistics in sequence: off the f64 result by
# 1.3e-4 of the largest output on step_batch's table (2 x 256 x 35 slots,
# 97% padding) and by 3.6e-5 on a filled table of that size, against the
# port's 3e-6 and 2e-6 (measured). So the parity test holds JAX on a
# small filled table (2 x 32 x 35 slots, 1024 and 800 points over 4 x 8
# voxels of one layer), as the step tests use a denser grid, and the
# port's f32 ghost VFE is held to its f64 self on step_batch's table.
FILLED = merged(GHOST, data={"max_voxels": 32})


def _table(cfg, seed, filled):
    """(features, counts) of the run-copy table of 2 frames: a filled
    table, or step_batch's random points (mostly padding slots)."""
    if filled:
        rng = np.random.default_rng(seed)
        points = np.zeros((2, cfg.data.max_points, 4), np.float32)
        points[:, :1024, :3] = rng.uniform([5.01, 0.01, -0.99],
                                           [5.79, 1.59, -0.61], (2, 1024, 3))
        points[:, :1024, 3] = rng.uniform(0, 1, (2, 1024))
        num = np.asarray([1024, 800], np.int32)
    else:
        batch = step_batch(cfg, seed=seed)
        points, num = batch["points"], batch["num_points"]
    vox = voxelize_table(torch.from_numpy(points), torch.from_numpy(num),
                         VoxelGridSpec.from_object_config(cfg.object),
                         cfg.data.max_voxels)
    return vox.features, vox.counts


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ghost_vfe_matches_flax(train):
    """Outputs, and in train mode the updated batch_stats, of flax
    FeatureLearningNet(bn_over_padding=True) at f32, at the tolerances of
    test_train_mode_vfe_matches_flax, on a filled table; the masked VFE
    gives other numbers on the same inputs."""
    from voxelnet_tpu.models.vfe import FeatureLearningNet as JaxVFE

    jcfg, tcfg = configs(overrides=FILLED)
    variables = jax_variables(jcfg, seed=7)
    features, counts = _table(tcfg, 7, filled=True)
    assert float(counts.sum()) / counts.numel() / 35 > 0.75
    feats, counts = features.numpy(), counts.numpy()
    want, upd = JaxVFE(dtype=jnp.float32, bn_over_padding=True).apply(
        {"params": variables["params"]["feature_net"],
         "batch_stats": variables["batch_stats"]["feature_net"]},
        feats, counts, train, mutable=["batch_stats"])

    model = torch_model(tcfg, variables).train(train)
    assert model.feature_net.bn_over_padding
    features, counts = torch.from_numpy(feats), torch.from_numpy(counts)
    got = model.feature_net.table(features, counts,
                                  torch.float32).detach().numpy()
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    # the ghost semantics differ from the masked ones on these inputs
    masked = FeatureLearningNet(tcfg.object.points_per_voxel)
    masked.load_state_dict(model.feature_net.state_dict())
    masked.train(train)
    other = masked.table(features, counts, torch.float32).detach().numpy()
    assert np.abs(other - want).max() > 1e-2
    got_stats = _leaves(convert.to_jax_variables(
        model.state_dict())["batch_stats"]["feature_net"])
    want_stats = _leaves(upd["batch_stats"])
    old = _leaves(variables["batch_stats"]["feature_net"])
    for path, leaf in got_stats.items():
        np.testing.assert_allclose(leaf, want_stats[path], rtol=1e-5,
                                   atol=1e-6, err_msg=path)
        assert (np.abs(leaf - old[path]).max() > 1e-4) == train, path


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ghost_vfe_in_f32_matches_f64_on_a_padded_table(train):
    """On a table of 97% padding slots, the port's f32 ghost VFE against
    itself in f64 (f64 statistics): within 2e-5 of the largest output."""
    jcfg, tcfg = configs(overrides=GHOST)
    variables = jax_variables(jcfg, seed=7)
    features, counts = _table(tcfg, 7, filled=False)
    assert float(counts.sum()) / counts.numel() / 35 < 0.05
    got = torch_model(tcfg, variables).train(train).feature_net.table(
        features, counts, torch.float32).detach()
    exact = torch_model(tcfg, variables).train(train).double().feature_net \
        .table(features.double(), counts, torch.float64).detach()
    torch.testing.assert_close(got.double(), exact, rtol=0,
                               atol=2e-5 * float(exact.abs().max()))


def test_ghost_inference_matches_jax(monkeypatch):
    """make_inference_fn with the flag against the JAX inference function
    (its XLA VFE path) at the tiny f32 grid: detections compared by score
    and box, not by slot, at test_whole_slice_matches_jax's tolerances.
    The fused VFE is not called."""
    from voxelnet_tpu.models.voxelnet import make_inference_fn as jax_fn
    from voxelnet_tpu_torch.models.voxelnet import make_inference_fn

    def no_fused(*args):
        raise AssertionError("the fused VFE ran with bn_over_padding")

    monkeypatch.setattr(FeatureLearningNet, "forward", no_fused)
    jcfg, tcfg = configs(overrides=merged(GHOST, rpn={"score_thres": 0.0}))
    variables = jax_variables(jcfg, seed=11)
    rng = np.random.default_rng(11)
    points, num = random_points(rng, jcfg, 2, 1800)
    num[1] = 900
    want = jax.jit(jax_fn(jcfg, platform="cpu"))(variables, points, num)
    got = make_inference_fn(tcfg, "cpu")(torch_model(tcfg, variables),
                                         points, num)
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    assert got.valid.sum() >= 20
    for b in range(2):
        wv, gv = np.asarray(want.valid[b]), got.valid[b].numpy()
        w_scores = np.asarray(want.scores[b])[wv]
        g_scores = got.scores[b].numpy()[gv]
        wo, go = np.argsort(-w_scores), np.argsort(-g_scores)
        np.testing.assert_allclose(g_scores[go], w_scores[wo], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy()[gv][go],
                                   np.asarray(want.boxes[b])[wv][wo],
                                   rtol=0, atol=1e-4)


def test_ghost_vfe_resolves_to_the_table_path():
    """'auto' and 'xla' take the table VFE with the flag; 'fused' is
    refused with the JAX resolver's message; the fused forward refuses
    the flag."""
    for backend in ("auto", "xla"):
        resolve_plan(get_config("Car", **merged(
            GHOST, data={"vfe_backend": backend})))
    with pytest.raises(ValueError, match="use the 'xla' backend"):
        resolve_plan(get_config("Car", **merged(
            GHOST, data={"vfe_backend": "fused"})))
    net = FeatureLearningNet(35, bn_over_padding=True).eval()
    with pytest.raises(NotImplementedError, match="masked max only"):
        net(None)


def test_inference_refuses_a_model_of_the_other_vfe():
    from voxelnet_tpu_torch.models.voxelnet import (build_model,
                                                    make_inference_fn)

    ghost = get_config("Car", **GHOST)
    plain = get_config("Car", **TINY)
    points = np.zeros((1, 2048, 4), np.float32)
    num = np.zeros((1,), np.int32)
    for model_cfg, infer_cfg in ((plain, ghost), (ghost, plain)):
        with pytest.raises(ValueError, match="bn_over_padding"):
            make_inference_fn(infer_cfg, "cpu")(build_model(model_cfg),
                                                points, num)
