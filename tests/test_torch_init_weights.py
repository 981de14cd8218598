"""The learning run's `--init-weights` (voxelnet_tpu_torch/tools/
synthetic_smoke.py): the port started from the JAX script's own initial
state (`tests/torch_jax_init.py`: `create_train_state(cfg, tx,
jax.random.key(0))`) takes the JAX script's first step, and a file that
does not fit the run's config is refused.

The grid is as small as tests/conftest.py's tiny one (10 x 64 x 128
voxels), in f32, placed where the first batch's frames hold three cars.
Tolerance of the first step: loss and its parts within rel 1e-4 of
JAX's, the gradient norm (3.6e3, before the clip) within rel 3e-3;
measured 5e-5 and 1.2e-3. Both run f32 sums in another order, and
XLA:CPU sums the f32 BatchNorm statistics in sequence (ROADMAP.md "Known
differences"); a weight that crossed wrongly moves the loss by far more.
"""

import os
import sys

import numpy as np
import pytest
import torch

from voxelnet_tpu_torch.tools import synthetic_smoke as tool

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_jax_init  # noqa: E402
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

# a small f32 grid over three cars of the first batch
TINY_YAML = """object: {x_min: 16.0, x_max: 41.6, y_min: -16.0, y_max: -3.2}
data: {max_points: 2048, max_voxels: 256, max_gt_boxes: 8}
train: {compute_dtype: float32}
"""
BATCH = 2


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(cfg file, .npz of the JAX script's initial state at that cfg,
    (JAX config, that state, its optimizer))."""
    root = tmp_path_factory.mktemp("init")
    cfg_file = root / "tiny.yaml"
    cfg_file.write_text(TINY_YAML)
    npz = str(root / "jax_init.npz")
    jcfg = torch_jax_init.jax_script_config("Car", str(cfg_file))
    state, tx = torch_jax_init.jax_script_state(jcfg)
    torch_jax_init.save_state_npz(npz, state, "Car", str(cfg_file))
    return str(cfg_file), npz, (jcfg, state, tx)


def test_first_step_from_jax_init_is_the_jax_scripts(tiny):
    import jax
    import jax.numpy as jnp

    from voxelnet_tpu.training import make_train_step as jax_train_step
    from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                        make_train_step)

    cfg_file, npz, (jcfg, jstate, tx) = tiny
    # the JAX script: its config, key(0) state, first batch of its frames
    cfg = tool.make_config("Car", cfg_file=cfg_file)
    batch = tool.Frames(cfg).batch(BATCH)
    keys = ("points", "num_points", "gt_boxes", "gt_mask")
    _, want = jax_train_step(jcfg, tx)(
        jstate, {k: jnp.asarray(getattr(batch, k)) for k in keys})
    want = jax.tree.map(float, want)

    # the port: --init-weights' model, the run's optimizer and step
    opt = tool.make_optimizer(cfg, 0.005, 1)
    state = create_train_state(cfg, tool.load_init_weights(cfg, npz),
                               device="cpu", optimizer=opt)
    _, got = make_train_step(cfg, "cpu", optimizer=opt)(
        state, {k: torch.as_tensor(getattr(batch, k)) for k in keys})
    assert want["grad_norm"] > cfg.train.gradient_clip  # the clip binds
    assert want["reg_loss"] > 0            # cars in the grid
    for key in ("loss", "cls_loss", "reg_loss"):
        assert float(got[key]) == pytest.approx(want[key], rel=1e-4), key
    assert float(got["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                    rel=3e-3)


def test_main_takes_init_weights(tiny, capsys):
    cfg_file, npz, _ = tiny
    out = tool.main(["--steps", "2", "--frames", "4", "--eval-frames", "2",
                     "--batch", "2", "--device", "cpu", "--cfg", cfg_file,
                     "--init-weights", npz])
    assert out["steps"] == 2 and set(out["ap"]) == {
        "AP@0.5 bev", "AP@0.5 3d", "AP@0.7 bev", "AP@0.7 3d"}
    assert "steps/s" in capsys.readouterr().out
    with pytest.raises(SystemExit):        # one init or the other
        tool.main(["--init-seed", "1", "--init-weights", npz])


def test_init_weights_that_do_not_fit_are_refused(tiny, tmp_path):
    from voxelnet_tpu_torch import convert

    cfg_file, npz, _ = tiny
    cfg = tool.make_config("Car", cfg_file=cfg_file)
    # another yaw encoding, another score gate: the decode knobs differ
    with pytest.raises(ValueError, match="yaw_encoding"):
        tool.load_init_weights(
            tool.make_config("Car", yaw_encoding="sin", cfg_file=cfg_file),
            npz)
    with pytest.raises(ValueError, match=r"decode knobs differ.*\['rpn'\]"):
        tool.load_init_weights(
            tool.make_config("Car", score_thres=0.3, cfg_file=cfg_file), npz)
    # the same knobs, but a tensor of another shape (a 15-point voxel VFE)
    variables = convert.load_npz(npz)
    kernel = variables["params"]["feature_net"]["vfe1"]["fcn"]["kernel"]
    variables["params"]["feature_net"]["vfe1"]["fcn"]["kernel"] = np.zeros(
        (kernel.shape[0] + 1, kernel.shape[1]), np.float32)
    bad = str(tmp_path / "bad.npz")
    convert.save_npz(bad, variables, cfg)
    with pytest.raises(ValueError, match="does not fit the run's model"):
        tool.load_init_weights(cfg, bad)
    # a file without knobs loads, with load_npz's warning
    plain = str(tmp_path / "plain.npz")
    convert.save_npz(plain, convert.load_npz(npz))
    with pytest.warns(UserWarning, match="no decode knobs"):
        tool.load_init_weights(cfg, plain)
