"""The port's `sparse1` middle on the train path and the entry points: one
float64 train step against the JAX package's make_train_step with
middle_backend='sparse1', train.remat through the table path, and
make_inference_fn, make_train_step, make_eval_step and cli.train /
cli.predict with the dense-grid build made to fail, since sparse1 never
builds the 128-channel grid. On the CPU, where the kernel wrappers run
their plain versions."""

import os

import numpy as np
import pytest
import torch
from test_torch_train import (F64, REMAT, check_f64_step,
                              run_jax_f64_step)
from torch_port_helpers import (TINY, merged, random_points, step_batch,
                                write_mini_kitti)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.models import scatter
from voxelnet_tpu_torch.models.init import randomize_bn_
from voxelnet_tpu_torch.models.voxelnet import build_model, make_inference_fn
from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                    make_eval_step,
                                                    make_train_step)


SPARSE = {"data": {"middle_backend": "sparse1"}}


def test_one_train_step_matches_jax_in_float64():
    """test_torch_train.py's f64 step check, with sparse1 in both packages:
    loss, grad_norm, every updated param and batch_stat after one step.
    JAX's sparse_conv3x3 rounds block 1's f64 products to its f32
    accumulator; the port sums in f64 (as its f64 BN statistics), which is
    far inside the check's tolerances, set by the f32 BN statistics."""
    overrides = merged(F64, **SPARSE)
    check_f64_step(run_jax_f64_step(overrides), overrides)


def _remat_step(remat):
    cfg = get_config("Car", **merged(REMAT, train={"remat": remat},
                                     **SPARSE))
    model = randomize_bn_(build_model(cfg, seed=23),
                          torch.Generator().manual_seed(24))
    state = create_train_state(cfg, model, device="cpu")
    _, metrics = make_train_step(cfg, device="cpu")(
        state, step_batch(cfg, seed=23, n=1200))
    return ({k: float(v) for k, v in metrics.items()},
            state.model.state_dict())


def test_remat_recomputes_the_table_path_bit_for_bit():
    """train.remat 'seams' (the occupancy map and the middle recomputed in
    backward) and 'full' give 'none''s metrics, weights and BN running
    stats bit for bit under sparse1."""
    want, want_sd = _remat_step("none")
    for remat in ("seams", "full"):
        got, got_sd = _remat_step(remat)
        assert got == want, remat
        for k, v in want_sd.items():
            assert torch.equal(got_sd[k], v), (remat, k)


@pytest.fixture
def no_dense_grid(monkeypatch):
    """The dense-grid build raises while the fixture is on."""
    def refuse(*args, **kwargs):
        raise AssertionError("the 128-channel dense grid was built")

    monkeypatch.setattr(scatter, "dense_build_autograd", refuse)


CLI_CFG = """# TINY in f32 with sparse1 (an override file in the YAML subset)
object: {x_max: 12.8, y_min: -6.4, y_max: 6.4}
data:
  max_points: 2048
  max_voxels: 256
  max_gt_boxes: 8
  middle_backend: sparse1
train: {batch_size: 2, num_epochs: 1, compute_dtype: float32}
val: {batch_size: 2}
rpn: {score_thres: 0.0}
"""


def test_entry_points_never_build_the_grid(no_dense_grid, tmp_path, capsys):
    """make_inference_fn, make_train_step, make_eval_step, and cli.train
    (the Trainer: one epoch, a checkpoint, the val dumps) and cli.predict
    from an override file, all with sparse1 and the grid build refused;
    the conv3d path does reach it."""
    from voxelnet_tpu_torch.cli import predict as predict_cli
    from voxelnet_tpu_torch.cli import train as train_cli

    cfg = get_config("Car", **merged(TINY, rpn={"score_thres": 0.0},
                                     **SPARSE))
    model = build_model(cfg, seed=3)
    points, num = random_points(np.random.default_rng(3), cfg, 2, 1500)
    det = make_inference_fn(cfg, "cpu")(model, points, num)
    assert det.valid.sum() > 0
    state = create_train_state(cfg, model, device="cpu")
    batch = step_batch(cfg, seed=3, n=1500)
    state, metrics = make_train_step(cfg, device="cpu")(state, batch)
    assert np.isfinite([float(v) for v in metrics.values()]).all()
    metrics, _, _ = make_eval_step(cfg, device="cpu")(state, batch)
    assert np.isfinite([float(v) for v in metrics.values()]).all()
    with pytest.raises(AssertionError, match="dense grid was built"):
        make_inference_fn(get_config("Car", **TINY), "cpu")(
            build_model(get_config("Car", **TINY)), points, num)

    data = write_mini_kitti(str(tmp_path / "kitti"))
    (tmp_path / "cfg.yaml").write_text(CLI_CFG)
    exp = str(tmp_path / "exp")
    train_cli.main(["--data-dir", data, "--exp-dir", exp, "--device", "cpu",
                    "--cfg", str(tmp_path / "cfg.yaml"),
                    "--print-interval", "1"])
    assert "Epoch 1 time" in capsys.readouterr().out
    assert os.listdir(exp + "/checkpoints") == ["0"]
    assert sorted(os.listdir(exp + "/preds/1/data")) == [
        "000000.txt", "000001.txt"]
    predict_cli.main(["--pcl", data + "/validation/velodyne/000000.bin",
                      "--checkpoint", exp + "/checkpoints", "--cfg",
                      str(tmp_path / "cfg.yaml"), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[0].endswith("detections")
