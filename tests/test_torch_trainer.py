"""The port's trainer slice on the CPU: checkpoint retention against the
JAX package's Orbax manager, restore and its decode-knob check, one epoch
of the port's Trainer against one of the JAX Trainer from the same
weights, bit-equal resume, the staging thread's stop on a mid-epoch
error, the refusals, and the train -> resume -> eval -> predict CLIs end to
end at a small grid."""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, configs, init_scale_biases,
                                jax_variables, merged, write_mini_kitti)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.models.voxelnet import build_model
from voxelnet_tpu_torch.training import checkpoint as ckpt_lib
from voxelnet_tpu_torch.training.optim import OptState
from voxelnet_tpu_torch.training.train_step import TrainState
from voxelnet_tpu_torch.training.trainer import Stager, Trainer

QUIET = dict(print_interval=1000, summary_interval=1000, val_interval=1000)
# a 10 x 32 x 32 grid around the fixture's Car, a quarter of TINY's cells:
# these tests train whole epochs on the CPU
SMALL = merged(TINY, object={"x_min": 3.2, "x_max": 9.6, "y_min": -3.2,
                             "y_max": 3.2})


def _state_dict(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _live_pipeline_threads():
    return [t for t in threading.enumerate() if t.is_alive() and (
        t.name == "batch-staging" or t.name.startswith("batch-worker"))]


# --- checkpoints ------------------------------------------------------------

SAVES = {
    "mixed": [{"val_loss": 3.0}, {"val_loss": 1.0}, {"val_loss": 2.0}, {},
              {"val_loss": 1.0}, {"val_loss": 0.5}, {"val_loss": 5.0}],
    "sparse": [{}, {}, {"val_loss": 2.0}, {}],
    "ties": [{"val_loss": 1.0}, {"val_loss": 1.0}, {"val_loss": 1.0}],
}


@pytest.mark.parametrize("keep", [1, 2, 3])
@pytest.mark.parametrize("saves", list(SAVES))
def test_checkpoint_retention_matches_orbax(tmp_path, keep, saves):
    """After every save: the steps kept, latest_step, best_step and
    best_metric of the port's manager equal the JAX (Orbax) manager's;
    and again from a new manager on each directory."""
    from voxelnet_tpu.training.checkpoint import CheckpointManager as JaxMgr

    cfg = get_config("Car")
    jmgr = JaxMgr(str(tmp_path / "jax"), keep=keep)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "port"), keep=keep,
                                     config=cfg)
    model = torch.nn.Linear(2, 2)

    def view(m, root):
        steps = sorted(int(d) for d in os.listdir(root) if d.isdigit())
        return steps, m.latest_step(), m.best_step(), m.best_metric()

    for step, metrics in enumerate(SAVES[saves]):
        jmgr.save(step, {"w": np.zeros(2, np.float32)}, metrics)
        mgr.save(step, TrainState(step, model, OptState(step)), metrics)
        assert view(mgr, tmp_path / "port") == view(jmgr, tmp_path / "jax")
    jmgr.close()
    again = ckpt_lib.CheckpointManager(str(tmp_path / "port"), config=cfg)
    jagain = JaxMgr(str(tmp_path / "jax"))
    assert view(again, tmp_path / "port") == view(jagain, tmp_path / "jax")
    jagain.close()


def test_checkpoint_restore_is_bit_equal_and_checks_yaw(tmp_path):
    cfg = get_config("Car", **TINY)
    model = build_model(cfg, seed=1)
    for p in model.parameters():        # not the init of seed 2 below
        p.data.add_(0.25)
    os.makedirs(tmp_path / "ck" / ".tmp-9-123")   # a killed save's leftover
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ck"), config=cfg)
    mgr.save(4, TrainState(9, model, OptState(7)), {"val_loss": 1.5})
    assert sorted(os.listdir(tmp_path / "ck")) == ["4"]
    with pytest.raises(FileExistsError):
        mgr.save(4, TrainState(9, model, OptState(7)))

    state = TrainState(0, build_model(cfg, seed=2), OptState(0))
    ckpt_lib.CheckpointManager(str(tmp_path / "ck"), config=cfg).restore(
        state)
    assert state.step == 9 and state.opt_state == OptState(7)
    want = model.state_dict()
    for k, v in state.model.state_dict().items():
        assert v.dtype == want[k].dtype
        assert torch.equal(v, want[k]), k
    loaded = ckpt_lib.load_variables(str(tmp_path / "ck"), cfg)
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    assert ckpt_lib.load_variables(str(tmp_path / "ck" / "4"), cfg).keys() \
        == want.keys()
    saved = torch.load(tmp_path / "ck" / "4" / "state.pt", weights_only=True)
    assert saved["decode"]["yaw_encoding"] == "delta"
    assert saved["config"] == cfg.to_dict()

    sin = get_config("Car", **merged(TINY, train={"yaw_encoding": "sin"}))
    with pytest.raises(ValueError, match="yaw_encoding"):
        ckpt_lib.CheckpointManager(str(tmp_path / "ck"), config=sin).restore(
            state)
    with pytest.raises(ValueError, match="yaw_encoding"):
        ckpt_lib.load_variables(str(tmp_path / "ck"), sin)
    with pytest.raises(FileNotFoundError):
        ckpt_lib.load_variables(str(tmp_path / "none"), cfg)


# --- the trainer against the JAX trainer ----------------------------------

# f64 compute (flax's BatchNorms take f32 statistics, the port's f64), f32
# points off the 5 mm lattice (the jitted JAX voxelizer bins lattice points
# by a reciprocal multiply), 2048 voxel slots as in test_torch_train.py's
# f64 step, and lr 1e-4: this untrained net's gradient norm is ~1.5e3, so
# at lr 1e-2 the ~4% update difference of step 1 (f32 BN statistics summed
# in another order, on the sparser TINY grid) moves step 2's loss by ~0.5%
# and its update by ~50%
TRAINER_F64 = merged(SMALL, train={"compute_dtype": "float64",
                                  "num_epochs": 1, "num_workers": 2,
                                  "upload_points": "f32", "lr": 1e-4},
                     data={"max_voxels": 2048, "max_points": 8192})


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_trainer_matches_jax_trainer_after_one_epoch(tmp_path):
    """One epoch (2 steps, epoch-end validation, checkpoint) of each
    trainer from the same weights, set on the JAX Trainer's state and
    converted onto the port's: the same val loss and best step, the same
    step count, and the same weights and batch_stats.

    Tolerances, with the gaps measured on these inputs: val loss 1e-5
    relative (3e-7); the whole update (new minus initial params) 5% of its
    L2 norm (0.5%); each leaf 10% of its update's largest element plus 4
    f32 ulps of its largest weight (7% at most: f32 params round updates
    of a few ulps); batch_stats 1e-5 absolute (4.8e-7)."""
    from voxelnet_tpu.training.trainer import Trainer as JaxTrainer

    data = write_mini_kitti(str(tmp_path / "kitti"), n_points=8000)
    jcfg, tcfg = configs(overrides=TRAINER_F64)
    init = init_scale_biases(jax_variables(jcfg, seed=4), 4)
    jax.config.update("jax_enable_x64", True)
    try:
        with JaxTrainer(jcfg, data + "/training", data + "/validation",
                        exp_dir=str(tmp_path / "jax")) as jt:
            jt.state = jt.state.replace(params=init["params"],
                                        batch_stats=init["batch_stats"])
            jt.train(dump_val_labels=False, **QUIET)
            want = jax.tree.map(np.asarray, {
                "params": jt.state.params, "batch_stats": jt.state.batch_stats})
            want_val, want_best = jt.ckpt.best_metric(), jt.ckpt.best_step()
            want_step = int(jt.state.step)
    finally:
        jax.config.update("jax_enable_x64", False)

    with Trainer(tcfg, data + "/training", data + "/validation",
                 exp_dir=str(tmp_path / "port"), device="cpu") as tr:
        tr.state.model.load_state_dict(convert.from_jax_variables(init))
        tr.train(dump_val_labels=False, **QUIET)
        got = convert.to_jax_variables(tr.state.model.state_dict())
        assert tr.ckpt.best_step() == want_best == 0
        assert tr.state.step == tr.state.opt_state.count == want_step == 2
        assert tr.ckpt.best_metric() == pytest.approx(want_val, rel=1e-5)

    before = _leaves(init["params"])
    got_p, want_p = _leaves(got["params"]), _leaves(want["params"])
    assert got_p.keys() == want_p.keys()
    diff = sum(((got_p[k] - want_p[k]) ** 2).sum() for k in want_p)
    update = sum(((want_p[k] - before[k]) ** 2).sum() for k in want_p)
    assert np.sqrt(diff) <= 0.05 * np.sqrt(update)
    for k, w in want_p.items():
        ulp = np.spacing(np.float32(np.abs(before[k]).max()))
        assert np.abs(got_p[k] - w).max() <= (
            0.1 * np.abs(w - before[k]).max() + 4 * ulp), k
    got_s, want_s = _leaves(got["batch_stats"]), _leaves(want["batch_stats"])
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=0, atol=1e-5,
                                   err_msg=k)


# --- resume, stager, refusals -----------------------------------------------

# the LR drops 10x after the first epoch (2 steps), inside the resumed one
RESUME = merged(SMALL, train={"num_epochs": 2, "num_workers": 3,
                             "lr_scheduler_step": 1, "augment": True},
                val={"batch_size": 2})


def test_resume_is_bit_equal(tmp_path, capsys):
    """2 epochs in one run == 1 epoch, then --resume for the second:
    weights and BN stats bit-equal, the step and LR-schedule count, the
    data order (seed + epoch: augmented examples differ by epoch) and the
    best val loss carried over."""
    data = write_mini_kitti(str(tmp_path / "kitti"))
    cfg2 = get_config("Car", **RESUME)
    cfg1 = get_config("Car", **merged(RESUME, train={"num_epochs": 1}))
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        def run(cfg, exp, resume=None):
            with Trainer(cfg, data + "/training", data + "/validation",
                         exp_dir=str(tmp_path / exp), resume_from=resume,
                         device="cpu") as tr:
                tr.train(dump_val_labels=False, **QUIET)
                out = capsys.readouterr().out
                return tr, _state_dict(tr.state.model), out

        whole, want, out2 = run(cfg2, "whole")
        _, _, out1 = run(cfg1, "first")
        resumed, got, out_r = run(cfg2, "second",
                                  str(tmp_path / "first" / "checkpoints"))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert resumed.start_epoch == 1
    assert resumed.state.step == whole.state.step == 4
    assert resumed.state.opt_state == whole.state.opt_state == OptState(4)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    def epoch_line(out, n):
        line = [x for x in out.splitlines() if x.startswith(f"Epoch {n} ")]
        return line[0].split("s avg_val_loss ")[1]

    assert epoch_line(out1, 1) == epoch_line(out2, 1)
    assert epoch_line(out_r, 2) == epoch_line(out2, 2)
    assert resumed._resume_min_loss == pytest.approx(
        float(epoch_line(out1, 1).split()[0]), abs=1e-4)


@pytest.mark.parametrize("thread", [True, False], ids=["thread", "inline"])
def test_stager_stops_after_a_mid_epoch_error(tmp_path, thread):
    """The step raises on its third batch: the error reaches the caller,
    and no staging thread or pipeline worker is alive 5 s later, with
    the queues full behind the error; with the staging thread and with
    train.staging_thread=False."""
    data = write_mini_kitti(str(tmp_path / "kitti"),
                            splits=(("training", 12), ("validation", 1)))
    cfg = get_config("Car", **merged(
        SMALL, train={"batch_size": 1, "num_workers": 3, "staging_depth": 1,
                     "staging_thread": thread}))
    with Trainer(cfg, data + "/training", data + "/validation",
                 exp_dir=str(tmp_path / "exp"), device="cpu") as tr:
        calls = []

        def step(state, batch):
            calls.append(1)
            if len(calls) == 3:
                time.sleep(0.3)          # let the pipeline fill up
                raise RuntimeError("step failed")
            return state, {}

        tr.train_step = step
        with pytest.raises(RuntimeError, match="step failed"):
            tr.train(**QUIET)
    deadline = time.monotonic() + 5.0
    while _live_pipeline_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _live_pipeline_threads()


def test_debug_nans_stops_at_a_non_finite_step(tmp_path):
    data = write_mini_kitti(str(tmp_path / "kitti"),
                            splits=(("training", 4), ("validation", 1)))
    cfg = get_config("Car", **merged(SMALL, train={"debug_nans": True}))
    with Trainer(cfg, data + "/training", data + "/validation",
                 exp_dir=str(tmp_path / "exp"), device="cpu") as tr:
        tr.train_step = lambda state, batch: (
            state, {"loss": torch.tensor(float("nan"))})
        with pytest.raises(FloatingPointError, match="non-finite"):
            tr.train(**QUIET)


def test_stager_close_stops_an_endless_source():
    def endless():
        while True:
            yield {}

    stager = Stager(endless(), lambda b: b, depth=2)
    next(stager)
    time.sleep(0.1)                      # the thread blocks on a full queue
    stager.close(timeout=5.0)
    assert not stager._thread.is_alive()


@pytest.mark.parametrize("overrides,kw,match", [
    ({"train": {"host_voxelize": True}, "data": {"host_voxelizer": "cuda"}},
     {}, "host voxelizer"),
    ({"system": {"num_data_shards": 2}}, {}, "no torch.distributed process"),
    ({"train": {"remat": "some"}}, {}, "remat"),
])
def test_trainer_refuses_what_the_port_lacks(tmp_path, overrides, kw, match):
    data = write_mini_kitti(str(tmp_path / "kitti"),
                            splits=(("training", 2), ("validation", 1)))
    cfg = get_config("Car", **merged(SMALL, **overrides))
    with pytest.raises(ValueError, match=match):
        with Trainer(cfg, data + "/training", data + "/validation",
                     exp_dir=str(tmp_path / "exp"), device="cpu") as tr:
            tr.train(**kw)


# --- the CLIs end to end ------------------------------------------------------

CLI_CFG = """# SMALL in f32 (an override file in the port's YAML subset)
object: {x_min: 3.2, x_max: 9.6, y_min: -3.2, y_max: 3.2}
data: {max_points: 2048, max_voxels: 256, max_gt_boxes: 8}
train:
  batch_size: 2
  num_epochs: %d
  compute_dtype: float32
val: {batch_size: 2}
rpn: {score_thres: 0.3}
"""


def test_train_resume_eval_predict_clis_on_cpu(tmp_path, capsys):
    from voxelnet_tpu_torch.cli import eval as eval_cli
    from voxelnet_tpu_torch.cli import predict as predict_cli
    from voxelnet_tpu_torch.cli import train as train_cli

    data = write_mini_kitti(str(tmp_path / "kitti"))
    for n in (2, 3):
        (tmp_path / f"cfg{n}.yaml").write_text(CLI_CFG % n)
    exp = str(tmp_path / "exp")
    common = ["--data-dir", data, "--exp-dir", exp, "--device", "cpu",
              "--print-interval", "1", "--summary-val-interval", "1"]
    train_cli.main(common + ["--cfg", str(tmp_path / "cfg2.yaml"),
                             "--profile-steps", "1:2"])
    train_cli.main(common + ["--cfg", str(tmp_path / "cfg3.yaml"),
                             "--resume", exp + "/checkpoints"])
    out = capsys.readouterr().out
    assert "Train 1 @ epoch 3/3" in out and "Epoch 3 time" in out
    assert out.count("Train 1 @ epoch 1/") == 1
    assert sorted(os.listdir(exp + "/checkpoints")) == ["0", "1", "2"]
    for epoch in ("1", "2", "3"):
        assert sorted(os.listdir(f"{exp}/preds/{epoch}/data")) == [
            "000000.txt", "000001.txt"]
    assert [f for f in os.listdir(exp + "/logs")
            if f.endswith(".pt.trace.json")]
    snapshot = get_config("Car").merge_from_file(exp + "/config.yaml")
    assert snapshot.train.num_epochs == 3 and snapshot.data.dir == data

    eval_cli.main(["--preds", f"{exp}/preds/3/data", "--gt",
                   data + "/validation/label_2", "--iou", "0.1"])
    report = json.loads(capsys.readouterr().out)
    assert report["frames"] == 2 and "AP_moderate" in report

    predict_cli.main(["--pcl", data + "/validation/velodyne/000000.bin",
                      "--checkpoint", exp + "/checkpoints", "--cfg",
                      str(tmp_path / "cfg3.yaml"), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith("detections")
    assert len(lines) == 1 + int(lines[0].split(": ")[1].split()[0])

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_cli.main(["--data-dir", data])
