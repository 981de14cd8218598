"""The port's synthetic learning run (voxelnet_tpu_torch/tools/
synthetic_smoke.py) on the CPU: its frames against the JAX script's
(`scripts/train_synthetic_smoke.py`, loaded by path; nothing edits it),
its `main` end to end at the tiny grid, and `cli.eval` over its label
dumps against its in-process AP."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from voxelnet_tpu_torch.tools import synthetic_smoke as tool
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny grid of tests/conftest.py::tiny_config, f32, every score kept
TINY_YAML = """object: {x_max: 12.8, y_min: -6.4, y_max: 6.4}
data: {max_points: 2048, max_voxels: 256, max_gt_boxes: 8}
train: {compute_dtype: float32}
rpn: {score_thres: 0.0}
"""


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "train_synthetic_smoke",
        os.path.join(REPO, "scripts", "train_synthetic_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("class_name", ["Car", "Pedestrian", "Cyclist"])
def test_synth_frame_is_the_scripts(script, class_name):
    assert tool._SCENES == script._SCENES
    for seed in range(4):
        for yaw_limit in (np.pi / 2, 1.0):
            want = script.synth_frame(np.random.default_rng(seed),
                                      class_name=class_name,
                                      yaw_limit=yaw_limit)
            got = tool.synth_frame(np.random.default_rng(seed),
                                   class_name=class_name,
                                   yaw_limit=yaw_limit)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)


def test_config_is_the_scripts(script):
    want = script.get_config(
        "Pedestrian",
        data={"max_points": 16384, "max_voxels": 8192, "max_gt_boxes": 8},
        rpn={"score_thres": 0.3}, train={"yaw_encoding": "sin"})
    got = tool.make_config("Pedestrian", 0.3, "sin")
    assert got.to_dict() == want.to_dict()


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def test_main_dumps_labels_that_cli_eval_scores_alike(tiny_cfg, tmp_path,
                                                      capsys):
    """2 steps on the CPU, 4 held-out frames: the labels are dumped, cli.eval
    scores them as the in-process AP, and the checkpoint loads in
    cli.predict."""
    from voxelnet_tpu_torch.cli import predict

    dump = str(tmp_path / "dump")
    ckpt = str(tmp_path / "ckpt")
    out = tool.main(["--steps", "2", "--frames", "4", "--eval-frames", "4",
                     "--batch", "2", "--device", "cpu", "--cfg", tiny_cfg,
                     "--dump-labels", dump, "--save-checkpoint", ckpt,
                     "--lr-drop-at", "0.5"])
    assert sorted(os.listdir(os.path.join(dump, "preds", "data"))) == [
        f"{i:06d}.txt" for i in range(4)]
    assert sorted(os.listdir(os.path.join(dump, "gt"))) == [
        f"{i:06d}.txt" for i in range(4)]
    assert out["ap_cli"].keys() == out["ap"].keys()
    for key, v in out["ap"].items():
        assert out["ap_cli"][key] == pytest.approx(v, abs=1e-6), key
    text = capsys.readouterr().out
    assert "-- cli.eval over" in text and "steps/s" in text
    predict.main(["--pcl", "sample:0", "--device", "cpu", "--checkpoint",
                  ckpt, "--cfg", tiny_cfg])
    assert capsys.readouterr().out.startswith("sample:0: ")


def test_eval_path_scores_perfect_detections(tiny_cfg, tmp_path, capsys):
    """Detections equal to the ground truth: AP 1 in process and through
    the dumped files and cli.eval."""
    cfg = tool.make_config("Car", cfg_file=tiny_cfg)
    frames = tool.Frames(cfg)
    from voxelnet_tpu_torch.utils import kitti

    held_out = []
    for _ in range(3):
        b = frames.batch(2)
        for gt in b.raw_gts:
            lines = kitti.boxes_to_label_lines(gt, ["Car"] * len(gt),
                                               coordinate="lidar")
            scored = kitti.boxes_to_label_lines(
                gt, ["Car"] * len(gt), scores=np.linspace(1, 0.5, len(gt)),
                coordinate="lidar")
            held_out.append(tool.EvalFrame(scored, lines, len(gt), len(gt)))
    ap = tool.score(held_out, "Car")
    ap_cli = tool.score_dumps(*tool.dump_labels(held_out, str(tmp_path)),
                              "Car")
    assert ap == ap_cli
    assert ap["AP@0.7 3d"] == pytest.approx(1.0)
    assert json.loads(capsys.readouterr().out.splitlines()[0])["frames"] == 6


def test_train_logs_a_falling_loss_with_momentum(tiny_cfg):
    """6 steps with momentum on 2 fixed batches: the optimizer state
    carries a trace, every logged loss is finite and the loss falls."""
    cfg = tool.make_config("Car", cfg_file=tiny_cfg)
    frames = tool.Frames(cfg)
    opt = tool.make_optimizer(cfg, 0.005, 6, lr_drop_at=0.5)
    assert opt.momentum == 0.9 and opt.schedule(3) == pytest.approx(5e-4)
    run = tool.train(cfg, frames, opt, steps=6, num_frames=4, batch=2,
                     device="cpu", log_every=1, echo=lambda s: None)
    losses = [row[1] for row in run.log]
    assert [row[0] for row in run.log] == list(range(1, 7))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert run.state.opt_state.count == 6
    assert len(run.state.opt_state.trace) == len(
        list(run.state.model.parameters()))
    assert all(torch.isfinite(t).all() for t in run.state.opt_state.trace)


def test_learning_run_targets_match_jax():
    """The target maps of the learning run's frames (Car grid, yaw band
    |r| < 1.0, the converged row's) equal the JAX package's assignment:
    the port's yaw errors there (PERF.md §6) are not a target fault."""
    import jax.numpy as jnp

    from voxelnet_tpu.config import get_config as jax_get_config
    from voxelnet_tpu.ops import anchors as jax_anchors
    from voxelnet_tpu.ops import targets as jax_targets
    from voxelnet_tpu_torch.ops import targets
    from voxelnet_tpu_torch.ops.anchors import anchors_flat

    cfg = tool.make_config("Car")
    obj = cfg.object
    jobj = jax_get_config("Car").object
    batch = tool.Frames(cfg, "Car", yaw_limit=1.0).batch(4)
    anchors = torch.from_numpy(anchors_flat(obj))
    standup = torch.from_numpy(targets.anchor_standup_np(obj))
    kw = dict(pos_iou=obj.rpn_pos_iou, neg_iou=obj.rpn_neg_iou,
              anchor_h=obj.anchor_h)
    shape = (obj.feature_height, obj.feature_width)
    got = targets.targets_to_maps(targets.assign_targets(
        torch.from_numpy(batch.gt_boxes), torch.from_numpy(batch.gt_mask),
        anchors, standup, **kw), shape)
    for i in range(4):
        want = jax_targets.targets_to_maps(jax_targets.assign_targets(
            jnp.asarray(batch.gt_boxes[i]), jnp.asarray(batch.gt_mask[i]),
            jnp.asarray(jax_anchors.anchors_flat(jobj)),
            jnp.asarray(jax_targets.anchor_standup_np(jobj)), **kw), shape)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)
    assert float(got[0].sum()) >= batch.gt_mask.sum()


def test_dump_report_finds_a_rotated_detection(tmp_path, capsys):
    """tools/dump_report.py on a dump whose detections equal the GT but
    one, rotated by 0.9 rad: that GT is the only miss, its yaw error is
    reported, and its rotated box is a high-score false positive."""
    from voxelnet_tpu_torch.tools import dump_report
    from voxelnet_tpu_torch.utils import kitti

    gt = np.asarray([[10.0, 2.0, -1.7, 1.5, 1.6, 3.9, 0.3],
                     [20.0, -4.0, -1.7, 1.5, 1.6, 3.9, -0.7]], np.float32)
    pred = gt.copy()
    pred[1, 6] += 0.9
    frames = [tool.EvalFrame(
        kitti.boxes_to_label_lines(pred, ["Car"] * 2, scores=[0.99, 0.95],
                                   coordinate="lidar"),
        kitti.boxes_to_label_lines(gt, ["Car"] * 2, coordinate="lidar"),
        2, 2)]
    tool.dump_labels(frames, str(tmp_path))
    (r,) = dump_report.main([str(tmp_path)])
    assert r["moderate"] == 2 and r["recall"] == 0.5
    assert r["fp"] == 1 and r["fp_high"] == 1
    assert len(r["miss_iou"]) == 1 and 0.25 < r["miss_iou"][0] < 0.5
    assert r["miss_dyaw_deg"][0] == pytest.approx(np.degrees(0.9), abs=0.1)
    bands = {(lo, hi): (n, rec) for lo, hi, n, rec, _ in r["bands"]}
    assert bands[(-0.9, -0.6)] == (1, 0.0) and bands[(0.0, 0.3)] == (1, 1.0)
    assert "recall 0.500" in capsys.readouterr().out
