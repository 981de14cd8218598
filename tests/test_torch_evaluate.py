"""The port's KITTI AP evaluator and eval CLI against the JAX package's on
the CPU: seeded frames with difficulty metadata, neighbour classes,
DontCare regions, small detections and orientations, in 3d and bev, at 11
and 40 points, with and without AOS; the CLI's JSON on the same dirs."""

import json

import numpy as np
import pytest

from voxelnet_tpu.cli import eval as jax_eval_cli
from voxelnet_tpu.training import evaluate as jax_evaluate
from voxelnet_tpu_torch.cli import eval as eval_cli
from voxelnet_tpu_torch.training import evaluate
from voxelnet_tpu_torch.utils import kitti


def _frame_lines(rng, n_gt):
    """(gt label lines, prediction lines): GT cars/vans/pedestrians with
    random truncation, occlusion and 2D heights, one DontCare region; the
    predictions are jittered GTs, misses and false positives, with
    scores."""
    gt, pred = [], []
    for _ in range(n_gt):
        cls = rng.choice(["Car", "Car", "Car", "Van", "Pedestrian"])
        x, z = rng.uniform(-10, 10), rng.uniform(5, 40)
        h, w, l = rng.uniform(1.4, 1.8), rng.uniform(1.5, 1.8), \
            rng.uniform(3.5, 4.5)
        ry = rng.uniform(-np.pi, np.pi)
        y2 = rng.uniform(150, 300)
        y1 = y2 - rng.uniform(15, 80)
        x1 = rng.uniform(0, 1000)
        alpha = ry - np.arctan2(x, z)
        gt.append(f"{cls} {rng.choice([0.0, 0.2, 0.4]):.2f} "
                  f"{rng.integers(0, 3)} {alpha:.2f} {x1:.2f} {y1:.2f} "
                  f"{x1 + 50:.2f} {y2:.2f} {h:.2f} {w:.2f} {l:.2f} "
                  f"{x:.2f} 1.70 {z:.2f} {ry:.2f}\n")
        if rng.random() < 0.8:
            j = rng.normal(0, 0.25, 3)
            dy = rng.normal(0, 0.2)
            score = rng.uniform(0.3, 1.0)
            pred.append(f"Car 0.00 0 {alpha + dy:.4f} {x1:.2f} "
                        f"{y1 + rng.normal(0, 5):.2f} {x1 + 50:.2f} "
                        f"{y2:.2f} {h:.2f} {w:.2f} {l:.2f} {x + j[0]:.2f} "
                        f"{1.70 + j[1]:.2f} {z + j[2]:.2f} {ry + dy:.2f} "
                        f"{score:.4f}\n")
    gt.append("DontCare -1 -1 -10 600.00 160.00 700.00 220.00 -1 -1 -1 "
              "-1000 -1000 -1000 -10\n")
    for _ in range(rng.integers(1, 4)):
        x1 = rng.uniform(0, 1000)
        pred.append(f"Car 0.00 0 0.1 {x1:.2f} 160.00 {x1 + 40:.2f} "
                    f"{rng.uniform(170, 240):.2f} 1.60 1.70 4.00 "
                    f"{rng.uniform(-10, 10):.2f} 1.70 {rng.uniform(5, 40):.2f}"
                    f" 0.3 {rng.uniform(0, 0.6):.4f}\n")
    # a detection inside the DontCare region, and one that is too small
    pred.append("Car 0.00 0 0.0 610.00 165.00 690.00 215.00 1.6 1.7 4.0 "
                "30.0 1.7 60.0 0.0 0.9000\n")
    pred.append("Car 0.00 0 0.0 10.00 165.00 20.00 175.00 1.6 1.7 4.0 "
                "-30.0 1.7 60.0 0.0 0.8500\n")
    return gt, pred


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A prediction dir and a GT dir of 12 seeded frames."""
    root = tmp_path_factory.mktemp("eval")
    preds, gts = root / "preds", root / "gt"
    preds.mkdir()
    gts.mkdir()
    rng = np.random.default_rng(0)
    for i in range(12):
        gt, pred = _frame_lines(rng, int(rng.integers(0, 7)))
        (gts / f"{i:06d}.txt").write_text("".join(gt))
        (preds / f"{i:06d}.txt").write_text("".join(pred))
    return str(preds), str(gts)


def _frames(module, preds, gts):
    cli = {evaluate: eval_cli, jax_evaluate: jax_eval_cli}[module]
    return cli.load_frames_from_dirs(preds, gts, "Car")


@pytest.mark.parametrize("mode", ["3d", "bev"])
@pytest.mark.parametrize("points", [11, 40])
@pytest.mark.parametrize("aos", [False, True], ids=["ap", "aos"])
def test_evaluate_ap_matches_jax(split, mode, points, aos):
    frames = _frames(evaluate, *split)
    jframes = _frames(jax_evaluate, *split)
    assert len(frames) == 12
    for iou in (0.3, 0.7):
        got = evaluate.evaluate_ap(frames, iou, mode, num_points=points,
                                   compute_aos=aos)
        want = jax_evaluate.evaluate_ap(jframes, iou, mode,
                                        num_points=points, compute_aos=aos)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == v or (v != v and got[k] != got[k]), k
    # the frames reach every rule: some AP above 0, some below 1
    values = [v for v in evaluate.evaluate_ap(
        frames, 0.3, mode, num_points=points).values() if v == v]
    assert max(values) > 0 and min(values) < 1


def test_ground_truth_and_box_iou_match_jax(split):
    rng = np.random.default_rng(1)
    gt, _ = _frame_lines(rng, 6)
    for cls in ("Car", "Pedestrian", "Cyclist"):
        got = evaluate.parse_gt_for_eval(gt, cls)
        want = jax_evaluate.parse_gt_for_eval(gt, cls)
        for name in ("boxes_lidar", "bbox_height", "occlusion",
                     "truncation", "ignored", "alpha", "dontcare"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    boxes = kitti.parse_label_lines(gt, "", "lidar")
    for mode in ("3d", "bev"):
        assert evaluate.box3d_iou(boxes[0], boxes[0] + 0.2, mode) == \
            jax_evaluate.box3d_iou(boxes[0], boxes[0] + 0.2, mode)


@pytest.mark.parametrize("args", [
    [], ["--mode", "bev", "--iou", "0.5"], ["--ap-points", "40", "--aos"]],
    ids=["3d", "bev", "40aos"])
def test_eval_cli_prints_the_jax_json(split, args, capsys):
    preds, gts = split
    argv = ["--preds", preds, "--gt", gts] + args
    jax_eval_cli.main(argv)
    want = capsys.readouterr().out
    eval_cli.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["frames"] == 12


def test_eval_cli_refuses_unscored_lines(split, tmp_path):
    _, gts = split
    preds = tmp_path / "p"
    preds.mkdir()
    (preds / "000000.txt").write_text(
        "Car 0 0 0 1 2 3 4 1.5 1.6 3.9 1.0 1.7 10.0 0.0\n")
    with pytest.raises(ValueError, match="16"):
        eval_cli.main(["--preds", str(preds), "--gt", gts])
