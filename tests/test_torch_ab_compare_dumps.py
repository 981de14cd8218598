"""The port's dump comparison (voxelnet_tpu_torch/tools/ab_compare_dumps.py)
against `scripts/ab_compare_dumps.py`: the same JSON line, byte for byte,
on hand-made dump directories; the inference slice at a tiny grid through
label dumps, JAX's graph (fused VFE in interpret mode) against the port's
CPU path from the same variables; the committed JAX fixture of
chip_smoke.py phase 14 still made from the weights and points that
chip_smoke.py makes; and the tool's independence from JAX."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_port_helpers import (TINY, configs, jax_variables, merged,
                                random_points, torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

import chip_smoke
from voxelnet_tpu_torch.tools import ab_compare_dumps
from voxelnet_tpu_torch.tools.ab_compare_dumps import (compare, frame_tag,
                                                       write_calib_dir,
                                                       write_dumps)
from voxelnet_tpu_torch.utils import kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny-grid slice in bf16, port against JAX: the share of the boxes
# matched at BEV IoU 0.7, the mean matched IoU and the p95 score gap. The
# bf16 activations of the two round apart by an ulp here and there, and
# the 20 best scores of a frame span only 2e-4 to 7e-3, so the NMS keeps
# some other boxes; measured on the CPU at this test's seed 14: 0.7,
# 0.9992, 1e-4 (seeds 14-18: 0.7-0.875, >= 0.9981, <= 2e-4)
BF16_MATCH_RATE, BF16_MEAN_IOU, BF16_P95_SCORE = 0.6, 0.995, 1e-3


def _boxes(rng, n):
    """(n, 7) lidar Car boxes in front of the camera, spread so that few
    overlap."""
    return np.stack([rng.uniform(5, 60, n), rng.uniform(-25, 25, n),
                     rng.uniform(-2, -1, n), rng.uniform(1.4, 1.7, n),
                     rng.uniform(1.5, 1.8, n), rng.uniform(3.5, 4.5, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _write(path, boxes, scores=None):
    with open(path, "w") as f:
        f.writelines(kitti.boxes_to_label_lines(
            boxes, ["Car"] * len(boxes), scores=scores, coordinate="lidar"))


def _make_case(root, name):
    """Dump dirs a/ and b/ and calib/ of one case -> its extra argv."""
    rng = np.random.default_rng(sum(map(ord, name)))
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    os.makedirs(a), os.makedirs(b)
    tags_a = tags_b = [frame_tag(i) for i in range(3)]
    if name == "disjoint":
        tags_b = [frame_tag(i) for i in range(3, 6)]
    write_calib_dir(os.path.join(root, "calib"), sorted({*tags_a, *tags_b}))
    for i, (ta, tb) in enumerate(zip(tags_a, tags_b)):
        box = _boxes(rng, 6)
        sa = rng.uniform(0.1, 1.0, 6).astype(np.float32)
        sb = np.clip(sa + rng.normal(0, 0.01, 6), 0, 1).astype(np.float32)
        other = box.copy()
        if name in ("below_iou", "iou_0.5"):
            # a shift of 0.8 m along x: a BEV IoU of about 0.6-0.8 by yaw,
            # and 2.5 m: none
            other[:3, 0] += 0.8
            other[3, 0] += 2.5
        if name == "score_ties":
            # every A box ties, and B holds near-copies that two A boxes
            # reach, so the order of the greedy pick decides
            sa[:] = 0.5
            other = np.concatenate([other, other[:2] + [[0.3, 0, 0, 0, 0, 0,
                                                         0]]])
            sb = np.concatenate([sb, sb[:2]])
            box = np.concatenate([box, box[:2] + [[0.15, 0, 0, 0, 0, 0, 0]]])
            sa = np.full(len(box), 0.5, np.float32)
        _write(os.path.join(a, ta), box,
               None if name == "no_score" and i != 1 else sa)
        if name == "empty_frame" and i == 1:
            open(os.path.join(b, tb), "w").close()
        else:
            _write(os.path.join(b, tb), other, sb)
    argv = ["--a", a, "--b", b, "--calib-dir", os.path.join(root, "calib")]
    return argv + (["--iou", "0.5"] if name == "iou_0.5" else [])


CASES = ("copies", "empty_frame", "below_iou", "score_ties", "no_score",
         "disjoint", "iou_0.5")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's argv and the JAX script's line for it: one subprocess
    that runs the script once a case (its imports load JAX once)."""
    root = tmp_path_factory.mktemp("ab_cases")
    argvs = {name: _make_case(str(root / name), name) for name in CASES}
    code = ("import json, runpy, sys\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    sys.argv = ['ab_compare_dumps.py'] + argv\n"
            "    runpy.run_path('scripts/ab_compare_dumps.py',\n"
            "                   run_name='__main__')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, json.dumps(list(argvs.values()))],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == len(CASES), proc.stdout
    return {name: (argvs[name], line) for name, line in zip(CASES, lines)}


@pytest.mark.parametrize("name", CASES)
def test_line_byte_equal_to_the_jax_script(cases, name, capsys):
    argv, want = cases[name]
    ab_compare_dumps.main(argv)
    got = capsys.readouterr().out
    assert got == want + "\n"
    out = json.loads(got)
    expect = {
        "copies": lambda o: o["match_rate"] == 1.0 and o["matched"] == 18,
        "empty_frame": lambda o: o["boxes_b"] == 12 and o["matched"] == 12,
        "below_iou": lambda o: 0 < o["matched"] < 18,
        "score_ties": lambda o: o["boxes_a"] == o["boxes_b"] == 24,
        "no_score": lambda o: o["mean_abs_score_diff"] > 0.1,
        "disjoint": lambda o: o["frames"] == 0
        and o["mean_matched_bev_iou"] is None,
        "iou_0.5": lambda o: o["matched"] > json.loads(
            cases["below_iou"][1])["matched"],
    }[name]
    assert expect(out), out


def test_module_cli_prints_the_line(cases):
    argv, want = cases["below_iou"]
    proc = subprocess.run(
        [sys.executable, "-m", "voxelnet_tpu_torch.tools.ab_compare_dumps",
         *argv], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want + "\n"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_slice_dumps_match_jax(dtype, tmp_path):
    """JAX's make_inference_fn (fused VFE, interpret) and the port's CPU
    path from the same variables at score_thres 0, through label dumps and
    the ported tool. The points are uniform, off the vendored frames' 5 mm
    lattice: XLA:CPU bins JAX's points by a multiply with the reciprocal
    of the voxel size, which moves lattice points that lie on a voxel
    boundary (the full-width comparison of chip_smoke.py phase 14 and
    `tests/torch_jax_dumps.py --port-cpu` runs the vendored frames)."""
    import jax

    from voxelnet_tpu.models.voxelnet import make_inference_fn as jax_fn
    from voxelnet_tpu_torch.models.voxelnet import make_inference_fn

    overrides = merged(TINY, data={"vfe_backend": "fused"},
                       rpn={"score_thres": 0.0},
                       train={"compute_dtype": dtype})
    jcfg, tcfg = configs(overrides=overrides)
    variables = jax_variables(jcfg, seed=14)
    points, num = random_points(np.random.default_rng(14), jcfg, 2, 1800)
    want = jax.jit(jax_fn(jcfg, platform="cpu"))(variables, points, num)
    got = make_inference_fn(tcfg, "cpu")(torch_model(tcfg, variables),
                                         points, num)
    tags = write_dumps(str(tmp_path / "jax"), *(np.asarray(x) for x in want))
    write_dumps(str(tmp_path / "port"), got.boxes.numpy(),
                got.scores.numpy(), got.valid.numpy())
    write_calib_dir(str(tmp_path / "calib"), tags)
    res = compare(str(tmp_path / "port"), str(tmp_path / "jax"),
                  str(tmp_path / "calib"))
    assert res["frames"] == 2 and res["boxes_a"] == res["boxes_b"] == 40, res
    if dtype == "float32":
        assert res["match_rate"] == 1.0, res
        assert abs(res["mean_matched_bev_iou"] - 1.0) <= 1e-4, res
        assert res["p95_abs_score_diff"] <= 1e-4, res
    else:
        assert res["match_rate"] >= BF16_MATCH_RATE, res
        assert res["mean_matched_bev_iou"] >= BF16_MEAN_IOU, res
        assert res["p95_abs_score_diff"] <= BF16_P95_SCORE, res


def test_fixture_is_current():
    """chip_smoke.py's Car weights and staged points still hash to the
    fixture's meta.json, and the fixture holds a dump of each setting."""
    from voxelnet_tpu_torch.config import get_config
    from voxelnet_tpu_torch.data.sample import sample_frames

    with open(os.path.join(chip_smoke.AB_FIXTURE, "meta.json")) as f:
        meta = json.load(f)
    model = chip_smoke.make_model(get_config("Car"), "cpu")
    assert chip_smoke.state_sha256(model) == meta["weights_sha256"]
    points, num = chip_smoke.ab_inputs(sample_frames())
    assert chip_smoke.points_sha256(points, num) == meta["points_sha256"]
    assert set(meta["settings"]) == set(chip_smoke.AB_SETTINGS)
    for name, setting in meta["settings"].items():
        assert setting["overrides"] == chip_smoke.merged(
            chip_smoke.AB_BASE, chip_smoke.AB_SETTINGS[name])
        assert sorted(os.listdir(os.path.join(chip_smoke.AB_FIXTURE, name))
                      ) == [frame_tag(i) for i in range(3)]
        assert setting["boxes"] == [20, 20, 20]


def test_tool_imports_no_jax():
    """The tool imports nothing of JAX, the JAX package, scripts/ or
    tests/."""
    with open(ab_compare_dumps.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names
    for name in names:
        assert name.split(".")[0] not in (
            "jax", "jaxlib", "voxelnet_tpu", "scripts", "tests", "flax",
            "optax", "__graft_entry__", "bench"), name
