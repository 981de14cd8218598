"""A configuration, two mixes, two cells and a per-layer metric added as
files and entries to a copy of the benchmark run through the harness at
a tiny size on the CPU, with no file of the copy edited."""

import hashlib
import json
import os

from benchmarks.harness import core
from benchmarks.tests import tiny

METRIC = '''"""The VFE's share of the traced call time: a test's metric."""


def read(r):
    total = sum(r.stage_ms.values())
    return 100.0 * r.stage_ms["vfe"] / total if total > 0 else None
'''


def digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmarks")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_cells_and_metric_run_from_files_alone(tmp_path):
    root = tiny.make_tree(str(tmp_path))
    with open(os.path.join(root, "benchmarks", "metrics",
                           "vfe_share.tiny.py"), "w") as f:
        f.write(METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "vfe_share.tiny", "unit": "%", "better": "lower",
        "source": "program_span", "layer": "vfe", "moves": "infer_fps",
        "workloads": ["tiny-infer"]})
    tiny.write(os.path.join(root, "BENCHMARK.json"), bench)
    before = digests(root)
    seed = 2 ** 31 + 3
    r = core.run(root, "tiny-infer", seed, 0.5, False, "cpu")
    assert set(r["metrics"]) == {"infer_fps", "infer_p95_ms", "setup_s"}
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    r = core.run(root, "tiny-infer", seed, 0.5, True, "cpu")
    assert 0 < r["metrics"]["vfe_share.tiny"]["value"] < 100
    assert "middle_ms.infer" in r["metrics"]
    # no device ran: the device's metrics are left out, never 0
    assert "mfu.infer" not in r["metrics"]
    assert "vfe_fused_roofline.infer" not in r["metrics"]
    r = core.run(root, "tiny-train", seed, 0.5, False, "cpu")
    assert set(r["metrics"]) == {"train_fps", "setup_s"}
    assert r["correct"]
    r = core.run(root, "tiny-train", seed, 0.5, True, "cpu")
    assert "backward_ms.train" in r["metrics"]
    assert "vfe_share.tiny" not in r["metrics"]
    assert digests(root) == before


def test_inputs_and_weights_follow_the_seed(tmp_path):
    import numpy as np
    import torch

    from benchmarks.harness import frames, weights

    root = tiny.make_tree(str(tmp_path))
    cell = core.load_cell(root, "tiny-train", 2 ** 31 + 11, "cpu")
    sweeps = frames.load_sweeps(os.path.join(root, tiny.FRAMES))

    def pool(seed):
        return frames.batch_pool(sweeps, cell.cfg, cell.mix,
                                 np.random.default_rng([seed, 1]))

    a, b, c = pool(2 ** 31 + 11), pool(2 ** 31 + 11), pool(2 ** 31 + 12)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    assert not np.array_equal(a[0][0], c[0][0])
    w1 = weights.make_params(cell.cfg, 2 ** 33 + 1, "cpu")
    w2 = weights.make_params(cell.cfg, 2 ** 33 + 1, "cpu")
    w3 = weights.make_params(cell.cfg, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["rpn.prob_conv.weight"],
                           w3["rpn.prob_conv.weight"])
