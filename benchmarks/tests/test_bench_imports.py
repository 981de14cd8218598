"""Nothing that the harness or its reference loads is JAX or the JAX
package, compared by whole top-level names; and run.py refuses to run,
printing no result, where it cannot."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmarks.harness import core
from benchmarks.tests import tiny

RUN = os.path.join(tiny.REPO, "benchmarks", "run.py")


def python(code: str, cwd: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=tiny.REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_a_run_loads_no_jax_module(tiny_root):
    """A whole run of each tiny cell (set-up, window, trace, the
    reference's comparison) in a fresh process, then sys.modules."""
    out = python(f"""
        import json, sys
        from benchmarks.harness import core
        for cell in ("tiny-infer", "tiny-train"):
            for traced in (False, True):
                core.run({tiny_root!r}, cell, 2**31 + 5, 0.5, traced, "cpu")
        import benchmarks.calibrate, benchmarks.run
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in core.FORBIDDEN)))
        print(json.dumps(sorted(m for m in sys.modules
                                if m.startswith("voxelnet_tpu"))))
        """, tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, ported = (json.loads(line)
                         for line in out.stdout.strip().splitlines()[-2:])
    assert forbidden == []
    assert "voxelnet_tpu_torch" in ported


def test_whole_names_are_compared():
    sys.modules["voxelnet_tpu.fake"] = sys.modules["json"]
    try:
        assert core.forbidden_modules() == ["voxelnet_tpu.fake"]
    finally:
        del sys.modules["voxelnet_tpu.fake"]
    assert all(not m.startswith("voxelnet_tpu_torch")
               for m in core.forbidden_modules())


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, RUN, "--workload", "car-infer-b8", "--seed",
         str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(os.path.join(tiny.REPO, "benchmarks"),
                    tmp_path / "benchmarks")
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "car-infer-b8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout == ""
