"""One run of one cell: everything of the harness that no cell owns.

What belongs to one cell is data, found by name from `BENCHMARK.json`:
the configuration (`workloads[].config` -> `configs[].file`), the mix
(`benchmarks/traffic/<traffic>.json`, whose `kind` names the generator
`benchmarks/traffic/<kind>.py`), the limits of its comparisons
(`benchmarks/limits/<workload>.json`) and one reader a per-layer metric
(`benchmarks/metrics/<metric>.py`). A later cell, configuration, mix or
metric is new files and entries, and no edit here.

A generator module defines `Driver(cell)`, whose construction is the
set-up (weights, inputs, warm-up), and on it: `frames_per_call`,
`stages` (the program's mark names after 'start'), `call(i, marks)`,
`finish()`, `end_to_end(elapsed)`, `pool_index(i)`, `release()` and
`judge()`, and where set-up ran the reference, `untimed_s`: its seconds,
which `setup_s` leaves out.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from benchmarks.harness import counts, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "voxelnet_tpu")
TRACE_ATTEMPTS = 3


class Cell(NamedTuple):
    root: str           # the checkout
    workload: dict      # the BENCHMARK.json entry
    cfg: dict           # the configuration as it is run
    labels: dict        # the configuration's label statistics
    mix: dict           # the traffic file
    limits: dict        # name -> limit
    seed: int
    device: torch.device


class Phases:
    """Set-up's phases, timed and printed to standard error as one line
    (so that a set-up that moves shows where)."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts: list = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.3f}")
        self.t = now

    def report(self) -> None:
        print("set-up phases (s): " + ", ".join(self.parts), file=sys.stderr)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from its file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bench_dir(root: str) -> str:
    return os.path.join(root, "benchmarks")


def load_cell_entry(root: str, workload: str) -> dict:
    """The workload's entry of BENCHMARK.json."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    return cells[workload]


def load_cell(root: str, workload: str, seed: int, device) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    w = load_cell_entry(root, workload)
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    spec = load_json(os.path.join(root, conf["file"]))
    d = bench_dir(root)
    mix = load_json(os.path.join(d, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(d, "limits", f"{workload}.json"))
    return Cell(root, w, spec["config"], spec.get("labels", {}), mix,
                limits["limits"], int(seed), torch.device(device))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (voxelnet_tpu_torch is not voxelnet_tpu)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Reading(NamedTuple):
    """What a per-layer metric's reader reads: the traced window's
    numbers, per call where it says so."""

    calls: int
    stage_ms: dict        # program stage -> mean ms a call (its marks)
    kernel_ms: dict       # program kernel -> device ms a call (trace)
    kernel_bound_ms: dict  # program kernel -> bytes-once bound a call
    flops_per_call: float
    busy_s: float
    window_s: float
    memory_peak_bytes: int


def port_config(cfg: dict):
    """The program's configuration object of a configuration file's dict
    (every key read; one that the program lacks raises)."""
    from voxelnet_tpu_torch.config import VoxelNetConfig

    config = VoxelNetConfig.from_dict(cfg)
    if json.loads(json.dumps(config.to_dict())) != cfg:
        raise ValueError("the configuration file does not hold the whole "
                         "configuration the program runs")
    return config


def window(driver, seconds: float):
    """Calls until `seconds` have passed, then the outstanding work ->
    (seconds from the first call to the end of the last, calls)."""
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        driver.call(i)
        i += 1
    driver.finish()
    return time.perf_counter() - t0, i


def stage_means(marks: list, stages: tuple) -> dict:
    """marks of each call [(stage, event), ...] -> stage -> mean ms from
    the mark before it."""
    sums = {s: 0.0 for s in stages}
    for call in marks:
        for (_, a), (name, b) in zip(call, call[1:]):
            # CUDA events on the card, host seconds elsewhere
            sums[name] += (a.elapsed_time(b) if hasattr(a, "elapsed_time")
                           else 1e3 * (b - a))
    return {s: v / max(len(marks), 1) for s, v in sums.items()}


def traced(driver, cell: Cell, start: int):
    """The traced window: cell.mix['trace_calls'] calls with marks under
    the profiler, taken again while a program kernel's events in the
    trace differ from the launches its wrapper counted -> (Trace, stage
    means, first call index)."""
    from voxelnet_tpu_torch.kernels import SYMBOLS, launch_counts

    n = cell.mix["trace_calls"]
    for attempt in range(TRACE_ATTEMPTS):
        marks = [[] for _ in range(n)]
        before = launch_counts()

        def run_calls():
            for j in range(n):
                driver.call(start + j, marks[j])
            driver.finish()

        events = trace.profile(run_calls, cell.device)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        tr = trace.reduce(events, n, SYMBOLS, cell.device.type == "cuda")
        if tr.kernel_events == launched:
            return tr, stage_means(marks, driver.stages), start
        print(f"trace attempt {attempt + 1}: kernel events "
              f"{tr.kernel_events} against launches {launched}",
              file=sys.stderr)
        start += n
    raise RuntimeError("torch.profiler lost kernel events in every traced "
                       "window")


def reading(driver, cell: Cell, tr, stage_ms: dict, start: int,
            peak: int) -> Reading:
    """The traced window's Reading; its FLOPs and bounds from the
    reference's voxelization of the batches the window ran."""
    pools = [driver.pool_index(start + j) for j in range(tr.calls)]
    stats = {p: counts.batch_stats(*driver.pool[p][:2], cell.cfg)
             for p in set(pools)}
    frames = driver.frames_per_call
    fwd = [counts.forward_flops(cell.cfg, stats[p][0], stats[p][1], frames)
           for p in pools]
    factor = 3.0 if driver.train else 1.0
    bounds = [counts.kernel_bounds(cell.cfg, frames, stats[p][0])
              for p in pools]
    bound_ms = {k: 1e3 * statistics.fmean(b[k] for b in bounds)
                for k in bounds[0]}
    kernel_ms = {k: 1e3 * s / tr.calls for k, s in tr.kernel_s.items()
                 if tr.kernel_events[k]}
    return Reading(calls=tr.calls, stage_ms=stage_ms,
                   kernel_ms=kernel_ms, kernel_bound_ms=bound_ms,
                   flops_per_call=factor * statistics.fmean(fwd),
                   busy_s=tr.busy_s, window_s=tr.window_s,
                   memory_peak_bytes=peak)


def run(root: str, workload: str, seed: int, seconds: float, traced_run:
        bool, device="cuda", t_start: float | None = None) -> dict:
    """One run of a cell -> the result's fields (see run.py). The device
    is not checked here."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = load_cell(root, workload, seed, device)
    gen = load_module(os.path.join(bench_dir(root), "traffic",
                                   f"{cell.mix['kind']}.py"),
                      f"bench_traffic_{cell.mix['kind']}")
    driver = gen.Driver(cell)
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    # less what the driver spent in the reference (its `untimed_s`)
    setup_s = (time.perf_counter() - t_start
               - getattr(driver, "untimed_s", 0.0))
    if traced_run:
        tr, stage_ms, start = traced(driver, cell, driver.next_call)
        attempted = tr.calls
    else:
        elapsed, attempted = window(driver, seconds)
    peak = (torch.cuda.max_memory_allocated(cell.device) if on_card
            else 0)
    failed = driver.failed()
    if traced_run:
        r = reading(driver, cell, tr, stage_ms, start, peak)
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, workload):
                continue
            reader = load_module(os.path.join(
                bench_dir(root), "metrics", f"{m['name']}.py"),
                f"bench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(r)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(elapsed)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, workload)}
    driver.release()
    numbers = driver.judge()
    # the limits file names the numbers compared; a number it names that
    # the comparison lacks raises
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info(cell.device, peak)}
    if traced_run:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    return result


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def sample_calls(n_calls: int, k: int, seed: int) -> list[int]:
    """k of the calls 0..n_calls-1, drawn from the seed, in order."""
    rng = np.random.default_rng([int(seed), 7])
    return sorted(rng.choice(n_calls, size=min(k, n_calls),
                             replace=False).tolist())
