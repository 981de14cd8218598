"""The traced window: torch.profiler over a fixed number of calls, opened
by a primer, and the reduction of its Chrome trace to busy time, each
kernel's device time, the top device ops and the idle gaps by what the
host was doing.

The primer and the parser are copies, frozen here, of the program's
measurement tools (`voxelnet_tpu_torch/tools/card.py::profiled`,
`voxelnet_tpu_torch/tools/profile_step.py::parse_trace` and `union_ms`):
on an H100 torch.profiler lost the records of a window's first kernels,
which 10 ms of idle and 32 spin kernels ahead of the calls, inside the
profile, took instead; their records are left out here.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

PROFILE_LEAD_S = 0.01
PRIMER_KERNELS = 32
PRIMER_SYMBOL = "spin_kernel"
WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
GAPS_ATTRIBUTED = 500
NAME_WIDTH = 100


class Trace(NamedTuple):
    """One traced window of `calls` calls, in seconds."""

    calls: int
    window_s: float
    busy_s: float
    kernel_s: dict        # program kernel -> device seconds in the window
    kernel_events: dict   # program kernel -> its events in the window
    device_ops: list      # [[name, seconds], ...] by time, at most TOP
    idle_gaps: list       # [[host op, seconds], ...] at most TOP


def union_s(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernel_of(name: str, symbols: dict) -> str | None:
    """The program kernel (a key of `symbols`) whose `__global__` symbol a
    device event's name carries, None for any other."""
    for kernel, symbol in symbols.items():
        if re.search(rf"\b{symbol}\b", name):
            return kernel
    return None


def profile(run_calls, device) -> list[dict]:
    """torch.profiler (CPU and CUDA) around the primer and run_calls(),
    which runs the window's calls and synchronises; the calls sit in a
    `bench.window` annotation -> the trace's events."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    with torch_profile(activities=activities) as prof:
        if on_card:
            time.sleep(PROFILE_LEAD_S)
            for _ in range(PRIMER_KERNELS):
                torch.cuda._sleep(10_000)
            torch.cuda.synchronize(device)
        with torch.profiler.record_function(WINDOW):
            run_calls()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def reduce(events: list[dict], calls: int, symbols: dict,
           on_card: bool = True) -> Trace:
    """The window's numbers from a trace's events. Raises where a trace of
    the card holds no device event in the window; off the card (a
    rehearsal) busy time is 0 and no kernel ran."""
    span = [e for e in events if e.get("name") == WINDOW
            and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if not span:
        raise RuntimeError("the trace has no bench.window annotation")
    w0 = float(span[0]["ts"])
    w1 = w0 + float(span[0]["dur"])
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS and "dur" in e
              and PRIMER_SYMBOL not in e.get("name", "")
              and float(e["ts"]) >= w0 - 1.0]
    if not device and not on_card:
        return Trace(calls, (w1 - w0) / 1e6, 0.0, {k: 0.0 for k in symbols},
                     {k: 0 for k in symbols}, [], [])
    if not device:
        raise RuntimeError("the trace holds no device event in the window: "
                           "CUPTI recorded nothing on the card")
    # from the window's start: absolute timestamps (~1e12 us) would round
    # the union's sum past the durations' own
    spans = sorted((float(e["ts"]) - w0, float(e["ts"]) - w0
                    + float(e["dur"])) for e in device)
    by_name: dict = {}
    kernel_s = {k: 0.0 for k in symbols}
    kernel_events = {k: 0 for k in symbols}
    for e in device:
        name = e.get("name", "?")
        dur = float(e["dur"]) / 1e6
        by_name[name] = by_name.get(name, 0.0) + dur
        k = kernel_of(name, symbols)
        if k is not None:
            kernel_s[k] += dur
            kernel_events[k] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(calls=calls, window_s=(w1 - w0) / 1e6,
                 busy_s=union_s(spans) / 1e6, kernel_s=kernel_s,
                 kernel_events=kernel_events,
                 device_ops=[[short(n), s] for n, s in top],
                 idle_gaps=idle_gaps(events, spans, w0, w1 - w0))


def short(name: str) -> str:
    name = name.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "")[:NAME_WIDTH]


def idle_gaps(events, spans, w0: float, length: float) -> list:
    """The window's device idle gaps (between the merged busy intervals,
    and before the first and after the last), each put to the innermost
    host op that covers its midpoint ('python' where none does), summed
    by op over the GAPS_ATTRIBUTED longest -> [[op, seconds], ...]."""
    gaps, end = [], 0.0
    for a, b in spans:
        if a > end:
            gaps.append((end, min(a, length)))
        end = max(end, b)
    if end < length:
        gaps.append((end, length))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:GAPS_ATTRIBUTED]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")
           and "dur" in e]
    if not gaps:
        return []
    start = np.array([float(e["ts"]) - w0 for e in ops])
    stop = start + np.array([float(e["dur"]) for e in ops])
    total: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.flatnonzero((start <= mid) & (stop >= mid))
        if len(cover):
            op = ops[cover[np.argmin(stop[cover] - start[cover])]]["name"]
        else:
            op = "python"
        total[op] = total.get(op, 0.0) + (b - a) / 1e6
    return [[short(n), s] for n, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
