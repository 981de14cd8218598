"""Capture a torch.profiler trace of the inference graph and the train step
on the card, and write an op-level summary: the port's counterpart of
`scripts/profile_step.py`.

    python -m voxelnet_tpu_torch.tools.profile_step --stage both
    python -m voxelnet_tpu_torch.tools.profile_step --stage infer \\
        --middle-backend sparse1 --out-md trace_summary_sparse1.md

Writes <out>/<out-md> (default profiles/torch/trace_summary.md): the device
ops by total time for each graph, with the aten op that launched each one,
and the Chrome traces under <out>/traces/<stage>/ (gitignored; open them in
Perfetto or chrome://tracing). The summary is what gets committed.

The work traced is the bench's (voxelnet_tpu_torch/bench.py): its frames
(`load_frames`), its stages (`make_stage_fn`: 'infer', and 'train' with or
without --host-voxelize, one GT box a frame) and its model
(`build_model(config, seed=0)`). Each graph runs once outside the profile,
then `--iters` times under `torch.profiler` (CPU and CUDA activities,
input shapes recorded), closed by one `torch.cuda.synchronize()`. On the
card the window opens with `tools/card.py`'s primer (idle, then spin
kernels, left out of the tables), and is taken again while a port
kernel's events in the trace differ from the launches its wrapper
counted. Each call passes `marks`, so the program records its spans
(voxelnet_tpu_torch/tracing.py), each a `voxelnet.<name>` range of the
trace; the table of the device's idle puts each gap between its ops to
the innermost such range that covers the gap's midpoint.

The device ops are the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events. "launched by" is the aten op (with its input shapes) that the
profiler links to the runtime call that launched the op; the port's own
CUDA kernels are launched through ctypes, under no aten op, and are named
by their source in `voxelnet_tpu_torch/csrc/` instead. A profile of the card
that holds no device event raises. `--device cpu` lists the CPU ops by self
CPU time instead (a rehearsal at a small config; no device is measured).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from voxelnet_tpu_torch.bench import load_frames, make_stage_fn
from voxelnet_tpu_torch.config import get_config, resolve_plan
from voxelnet_tpu_torch.kernels import SYMBOLS, launch_counts, source_path
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec
from voxelnet_tpu_torch.tools import card
from voxelnet_tpu_torch.tracing import RANGE_PREFIX
from voxelnet_tpu_torch.training.train_step import _device

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_WIDTH = 100
OP_WIDTH = 90
OUTSIDE = "outside the program"


def port_kernel(name: str) -> str | None:
    """The port kernel (a key of SYMBOLS) whose `__global__` symbol a
    device event's name carries, None for any other."""
    for kernel, symbol in SYMBOLS.items():
        if re.search(rf"\b{symbol}\b", name):
            return kernel
    return None


class Row(NamedTuple):
    name: str
    ms: float          # summed duration per iteration
    calls: float       # events per iteration
    launched_by: str


class Gap(NamedTuple):
    """The device's idle gaps put down to one range, per iteration."""

    range: str
    ms: float
    gaps: float


class Summary(NamedTuple):
    """A trace's device ops, per iteration of `iters`: rows by time,
    descending; the summed durations (`total_ms`), the union of their
    intervals (`busy_ms`); over the whole trace the span from the first
    device event's start to the last one's end, the kernel events, each
    port kernel's events, and the device's idle by program range
    (`idle_ranges`)."""

    rows: list
    total_ms: float
    busy_ms: float
    span_ms: float
    kernels: int
    port_events: dict = {}
    idle: tuple = ()

    def row(self, kernel: str) -> Row | None:
        """The row of a port kernel (a key of SYMBOLS), None if it did
        not run."""
        return next((r for r in self.rows if port_kernel(r.name) == kernel),
                    None)


def newest_trace(path: str) -> str:
    """`path` if it is a file, else the newest Chrome trace under the
    directory `path`: this tool's trace.json.gz, or the *.pt.trace.json of
    torch's tensorboard_trace_handler (the Trainer's profile window)."""
    if os.path.isfile(path):
        return path
    found = [p for ext in ("*trace.json", "*trace.json.gz")
             for p in glob.glob(os.path.join(path, "**", ext),
                                recursive=True)]
    if not found:
        raise FileNotFoundError(f"no Chrome trace under {path}")
    return max(found, key=os.path.getmtime)


def load_events(path: str) -> list[dict]:
    """The traceEvents of a Chrome trace file (gzipped where it ends in
    .gz) or of the newest one under a directory."""
    path = newest_trace(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def union_ms(spans) -> float:
    """The length in ms of the union of (start, end) intervals in us."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _dims(dim) -> str:
    """One input's dims: [8, 64] -> '8x64'; a tensor list's [[8, 64],
    [8, 64]] -> '[8x64, 8x64]'."""
    if dim and isinstance(dim[0], list):
        return f"[{', '.join(_dims(d) for d in dim)}]"
    return "x".join(str(d) for d in dim)


def _shapes(dims) -> str:
    """aten input dims [[8, 64, 200], [], ...] -> ' (8x64x200, ...)', the
    scalars left out."""
    parts = [_dims(dim) for dim in dims or () if dim]
    return f" ({', '.join(parts)})" if parts else ""


def short_name(name: str) -> str:
    """A device op's name for the table: without the leading 'void ' and
    the at::native:: and anonymous-namespace qualifiers, cut to
    NAME_WIDTH."""
    name = name.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "")[:NAME_WIDTH]


def _attribution(events: list[dict]):
    """-> fn(device event) -> what launched it: the port kernel's source,
    else the aten op linked to its launch (by the launch's correlation
    id, then the op's External id), else ''."""
    ops, launches = {}, {}
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "cpu_op" and "External id" in args:
            ops[args["External id"]] = (e.get("name", "?")
                                        + _shapes(args.get("Input Dims")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = args.get("External id")

    def launched_by(e: dict) -> str:
        kernel = port_kernel(e.get("name", ""))
        if kernel is not None:
            return source_path(kernel)
        args = e.get("args") or {}
        ext = launches.get(args.get("correlation"))
        if ext not in ops:
            ext = args.get("External id")
        return ops.get(ext, "")[:OP_WIDTH]

    return launched_by


def parse_trace(source, iters: int) -> Summary:
    """Aggregate the device ops of a Chrome trace (a path, or its
    traceEvents) over `iters` iterations. Raises where the trace holds no
    device event: a profile of the card without CUPTI's records is not a
    measurement."""
    events = load_events(source) if isinstance(source, str) else source
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS and "dur" in e
              and card.PRIMER_SYMBOL not in e.get("name", "")]
    if not device:
        raise RuntimeError(
            "the trace holds no device event (kernel, gpu_memcpy, "
            "gpu_memset): CUPTI recorded nothing on the card")
    launched_by = _attribution(events)
    ms = collections.defaultdict(float)
    calls = collections.Counter()
    by = collections.defaultdict(collections.Counter)
    for e in device:
        name = e.get("name", "?")
        ms[name] += float(e["dur"]) / 1e3
        calls[name] += 1
        by[name][launched_by(e)] += 1
    rows = []
    for name in sorted(ms, key=lambda n: -ms[n]):
        (top, _), others = by[name].most_common(1)[0], len(by[name]) - 1
        rows.append(Row(name, ms[name] / iters, calls[name] / iters,
                        top + (f" (+{others} other ops)" if others else "")))
    # from the first start: the absolute timestamps (~1e12 us) would
    # round the union's sum past the durations' own
    t0 = min(float(e["ts"]) for e in device)
    spans = [(float(e["ts"]) - t0, float(e["ts"]) - t0 + float(e["dur"]))
             for e in device]
    return Summary(rows=rows, total_ms=sum(ms.values()) / iters,
                   busy_ms=union_ms(spans) / iters,
                   span_ms=max(b for _, b in spans) / 1e3,
                   kernels=sum(1 for e in device if e["cat"] == "kernel"),
                   port_events=dict(collections.Counter(
                       k for k in (port_kernel(e.get("name", ""))
                                   for e in device) if k is not None)),
                   idle=tuple(idle_ranges(events, spans, t0, iters)))


def idle_ranges(events: list[dict], spans, t0: float,
                iters: int) -> list[Gap]:
    """The device's idle gaps between its first op and its last (between
    the merged intervals of `spans`, in us from t0), each put down to the
    innermost program range (`voxelnet.*`, tracing.py) that covers its
    midpoint on the trace's clock, OUTSIDE where none does -> the Gaps
    by time, descending."""
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation" and "dur" in e
              and e.get("name", "").startswith(RANGE_PREFIX)]
    start = np.array([float(e["ts"]) - t0 for e in ranges])
    stop = start + np.array([float(e["dur"]) for e in ranges])
    ms = collections.defaultdict(float)
    count = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.flatnonzero((start <= mid) & (stop >= mid))
        name = (ranges[cover[np.argmin(stop[cover] - start[cover])]]["name"]
                if len(cover) else OUTSIDE)
        ms[name] += (b - a) / 1e3
        count[name] += 1
    return [Gap(n, ms[n] / iters, count[n] / iters)
            for n in sorted(ms, key=lambda n: -ms[n])]


def cpu_summary(prof, iters: int) -> Summary:
    """The CPU ops of a CPU-only profile by self CPU time per iteration,
    with their input shapes (no device: busy and span are 0)."""
    events = [e for e in prof.key_averages(group_by_input_shape=True)
              if e.self_cpu_time_total > 0]
    events.sort(key=lambda e: -e.self_cpu_time_total)
    rows = [Row(e.key, e.self_cpu_time_total / 1e3 / iters, e.count / iters,
                _shapes(e.input_shapes).strip()[:OP_WIDTH]) for e in events]
    return Summary(rows=rows, total_ms=sum(r.ms for r in rows), busy_ms=0.0,
                   span_ms=0.0, kernels=0)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_calls(fn, args, logdir: str, iters: int,
                device: torch.device, prime: bool = False):
    """One warm-up fn(*args), then `iters` calls under torch.profiler
    (CPU, and CUDA on a card; input shapes recorded) closed by a sync; the
    Chrome trace written to <logdir>/trace.json.gz -> (host wall seconds
    per iteration, the trace's path, the profile). `prime` on the card:
    the window opens with tools/card.py's primer, and is taken again, up
    to card.ATTEMPTS windows, while a port kernel's events in the trace
    differ from the launches its wrapper counted; then it raises."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    sync(device)
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json.gz")
    checked = prime and on_card
    for _ in range(card.ATTEMPTS if checked else 1):
        before = launch_counts()
        with profile(activities=activities, record_shapes=True) as prof:
            if checked:
                card.prime()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            sync(device)
            wall = (time.perf_counter() - t0) / iters
        prof.export_chrome_trace(path)
        if not checked:
            return wall, path, prof
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        got = parse_trace(path, iters).port_events
        lost = {k: f"{got.get(k, 0)} events of {n} launches"
                for k, n in launched.items() if got.get(k, 0) != n}
        if not lost:
            return wall, path, prof
    raise RuntimeError(f"torch.profiler lost port kernel events in "
                       f"{card.ATTEMPTS} windows, the last: {lost}")


class Section(NamedTuple):
    title: str
    wall_ms: float     # host wall per iteration, under the profiler
    summary: Summary


def trace_stage(tag: str, title: str, stage, batch, logdir: str, iters: int,
                device: torch.device) -> Section:
    """Trace `stage` (a bench.Stage) on one host batch (points,
    num_points) -> its Section."""
    args = tuple(torch.as_tensor(a, device=device)
                 for a in stage.prep(*batch))

    def traced(*inputs):
        return stage.fn(*inputs, [])

    wall, path, prof = trace_calls(traced, args, os.path.join(logdir, tag),
                                   iters, device, prime=True)
    summary = (parse_trace(path, iters) if device.type == "cuda"
               else cpu_summary(prof, iters))
    return Section(title, wall * 1e3, summary)


def _cell(text: str) -> str:
    return text.replace("|", "\\|")


def write_summary(path: str, header: str, sections: list[Section],
                  top: int, on_card: bool) -> None:
    """The markdown summary: `header`, then per section its totals line,
    the `top` rows and every later row of a port kernel."""
    with open(path, "w") as f:
        f.write(header)
        for title, wall_ms, s in sections:
            f.write(f"\n## {title}\n\n")
            if on_card:
                f.write(f"**device op total {s.total_ms:.3f} ms/iter**; "
                        f"busy {s.busy_ms:.3f} ms/iter (the union of the "
                        f"device ops' intervals); host wall {wall_ms:.3f} "
                        f"ms/iter under the profiler; idle share "
                        f"{1 - s.busy_ms / wall_ms:.3f} (1 - busy / wall); "
                        f"{s.kernels} kernel events in the trace.\n\n"
                        "| op | launched by | ms/iter | % | calls |\n")
            else:
                f.write(f"**CPU op self total {s.total_ms:.3f} ms/iter**; "
                        f"host wall {wall_ms:.3f} ms/iter under the "
                        "profiler.\n\n"
                        "| op | input shapes | self CPU ms/iter | % | calls "
                        "|\n")
            f.write("|---|---|---|---|---|\n")
            for r in s.rows[:top] + [r for r in s.rows[top:]
                                     if port_kernel(r.name)]:
                f.write(f"| `{_cell(short_name(r.name))}` | "
                        f"{_cell(r.launched_by)} | {r.ms:.4f} | "
                        f"{100 * r.ms / max(s.total_ms, 1e-12):.1f}% | "
                        f"{r.calls:g} |\n")
            if s.idle:
                idle = sum(g.ms for g in s.idle)
                f.write(f"\n**Device idle {idle:.3f} ms/iter** between "
                        "its first op and its last, each gap put down to "
                        "the innermost program range over its midpoint:\n\n"
                        "| range | idle ms/iter | % | gaps/iter |\n"
                        "|---|---|---|---|\n")
                for g in s.idle:
                    f.write(f"| {_cell(g.range)} | {g.ms:.4f} | "
                            f"{100 * g.ms / max(idle, 1e-12):.1f}% | "
                            f"{g.gaps:g} |\n")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("profiles", "torch"),
                    help="directory of the summary and of traces/ (not "
                         "'profiles', whose trace_summary.md is the JAX "
                         "package's TPU record)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--stage", default="both",
                    choices=("infer", "train", "both"))
    ap.add_argument("--host-voxelize", action="store_true",
                    help="train stage: feed voxel tables built on the host "
                         "(train.host_voxelize) instead of raw points; the "
                         "run-copy table drops out of the step")
    ap.add_argument("--middle-backend", default=None,
                    help="override data.middle_backend ('sparse1': block 1 "
                         "from the voxel table; every other value runs the "
                         "Conv3D middle)")
    ap.add_argument("--out-md", default="trace_summary.md",
                    help="summary filename under --out (use a distinct "
                         "name for variant configs so the committed "
                         "default-config summary is not clobbered)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default), or the CPU, where the CPU ops "
                         "are listed instead of device ops")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.iters < 1:
        ap.error("--batch and --iters must be >= 1")
    return args


def main(argv=None) -> list[Section]:
    args = parse_args(argv)
    device = _device(args.device)
    on_card = device.type == "cuda"
    overrides = ({"data": {"middle_backend": args.middle_backend}}
                 if args.middle_backend else {})
    config = get_config("Car", **overrides)
    os.makedirs(args.out, exist_ok=True)
    logdir = os.path.join(args.out, "traces")
    spec = (VoxelGridSpec.from_object_config(config.object)
            if config.data.crop_to_grid else None)
    batch = load_frames(config.data.max_points, args.batch, spec=spec)[0]

    sections = []
    if args.stage in ("infer", "both"):
        stage = make_stage_fn("infer", config, device=device,
                              batch=args.batch)
        sections.append(trace_stage(
            "infer", f"inference (full graph) (batch {args.batch})", stage,
            batch, logdir, args.iters, device))
    if args.stage in ("train", "both"):
        train_config = (get_config("Car", **overrides,
                                   train={"host_voxelize": True})
                        if args.host_voxelize else config)
        stage = make_stage_fn("train", train_config,
                              host_voxelize=args.host_voxelize,
                              device=device, batch=args.batch)
        title = ("train step (fwd+bwd+SGD, host voxels)"
                 if args.host_voxelize else "train step (fwd+bwd+SGD)")
        sections.append(trace_stage(
            "train", f"{title} (batch {args.batch})", stage, batch, logdir,
            args.iters, device))

    if on_card:
        from voxelnet_tpu_torch.tools.card import card_line

        what = (f"{card_line()}; torch {torch.__version__}, CUDA "
                f"{torch.version.cuda}")
        kind = ("Device ops are the trace's `kernel`, `gpu_memcpy` and "
                "`gpu_memset` events. \"launched by\" is the aten op, with "
                "its input shapes, that the profiler links to the op's "
                "launch; the port's own kernels are launched through "
                "ctypes under no aten op and are named by their source. "
                "Each window opens with tools/card.py's primer (left out) "
                "and holds every port kernel's launches. The busy time is "
                "the union of the device ops' intervals. The program "
                "traces its calls (tracing.py): each span is a "
                "`voxelnet.<name>` range, and the idle table puts each gap "
                "between device ops to the innermost one over its "
                "midpoint.")
    else:
        what = f"the CPU; torch {torch.__version__}"
        kind = ("`--device cpu`: the table lists CPU ops by self CPU time; "
                "no device was measured.")
    header = (f"# torch.profiler trace summary (batch {args.batch}, "
              f"{args.iters} iters/graph)\n\n"
              f"{what}. middle_backend="
              f"{args.middle_backend or config.data.middle_backend} "
              f"(the port runs middle[{resolve_plan(config).middle}]); "
              f"traces under {logdir}/ (not committed). Written by "
              f"`python -m voxelnet_tpu_torch.tools.profile_step "
              f"{' '.join(argv if argv is not None else sys.argv[1:])}`."
              f"\n\n{kind}\n")
    out_md = os.path.join(args.out, args.out_md)
    write_summary(out_md, header, sections, args.top, on_card)
    print(f"wrote {out_md}")
    for title, wall_ms, s in sections:
        print(f"{title}: wall {wall_ms:.3f} ms/iter, "
              + (f"device op total {s.total_ms:.3f}, busy {s.busy_ms:.3f} "
                 "ms/iter" if on_card else
                 f"CPU op self total {s.total_ms:.3f} ms/iter"))
    return sections


if __name__ == "__main__":
    main()
