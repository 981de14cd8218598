"""The port's trace summary (voxelnet_tpu_torch/tools/profile_step.py), the
counterpart of scripts/profile_step.py: its parser on hand-made Chrome
traces of the card (device ops, busy time, per-iteration division, order,
what launched each op), its refusal of a card trace without device
events, and its main on the CPU at a tiny grid."""

import gzip
import json
import os
import re

import pytest
import torch
from torch_port_helpers import TINY, merged
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch import kernels
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.tools import profile_step

# the tiny grid moved 12.8 m ahead, so that the bench's GT box at x = 20 m
# lies inside it (tests/test_torch_bench.py)
STAGE = merged(TINY, object={"x_min": 12.8, "x_max": 25.6})
PID, TID = 1, 11


def cpu_op(name, ts, dur, ext, dims):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": PID, "tid": TID,
            "ts": ts, "dur": dur,
            "args": {"External id": ext, "Input Dims": dims}}


def launch(ts, corr, ext=None, name="cudaLaunchKernel"):
    args = {"correlation": corr}
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": PID,
            "tid": TID, "ts": ts, "dur": 2.0, "args": args}


def device(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr, "device": 0}}


def card_trace():
    """Two iterations of: a conv (two overlapping kernels of one aten
    op), a memcpy and a memset, and a port kernel launched through
    ctypes under no aten op. Times in us."""
    events = [{"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "cuda:0"}}]
    for it, t in enumerate((0.0, 1000.0)):
        c = 10 * it
        events += [
            cpu_op("aten::cudnn_convolution", t, 50.0, 100 + it,
                   [[8, 128, 10, 400, 352], [64, 128, 3, 3, 3], []]),
            launch(t + 5, c + 1, 100 + it),
            launch(t + 10, c + 2, 100 + it),
            cpu_op("aten::copy_", t + 60, 20.0, 200 + it, [[8, 64], [8, 64]]),
            launch(t + 62, c + 3, 200 + it, "cudaMemcpyAsync"),
            launch(t + 70, c + 4, None, "cudaMemsetAsync"),
            launch(t + 80, c + 5, None),
            # sm80_xmma 300 us and a second conv kernel 100 us, overlapping
            # by 50 us: busy 350, total 400
            device("kernel", "sm80_xmma_fprop_implicit_gemm", t + 100,
                   300.0, c + 1),
            device("kernel", "cudnn::winograd_kernel", t + 350, 100.0, c + 2),
            device("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t + 500,
                   40.0, c + 3),
            device("gpu_memset", "Memset (Device)", t + 560, 10.0, c + 4),
            device("kernel", "vfe_fused_kernel(float const*, int const*, "
                   "int const*, float const*, float*, int, int)", t + 600,
                   60.0, c + 5),
        ]
    return events


def test_parser_totals_busy_and_per_iteration():
    s = profile_step.parse_trace(card_trace(), iters=2)
    # per iteration: kernels 300 + 100 + 60, memcpy 40, memset 10 us
    assert s.total_ms == pytest.approx(0.510)
    # the two conv kernels overlap by 50 us: busy < total
    assert s.busy_ms == pytest.approx(0.460)
    assert s.busy_ms < s.total_ms
    assert s.span_ms == pytest.approx((1660.0 - 100.0) / 1e3)
    assert s.kernels == 6
    assert {r.name: r.calls for r in s.rows}[
        "Memset (Device)"] == 1
    assert all(r.calls == 1 for r in s.rows)


def test_parser_busy_at_the_cards_timestamps():
    """At a card's absolute timestamps (~1.4e12 us) a trace of kernels
    that do not overlap reads busy equal to its op total, not above it."""
    events = [e for e in card_trace()
              if e.get("name") != "cudnn::winograd_kernel"]
    for i, e in enumerate(events):
        if "ts" in e:
            e["ts"] += 1406803215346.654
        if e.get("cat") in profile_step.DEVICE_CATS:
            e["dur"] += 0.137 + 0.011 * i
    s = profile_step.parse_trace(events, iters=2)
    assert s.total_ms == pytest.approx(0.411208)
    assert s.busy_ms <= s.total_ms * (1 + 1e-9)
    assert s.busy_ms == pytest.approx(s.total_ms, rel=1e-9)


def test_parser_counts_memcpy_and_memset():
    rows = {r.name: r for r in profile_step.parse_trace(card_trace(), 2).rows}
    assert rows["Memcpy HtoD (Pinned -> Device)"].ms == pytest.approx(0.040)
    assert rows["Memset (Device)"].ms == pytest.approx(0.010)


def test_parser_orders_rows_by_time():
    s = profile_step.parse_trace(card_trace(), iters=2)
    assert [r.name for r in s.rows][:3] == [
        "sm80_xmma_fprop_implicit_gemm", "cudnn::winograd_kernel",
        s.rows[2].name]
    assert s.rows[2].name.startswith("vfe_fused_kernel")
    assert [r.ms for r in s.rows] == sorted((r.ms for r in s.rows),
                                            reverse=True)


def test_parser_launched_by_the_correlated_aten_op():
    rows = {r.name: r for r in profile_step.parse_trace(card_trace(), 2).rows}
    conv = ("aten::cudnn_convolution (8x128x10x400x352, 64x128x3x3x3)")
    assert rows["sm80_xmma_fprop_implicit_gemm"].launched_by == conv
    assert rows["cudnn::winograd_kernel"].launched_by == conv
    assert rows["Memcpy HtoD (Pinned -> Device)"].launched_by == (
        "aten::copy_ (8x64, 8x64)")
    # a launch under no aten op
    assert rows["Memset (Device)"].launched_by == ""


def test_parser_names_a_kernel_of_two_ops():
    events = card_trace()
    for e in events:
        if e.get("cat") == "cuda_runtime" and e["args"]["correlation"] == 12:
            e["args"]["External id"] = 201
    rows = {r.name: r for r in profile_step.parse_trace(events, 2).rows}
    assert rows["cudnn::winograd_kernel"].launched_by.endswith(
        "(+1 other ops)")


@pytest.mark.parametrize("kernel", sorted(kernels.SYMBOLS))
def test_port_kernel_symbol_maps_to_its_source(kernel):
    """Each port kernel's `__global__` symbol, as CUPTI names its launch,
    maps to the kernel and to its csrc/*.cu, which defines it."""
    symbol = kernels.SYMBOLS[kernel]
    name = f"(anonymous namespace)::{symbol}(float const*, int)"
    assert profile_step.port_kernel(name) == kernel
    assert profile_step.port_kernel("void " + symbol + "<true>(int)") == kernel
    assert profile_step.port_kernel(symbol + "_other(int)") is None
    path = kernels.source_path(kernel)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, path)) as f:
        src = f.read()
    assert re.search(rf"__global__[^;{{]*\b{symbol}\(", src), path
    events = [launch(0.0, 1, None),
              device("kernel", f"{symbol}(float const*)", 10.0, 5.0, 1)]
    s = profile_step.parse_trace(events, iters=1)
    assert s.rows[0].launched_by == path
    assert s.row(kernel) is s.rows[0]


def test_every_kernel_has_a_source_and_replaces():
    assert set(kernels.SYMBOLS) == set(kernels.REPLACES)
    assert kernels.KERNELS == tuple(kernels.SYMBOLS)
    for kernel in kernels.SYMBOLS:
        src = kernels.SOURCE.get(kernel, kernel)
        assert src in kernels.SOURCES


def test_launch_counts_read_and_reset_every_wrapper(monkeypatch):
    """launch_counts reads each wrapper's own counter, once per kernel of
    KERNELS, and reset_launches zeroes them all."""
    from voxelnet_tpu_torch.kernels import (dense_build, run_copy,
                                            sparse_conv, vfe_fused)

    counters = {"vfe_fused": (vfe_fused, "launches"),
                "dense_build": (dense_build, "launches"),
                "run_copy": (run_copy, "launches"),
                "sparse_conv": (sparse_conv, "launches"),
                "sparse_conv_grad": (sparse_conv, "grad_launches"),
                "occupancy_map": (sparse_conv, "occupancy_launches")}
    assert set(counters) == set(kernels.KERNELS)
    for n, (module, attr) in enumerate(counters.values(), start=1):
        monkeypatch.setattr(module, attr, n)
    assert kernels.launch_counts() == {
        k: n for n, k in enumerate(counters, start=1)}
    kernels.reset_launches()
    assert kernels.launch_counts() == dict.fromkeys(counters, 0)


def test_card_trace_without_device_events_raises():
    events = [e for e in card_trace()
              if e.get("cat") not in profile_step.DEVICE_CATS]
    with pytest.raises(RuntimeError, match="no device event"):
        profile_step.parse_trace(events, iters=2)


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_parser_reads_the_newest_trace_file(tmp_path, suffix):
    old = tmp_path / f"a.pt.trace{suffix}"
    new = tmp_path / "sub" / f"trace{suffix}"
    other = tmp_path / f"metrics{suffix}"
    new.parent.mkdir()
    for path, events in ((old, []), (new, card_trace()), (other, [])):
        opener = gzip.open if suffix.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump({"traceEvents": events}, f)
    os.utime(old, (1, 1))
    os.utime(new, (2, 2))
    assert profile_step.newest_trace(str(tmp_path)) == str(new)
    s = profile_step.parse_trace(str(tmp_path), iters=2)
    assert s.total_ms == pytest.approx(0.510)


def test_union_of_intervals():
    assert profile_step.union_ms([(0, 10), (5, 20), (30, 40)]) == 0.03
    assert profile_step.union_ms([(0, 10), (2, 3)]) == 0.01


def test_summary_lists_every_port_kernel(tmp_path):
    """The table holds the top rows and, past them, every port kernel's
    row (here vfe_fused's, third by time), with its source."""
    s = profile_step.parse_trace(card_trace(), iters=2)
    path = tmp_path / "summary.md"
    section = profile_step.Section("inference (batch 8)", 2.0, s)
    profile_step.write_summary(str(path), "# head\n", [section], 1, True)
    lines = path.read_text().splitlines()
    rows = [line for line in lines if line.startswith("| `")]
    assert rows[0].startswith("| `sm80_xmma_fprop_implicit_gemm` | "
                              "aten::cudnn_convolution (8x128x10x400x352, "
                              "64x128x3x3x3) | 0.3000 | 58.8% | 1 |")
    assert len(rows) == 2 and rows[1].startswith(
        "| `vfe_fused_kernel(float const*, int const*, int const*, float "
        "const*, float*, int, int)` | voxelnet_tpu_torch/csrc/vfe_fused.cu |")
    assert lines[2].startswith("## inference (batch 8)")
    assert "**device op total 0.510 ms/iter**; busy 0.460 ms/iter" in (
        path.read_text())
    assert "idle share 0.770 (1 - busy / wall)" in path.read_text()


def test_default_out_keeps_the_jax_summary():
    """The default --out is not profiles/, where the JAX package's TPU
    trace_summary.md lives."""
    args = profile_step.parse_args([])
    assert os.path.normpath(args.out) == os.path.join("profiles", "torch")
    assert os.path.normpath(args.out) != "profiles"
    assert (args.batch, args.iters, args.stage, args.top, args.device) == (
        8, 3, "both", 25, "cuda")


def test_main_on_the_cpu_writes_both_sections(tmp_path, monkeypatch):
    """main at the tiny grid on the CPU: the bench's infer and train stages
    traced, the summary with both sections and their CPU tables, the
    Chrome traces under <out>/traces/."""
    def get(class_name, **more):
        out = merged(STAGE)
        for group, values in more.items():
            out.setdefault(group, {}).update(values)
        return get_config(class_name, **out)

    monkeypatch.setattr(profile_step, "get_config", get)
    argv = ["--device", "cpu", "--out", str(tmp_path), "--batch", "2",
            "--iters", "2", "--top", "5"]
    sections = profile_step.main(argv)
    assert [s.title for s in sections] == [
        "inference (full graph) (batch 2)",
        "train step (fwd+bwd+SGD) (batch 2)"]
    for s in sections:
        assert 0 < s.summary.total_ms and s.wall_ms > 0
        assert s.summary.rows[0].name.startswith("aten::")
    with open(tmp_path / "trace_summary.md") as f:
        text = f.read()
    assert text.startswith("# torch.profiler trace summary (batch 2, 2 "
                           "iters/graph)")
    assert "`--device cpu`: the table lists CPU ops by self CPU time" in text
    assert text.count("| op | input shapes | self CPU ms/iter | % | calls |"
                      ) == 2
    assert "## inference (full graph) (batch 2)" in text
    assert "## train step (fwd+bwd+SGD) (batch 2)" in text
    assert text.count("| `aten::") == 10
    for tag in ("infer", "train"):
        assert os.path.exists(tmp_path / "traces" / tag / "trace.json.gz")


def test_main_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="sees no CUDA"):
        profile_step.main(["--stage", "infer"])


def annotation(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": TID,
            "ts": ts, "dur": dur}


def test_idle_gaps_go_to_the_innermost_program_range(tmp_path):
    """Device ops at 0-10, 30-40, 100-110 and 150-160 us under the
    program's ranges voxelnet.infer (0-120) and voxelnet.nms (35-90) on
    the host: the gap 10-30 goes to infer, 40-100 (midpoint 70) to nms,
    110-150 (midpoint 130) outside the program. The primer's spin kernel
    before them is left out, and so is the ranges' device-side copy."""
    base = 1406803215346.654
    events = [annotation("voxelnet.infer", base, 120.0),
              annotation("voxelnet.nms", base + 35, 55.0),
              annotation("voxelnet.infer", base + 10, 150.0,
                         "gpu_user_annotation"),
              device("kernel", "spin_kernel(long)", base - 50, 10.0, 9)]
    for i, t in enumerate((0.0, 30.0, 100.0, 150.0)):
        name = "vfe_fused_kernel(int)" if t == 100.0 else f"k{i}"
        events.append(device("kernel", name, base + t, 10.0, i))
    s = profile_step.parse_trace(events, iters=1)
    assert s.kernels == 4 and s.total_ms == pytest.approx(0.040)
    assert s.port_events == {"vfe_fused": 1}
    assert [g.range for g in s.idle] == ["voxelnet.nms",
                                         profile_step.OUTSIDE,
                                         "voxelnet.infer"]
    assert [g.ms for g in s.idle] == pytest.approx([0.060, 0.040, 0.020])
    assert [g.gaps for g in s.idle] == [1, 1, 1]
    halved = profile_step.parse_trace(events, iters=2)
    assert [g.ms for g in halved.idle] == pytest.approx([0.030, 0.020,
                                                         0.010])
    path = tmp_path / "summary.md"
    profile_step.write_summary(str(path), "# head\n", [
        profile_step.Section("inference (batch 8)", 1.0, s)], 5, True)
    text = path.read_text()
    assert "**Device idle 0.120 ms/iter**" in text
    assert "| voxelnet.nms | 0.0600 | 50.0% | 1 |" in text
    assert f"| {profile_step.OUTSIDE} | 0.0400 | 33.3% | 1 |" in text
