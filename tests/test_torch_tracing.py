"""The port's in-memory spans and counters (voxelnet_tpu_torch/tracing.py)
on the CPU at the tiny grid: nothing recorded without `marks`, the
`marks` contract the benchmark reads, the spans' nesting and self time,
NMS's and the batch-norms' spans and counters, the ring, and the
benchmark's readers of them (benchmarks/metrics/)."""

import collections
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch_port_helpers import TINY
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)
from torch.utils._python_dispatch import TorchDispatchMode

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.models import bn as bn_mod
from voxelnet_tpu_torch.models.voxelnet import (STAGES, build_model,
                                                make_inference_fn)
from voxelnet_tpu_torch.ops import nms
from voxelnet_tpu_torch.training.train_step import (TRAIN_STAGES,
                                                    create_train_state,
                                                    make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the stage names of the marks, in order, as the benchmark's per-layer
# metrics read them
INFER_MARKS = ["start", "prepare", "vfe", "dense", "middle", "rpn",
               "decode", "nms"]
TRAIN_MARKS = ["start", "voxelize", "targets", "forward", "loss",
               "backward", "all_reduce", "update"]
B, N = 2, 1500


@pytest.fixture(autouse=True)
def fresh_ring(monkeypatch):
    monkeypatch.setattr(tracing, "_ring",
                        collections.deque(maxlen=tracing.RING))
    assert tracing.current is None


@pytest.fixture(scope="module")
def setup():
    # every anchor over the gate: NMS has candidates on random weights
    cfg = get_config("Car", **dict(TINY, rpn={"score_thres": 0.0}))
    rng = np.random.default_rng(0)
    pts = np.zeros((B, cfg.data.max_points, 4), np.float32)
    pts[:, :N] = np.concatenate([
        rng.uniform([0.0, -6.4, -3.0], [12.8, 6.4, 1.0], (B, N, 3)),
        rng.uniform(0.0, 1.0, (B, N, 1))], -1)
    num = np.full(B, N, np.int32)
    gt = np.zeros((B, cfg.data.max_gt_boxes, 7), np.float32)
    gt[:, 0] = [6.0, 0.0, -1.0, 1.56, 1.6, 3.9, 0.3]
    gt_mask = np.zeros((B, cfg.data.max_gt_boxes), bool)
    gt_mask[:, 0] = True
    batch = {"points": pts, "num_points": num, "gt_boxes": gt,
             "gt_mask": gt_mask}
    return types.SimpleNamespace(
        cfg=cfg, model=build_model(cfg, seed=0),
        infer=make_inference_fn(cfg, "cpu"), batch=batch)


def train_step(s, marks=None):
    model = build_model(s.cfg, seed=1)
    state = create_train_state(s.cfg, model, device="cpu")
    make_train_step(s.cfg, "cpu")(state, s.batch, marks)
    return model


class Ops(TorchDispatchMode):
    """The aten ops dispatched under it, counted."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


class Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("created with tracing off")


def profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_adds_no_work(setup, monkeypatch):
    """marks=None, under a profiler: no record, no CUDA event, no
    profiler range, and the same aten ops as a traced call less its
    ranges and the live-pair count's three."""
    b = setup.batch
    # the first call with the model folds its batch-norms
    setup.infer(setup.model, b["points"], b["num_points"])
    with profiled(), Ops() as on:
        setup.infer(setup.model, b["points"], b["num_points"], [])
    assert len(tracing.recent(1)) == 1
    monkeypatch.setattr(torch.cuda, "Event", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(tracing, "Call", Refused)
    monkeypatch.setattr(tracing, "Span", Refused)
    with profiled(), Ops() as off:
        setup.infer(setup.model, b["points"], b["num_points"])
    train_step(setup)
    assert tracing.current is None
    assert len(tracing._ring) == 1
    # the traced call's ten spans open a profiler range each
    assert on.ops - off.ops == {
        "aten.sum": 2, "aten.mul": 1,
        "profiler._record_function_enter_new": 10,
        "profiler._record_function_exit": 10}
    assert not off.ops - on.ops


def test_marks_keep_the_stage_contract(setup):
    from benchmarks.harness import core

    b = setup.batch
    marks = [[], []]
    for m in marks:
        setup.infer(setup.model, b["points"], b["num_points"], m)
    assert [[n for n, _ in m] for m in marks] == [INFER_MARKS] * 2
    assert INFER_MARKS[1:] == list(STAGES)
    means = core.stage_means(marks, STAGES)
    assert list(means) == list(STAGES)
    assert all(v >= 0 for v in means.values()) and means["middle"] > 0
    step = []
    train_step(setup, step)
    assert [n for n, _ in step] == TRAIN_MARKS
    assert TRAIN_MARKS[1:] == list(TRAIN_STAGES)
    assert core.stage_means([step], TRAIN_STAGES)["backward"] > 0
    # each stage's mark is its span's end
    call = tracing.recent(1)[0]
    assert [s.t1 / 1e9 for s in (call.named(n)[0] for n in TRAIN_STAGES)
            ] == [t for _, t in step[1:]]


def test_ranges_only_under_a_profiler(setup):
    """Each span is a `voxelnet.<name>` range of a profile, and records
    no range where no profiler runs."""
    b = setup.batch
    with Ops() as ops:
        setup.infer(setup.model, b["points"], b["num_points"], [])
    assert not [op for op in ops.ops if op.startswith("profiler.")]
    assert len(tracing.recent(1)[0].spans) == 10
    with profiled() as prof:
        setup.infer(setup.model, b["points"], b["num_points"], [])
    ranges = collections.Counter(e.name for e in prof.events()
                                 if e.name.startswith("voxelnet."))
    assert ranges == {"voxelnet." + s.name: 1
                      for s in tracing.recent(1)[0].spans}


def test_spans_nest_under_one_call(setup):
    b = setup.batch
    setup.infer(setup.model, b["points"], b["num_points"], [])
    (call,) = tracing.recent(1)
    names = [s.name for s in call.spans]
    assert names == ["infer"] + INFER_MARKS[1:-1] + ["nms", "nms.iou",
                                                     "nms.greedy"]
    assert {s.call for s in call.spans} == {call.id}
    parents = [None if s.parent is None else call.spans[s.parent].name
               for s in call.spans]
    assert parents == [None] + ["infer"] * 7 + ["nms", "nms"]
    root, nms_span = call.spans[0], call.named("nms")[0]
    assert call.children(nms_span) == call.named("nms.iou") + call.named(
        "nms.greedy")
    kids = call.children(root)
    assert call.self_ns(root) == root.host_ns - sum(k.host_ns for k in kids)
    assert call.self_ns(call.named("nms.iou")[0]) == call.named(
        "nms.iou")[0].host_ns
    for s in call.spans:
        assert s.t0 <= s.t1 and s.device_ms() == s.host_ns / 1e6
        assert s.ev0 is None
    assert call.unix_ns(root.t0) - call.clock[1] == root.t0 - call.clock[0]


def test_self_time_is_the_duration_less_the_children():
    """Overlapping children are counted once, and only inside the span."""
    call = made("infer", [("infer", None, 0, 100), ("a", 0, 10, 40),
                          ("b", 0, 30, 50), ("c", 0, 90, 120),
                          ("d", 1, 15, 20)])
    root, a = call.spans[0], call.spans[1]
    assert call.self_ns(root) == 100 - 40 - 10
    assert call.self_ns(a) == 30 - 5


def chain(length: int, k: int):
    """An IoU matrix over k candidates in score order where each of the
    first `length` overlaps only its neighbours; those are valid."""
    mat = torch.zeros(1, k, k)
    i = torch.arange(length - 1)
    mat[0, i, i + 1] = mat[0, i + 1, i] = 0.9
    return mat, torch.arange(k)[None] < length


def plain_iterations(mat, valid, thresh: float) -> int:
    k = mat.shape[-1]
    over = [[mat[0, i, j] > thresh and i < j for j in range(k)]
            for i in range(k)]
    valid = valid[0].tolist()
    keep, prev, it = valid, [False] * k, 0
    while keep != prev:
        hit = [any(over[i][j] and keep[i] for i in range(k))
               for j in range(k)]
        keep, prev = [v and not h for v, h in zip(valid, hit)], keep
        it += 1
    return it


@pytest.mark.parametrize("length,depth", [(1, 1), (2, 2), (5, 5), (9, 9)])
def test_nms_iters_count_the_loop(length, depth):
    k = length + 3
    mat, valid = chain(length, k)
    assert plain_iterations(mat, valid, 0.5) == depth
    with tracing.call("infer", [], "cpu") as call:
        keep = nms.greedy_suppress(mat, valid, 0.5)
    assert keep[0].tolist() == [i < length and i % 2 == 0 for i in range(k)]
    assert call.count("nms.iters") == depth
    # one wait a test of the loop: each iteration's and the last's
    assert len(call.counters["host.wait_ns"]) == depth + 1
    assert call.count("host.wait_ns") > 0


def test_nms_counts_the_live_pairs():
    """Over the gate: 3 candidates of frame 0, 5 of frame 1; k = 8."""
    scores = torch.full((2, 20), 0.1)
    scores[0, :3] = 0.9
    scores[1, 5:10] = 0.8
    boxes = torch.zeros(2, 20, 7)
    boxes[..., 0] = torch.arange(20.0) * 10
    boxes[..., 3:6] = 1.0
    with tracing.call("infer", [], "cpu") as call:
        res = nms.nms_bev(boxes, scores, score_thresh=0.5, iou_thresh=0.5,
                          pre_topk=8, post_topk=6)
    assert res.valid.sum(-1).tolist() == [3, 5]
    assert call.count("nms.iou_pairs") == 2 * 8 * 8
    assert call.count("nms.iou_pairs_live") == 3 * 3 + 5 * 5
    assert isinstance(call.counters["nms.iou_pairs_live"][0], torch.Tensor)
    assert [s.name for s in call.spans] == ["infer", "nms.iou", "nms.greedy"]


def test_train_step_spans_each_batch_norm(setup, monkeypatch):
    calls = []
    norm = bn_mod._batch_norm

    def counted(bn, *args):
        calls.append(bn.training)
        return norm(bn, *args)

    monkeypatch.setattr(bn_mod, "_batch_norm", counted)
    model = train_step(setup, [])
    (call,) = tracing.recent(1)
    n = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for m in model.modules())
    assert calls == [True] * n and n == 25
    fwd, bwd = call.named("bn"), call.named("bn.backward")
    assert len(fwd) == len(bwd) == n
    assert all(s.t1 is not None for s in call.spans)
    assert {call.spans[s.parent].name for s in fwd} == {"forward"}
    assert {call.spans[s.parent].name for s in bwd} == {"backward"}
    back = call.named("backward")[0]
    assert all(back.t0 <= s.t0 <= s.t1 <= back.t1 for s in bwd)
    assert call.spans[0].name == "train"


def test_ring_drops_the_oldest_call():
    ids = []
    for _ in range(tracing.RING + 1):
        with tracing.call("infer", [], "cpu") as call:
            ids.append(call.id)
    assert tracing.RING >= 64
    assert [c.id for c in tracing.recent(tracing.RING)] == ids[1:]
    assert [c.id for c in tracing.recent(2)] == ids[-2:]
    with pytest.raises(ValueError, match="kept"):
        tracing.recent(tracing.RING + 1)
    # an inference function inside a call adds to it
    with tracing.call("train", [], "cpu") as outer:
        assert tracing.call("infer", [], "cpu") is tracing.OFF
    assert tracing.recent(1) == [outer]


def made(root: str, spans, counters=None) -> tracing.Call:
    """A call record by hand, in the ring: spans (name, parent, host start
    ns, host end ns), counters name -> [values]."""
    call = tracing.Call(root, "cpu")
    for name, parent, t0, t1 in spans:
        s = object.__new__(tracing.Span)
        s.name, s.call, s.parent, s.t0, s.t1 = name, call.id, parent, t0, t1
        s.ev0 = s.ev1 = None
        call.spans.append(s)
    call.counters = {k: list(v) for k, v in (counters or {}).items()}
    tracing._ring.append(call)
    return call


def reader(metric: str):
    from benchmarks.harness import core

    return core.load_module(
        os.path.join(REPO, "benchmarks", "metrics", f"{metric}.py"),
        f"test_metric_{metric.replace('.', '_')}")


def infer_record(iters, pairs, live, wait_ms, root_ms):
    made("infer", [("infer", None, 0, int(root_ms * 1e6)),
                   ("nms", 0, 10, 20)],
         {"nms.iters": [iters], "nms.iou_pairs": [pairs],
          "nms.iou_pairs_live": [torch.tensor(live)],
          "host.wait_ns": [int(wait_ms * 1e6 / 2)] * 2})


def train_record(bn_ms):
    made("train", [("train", None, 0, 10 ** 9), ("forward", 0, 0, 10 ** 8)]
         + [("bn", 1, 0, int(ms * 1e6)) for ms in bn_ms[:-1]]
         + [("bn.backward", 0, 0, int(bn_ms[-1] * 1e6))])


READINGS = {"nms_iters.infer": 4.0, "nms_iou_useful.infer": 25.0,
            "host_wait_ms.infer": 3.0, "host_busy_ms.infer": 12.0,
            "bn_ms.train": 4.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_readers_on_hand_made_records(metric, monkeypatch):
    read = reader(metric).read
    infer_record(3, 128, 34, 2.0, 10.0)
    infer_record(5, 128, 30, 4.0, 20.0)
    train_record([1.0, 2.0, 3.0])
    train_record([1.5, 0.5])
    infer_cell = metric.endswith(".infer")
    r = types.SimpleNamespace(calls=2)
    # the traced window is the last r.calls calls of the ring
    assert read(r) == (None if infer_cell else READINGS[metric])
    infer_record(3, 128, 34, 2.0, 10.0)
    infer_record(5, 128, 30, 4.0, 20.0)
    assert read(r) == (READINGS[metric] if infer_cell else None)
    assert read(types.SimpleNamespace(calls=tracing.RING + 1)) is None
    # a program without the recorder
    import voxelnet_tpu_torch

    monkeypatch.delattr(voxelnet_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "voxelnet_tpu_torch.tracing", None)
    assert read(r) is None


def test_new_metrics_are_in_the_benchmark():
    import json

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in READINGS:
        cells = entries[metric]["workloads"]
        assert cells == ([c + "-infer-b8" for c in ("car", "ped")]
                         if metric.endswith(".infer")
                         else [c + "-train-b8" for c in ("car", "ped")])
        assert os.path.exists(os.path.join(REPO, "benchmarks", "metrics",
                                           f"{metric}.py"))
    assert [m["name"] for m in bench["per_layer"]][-5:] == [
        "nms_iters.infer", "nms_iou_useful.infer", "host_wait_ms.infer",
        "host_busy_ms.infer", "bn_ms.train"]
