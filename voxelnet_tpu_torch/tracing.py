"""Spans and counters of the program's calls, recorded in memory while a
caller asks for them.

A caller asks by passing a `marks` list to an inference function
(models/voxelnet.py) or to a train step (training/train_step.py), as the
benchmark's traced window does and its timed windows do not. Such a call
opens a `Call`: a record with an id, its spans and its counters, kept in
a ring of the last RING calls (`recent`).

* A span has a name, its call's id, its parent (an index into the
  call's spans), a host start and end (`time.perf_counter_ns`) and, on a
  CUDA device, an event at each end; elsewhere the host times stand in
  for the device's. While a profiler runs it also opens a torch.profiler
  range named `voxelnet.<name>`, so the trace holds it on the profiler's
  own clock (without one a range would cost the host some 13 us and be
  read by nothing). `Call.unix_ns` places a host stamp on that clock (Unix time: a
  Chrome trace's `ts` plus its `baseTimeNanoseconds`) from the one
  (perf_counter_ns, time_ns) pair taken when the call opens.
* Counters belong to the open call. A count that lives on the device is
  kept as a 0-d tensor and read only when the record is read, so
  counting never synchronises.
* `marks` still receives what it always has: ("start", CUDA event or
  host seconds) and then (stage, ...) at the end of each stage (`stage`),
  in the program's order (STAGES, TRAIN_STAGES).

With no call open (every call whose caller passes no `marks`) nothing is
recorded: no event, no range, no record. `stage` then costs its
`marks is None` check; a BN call and an NMS iteration read one module
attribute. One call is open at a time in a process (`current`); the
autograd engine runs the backward on threads of its own, so a backward
span's hooks hold their call from when they are registered.

Spans: `infer` (prepare, vfe, dense, middle, rpn, decode, nms; nms.iou
and nms.greedy inside nms); `train` (voxelize, targets, forward, loss,
backward, all_reduce, update; `bn` inside forward for each batch-norm in
train mode, `bn.backward` inside backward). Counters: `nms.iters`,
`nms.iou_pairs`, `nms.iou_pairs_live`, `host.wait_ns`, `bn.launches` (each
launch of the batch norm's kernels, kernels/batch_norm.py).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import torch

# calls kept: above every traced window's calls (the benchmark's mixes
# trace 40 inference calls or 8 train steps)
RING = 64
RANGE_PREFIX = "voxelnet."

# the open call, None while no caller asks for a record
current: Call | None = None
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count()


class Span:
    """One span of a call; `t1`, `ev1` None until it ends."""

    __slots__ = ("name", "call", "parent", "t0", "t1", "ev0", "ev1",
                 "_range")

    def __init__(self, name: str, call: int, parent: int | None,
                 cuda: bool, ranged: bool):
        self.name, self.call, self.parent = name, call, parent
        self.t0 = time.perf_counter_ns()
        self._range = None
        if ranged:
            self._range = torch.profiler.record_function(RANGE_PREFIX + name)
            self._range.__enter__()
        self.t1 = None
        self.ev0 = _event() if cuda else None
        self.ev1 = None

    def end(self) -> None:
        if self.ev0 is not None:
            self.ev1 = _event()
        self.t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)

    @property
    def host_ns(self) -> int:
        return self.t1 - self.t0

    def device_ms(self) -> float:
        """ms between the span's CUDA events (the device synchronised
        since), its host ms off the card."""
        if self.ev0 is None:
            return self.host_ns / 1e6
        return self.ev0.elapsed_time(self.ev1)


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Call:
    """The record of one call, and the context that keeps it open."""

    def __init__(self, name: str, device):
        self.id = next(_ids)
        self.name = name
        self.cuda = torch.device(device).type == "cuda"
        self.ranged = torch.autograd._profiler_enabled()
        self.spans: list[Span] = []
        self.counters: dict[str, list] = {}
        self._stack: list[int] = []
        self.clock = (time.perf_counter_ns(), time.time_ns())

    def __enter__(self) -> Call:
        global current
        current = self
        self.open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        global current
        try:
            self.close(self.spans[0])
        finally:
            current = None
            _ring.append(self)

    def open(self, name: str, push: bool = True) -> Span:
        """A span whose parent is the innermost open one; `push`: it is
        then the innermost until `close` (not for a span that another
        thread ends)."""
        parent = self._stack[-1] if self._stack else None
        span = Span(name, self.id, parent, self.cuda, self.ranged)
        self.spans.append(span)
        if push:
            self._stack.append(len(self.spans) - 1)
        return span

    def close(self, span: Span, pop: bool = True) -> None:
        span.end()
        if pop:
            self._stack.pop()

    def span(self, name: str) -> _Scope:
        return _Scope(self, name)

    def backward_span(self, name: str, out: torch.Tensor,
                      inp: torch.Tensor) -> None:
        """A span of the backward from `out`'s gradient to `inp`'s: it
        opens where the autograd engine takes up the node that made `out`
        and ends where it takes up the one that made `inp`. Nothing where
        either needs no gradient."""
        if not (out.requires_grad and inp.requires_grad):
            return
        opened = []

        def start(grad):
            opened.append(self.open(name, push=False))

        def end(grad):
            if opened:
                self.close(opened.pop(), pop=False)

        out.register_hook(start)
        inp.register_hook(end)

    def add(self, counter: str, value) -> None:
        """Add to a counter: an int, or a 0-d device tensor read later."""
        self.counters.setdefault(counter, []).append(value)

    def count(self, counter: str) -> int:
        """The counter's sum (0 where nothing was counted); reads the
        device's counts."""
        return sum(int(v) for v in self.counters.get(counter, ()))

    def named(self, name: str) -> list[Span]:
        """The call's ended spans of that name, in order."""
        return [s for s in self.spans if s.name == name and s.t1 is not None]

    def children(self, span: Span) -> list[Span]:
        i = self.spans.index(span)
        return [s for s in self.spans if s.parent == i]

    def self_ns(self, span: Span) -> int:
        """The span's host duration less the part its children cover."""
        kids = sorted((max(c.t0, span.t0), min(c.t1, span.t1))
                      for c in self.children(span) if c.t1 is not None)
        covered, end = 0, span.t0
        for a, b in kids:
            if b > end:
                covered += b - max(a, end)
                end = b
        return span.host_ns - covered

    def unix_ns(self, perf_ns: int) -> int:
        """A host stamp of this call on the profiler's clock (Unix ns)."""
        return self.clock[1] + perf_ns - self.clock[0]


class _Scope:
    __slots__ = ("call", "name", "span", "marks")

    def __init__(self, call: Call, name: str, marks: list | None = None):
        self.call, self.name, self.marks = call, name, marks

    def __enter__(self) -> Span:
        self.span = self.call.open(self.name)
        return self.span

    def __exit__(self, *exc) -> None:
        self.call.close(self.span)
        if self.marks is not None:
            s = self.span
            self.marks.append((self.name, s.ev1 if s.ev0 is not None
                               else s.t1 / 1e9))


# what a scope is while no call is open
OFF = contextlib.nullcontext()


def call(name: str, marks: list | None, device):
    """The context of one call: a record opens where `marks` is a list
    and no call is open yet (an inference function inside another's call
    adds to that call)."""
    if marks is None or current is not None:
        return OFF
    return Call(name, device)


def stage(marks: list | None, name: str):
    """The context of one stage of the open call: its span, and at its end
    (name, its end event, or host seconds off the card) appended to
    `marks`. Nothing where marks is None."""
    if marks is None:
        return OFF
    return _Scope(current, name, marks)


def span(name: str):
    """The context of a span inside the open call; nothing where none is
    open."""
    return OFF if current is None else _Scope(current, name)


def mark(marks: list | None, stage: str, device: torch.device) -> None:
    """Append (stage, CUDA event recorded now) to `marks` on a CUDA
    device, (stage, host time) elsewhere; nothing when marks is None."""
    if marks is None:
        return
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))
    else:
        marks.append((stage, time.perf_counter()))


def wait(call: Call | None, flag: torch.Tensor) -> bool:
    """bool(flag): a synchronisation with the device, whose host time is
    added to `call`'s `host.wait_ns` where a call is open."""
    if call is None:
        return bool(flag)
    t0 = time.perf_counter_ns()
    out = bool(flag)
    call.add("host.wait_ns", time.perf_counter_ns() - t0)
    return out


def recent(n: int) -> list[Call]:
    """The last n calls recorded, oldest first. Raises ValueError where
    fewer are kept."""
    if not 0 <= n <= len(_ring):
        raise ValueError(f"{n} calls asked for, {len(_ring)} kept (at most "
                         f"{RING})")
    return list(_ring)[len(_ring) - n:]
