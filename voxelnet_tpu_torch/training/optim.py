"""Clipped SGD, with or without momentum, and a piecewise-constant LR
schedule, written to optax's arithmetic.

`make_optimizer(config, steps_per_epoch)` is the counterpart of
`voxelnet_tpu/training/optim.py::make_optimizer`:
`chain(clip_by_global_norm(train.gradient_clip),
sgd(piecewise_constant_schedule(train.lr, {boundary: 0.1})))`, boundary =
`lr_scheduler_step * steps_per_epoch`. `ClippedSGD(..., momentum=m)` is
`chain(clip_by_global_norm(c), sgd(schedule, momentum=m))`, the optimizer
of the synthetic learning run (tools/synthetic_smoke.py).

Optax's arithmetic, not torch's:
  * the global norm is sqrt(sum over tensors of sum(g^2)) over the
    parameters (BN scale and bias included, running stats not); gradients
    pass unchanged when the norm is below the limit and become
    (g / norm) * limit otherwise (torch's `clip_grad_norm_` scales by
    limit / (norm + 1e-6) always);
  * `sgd(lr, momentum=m)` is `chain(trace(decay=m, nesterov=False),
    scale_by_learning_rate(lr))`: a trace t = g + m * t of the clipped
    gradient, kept in the parameters' dtype from zeros, and the update
    p + (-lr(count)) * t (without momentum, t is the clipped gradient);
  * the schedule reads the update count, which moves once per update; its
    value is computed in f32 as optax computes it.

Parameters and traces are updated in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch


class OptState(NamedTuple):
    count: int   # updates taken (optax's ScaleByScheduleState.count)
    # optax's TraceState.trace, one tensor per parameter in the
    # parameters' order; None without momentum
    trace: tuple[torch.Tensor, ...] | None = None


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: dict[int, float]
                                | None = None) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule: -> fn(count) -> `init_value`
    times each scale whose boundary is <= count, computed in f32 in
    optax's order of operations."""
    scales = sorted((boundaries_and_scales or {}).items())
    if any(scale < 0 for _, scale in scales):
        raise ValueError("piecewise_constant_schedule expects non-negative "
                         "scale factors")
    init = np.float32(init_value)

    def schedule(count: int) -> float:
        v = init
        for boundary, scale in scales:
            on = np.float32(max(0.0, float(np.sign(boundary - count))))
            v = v * on + (np.float32(1) - on) * np.float32(scale) * v
        return float(v)

    return schedule


def make_lr_schedule(config, steps_per_epoch: int):
    """-> fn(count) -> LR as a float: train.lr, times 0.1 from
    count >= lr_scheduler_step * steps_per_epoch on."""
    boundary = config.train.lr_scheduler_step * max(steps_per_epoch, 1)
    return piecewise_constant_schedule(config.train.lr, {boundary: 0.1})


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """-> (clipped grads, global norm before clipping)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads], norm


class ClippedSGD:
    """The optimizer of one training run: `init(params)` gives its state,
    `apply_(params, grads, state)` clips, steps the parameters (and the
    traces) in place and returns (global norm of the unclipped grads,
    next OptState).

    `ClippedSGD(config, steps_per_epoch)` is `make_optimizer`'s: the
    config's clip and LR schedule, no momentum. `schedule` (fn(count) ->
    LR) replaces the config's schedule; `momentum` adds optax's trace."""

    def __init__(self, config, steps_per_epoch: int = 1, *,
                 momentum: float | None = None,
                 schedule: Callable[[int], float] | None = None):
        self.max_norm = config.train.gradient_clip
        self.schedule = (make_lr_schedule(config, steps_per_epoch)
                         if schedule is None else schedule)
        self.momentum = momentum

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        if self.momentum is None:
            return OptState(count=0)
        return OptState(count=0, trace=tuple(
            torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params))

    @torch.no_grad()
    def apply_(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: OptState):
        if (self.momentum is None) != (state.trace is None):
            raise ValueError(
                f"optimizer state {'with' if state.trace else 'without'} a "
                f"momentum trace for an optimizer with momentum="
                f"{self.momentum}")
        updates, norm = clip_by_global_norm(grads, self.max_norm)
        if self.momentum is not None:
            for t, g in zip(state.trace, updates):
                t.mul_(self.momentum).add_(g.to(t.dtype))
            updates = state.trace
        step = -self.schedule(state.count)
        for p, u in zip(params, updates):
            p.add_((u * step).to(p.dtype))
        return norm, OptState(count=state.count + 1, trace=state.trace)


def make_optimizer(config, steps_per_epoch: int) -> ClippedSGD:
    """The trainer's optimizer: clip at train.gradient_clip, plain SGD on
    make_lr_schedule."""
    return ClippedSGD(config, steps_per_epoch)
