"""Clipped SGD with a step-based LR drop, as `voxelnet_tpu/training/optim.py`
builds it from optax: `chain(clip_by_global_norm(train.gradient_clip),
sgd(piecewise_constant_schedule(train.lr, {boundary: 0.1})))`, boundary =
`lr_scheduler_step * steps_per_epoch`.

Written to optax's arithmetic, not torch's: the global norm is
sqrt(sum over tensors of sum(g^2)) over the parameters (BN scale and bias
included, running stats not); gradients pass unchanged when the norm is
below the limit and become (g / norm) * limit otherwise (torch's
`clip_grad_norm_` scales by limit / (norm + 1e-6) always); the update is
p + (-lr) * g. The schedule's value is computed in f32 as optax computes
it. Parameters are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class OptState(NamedTuple):
    count: int   # updates taken (optax's ScaleByScheduleState.count)


def make_lr_schedule(config, steps_per_epoch: int):
    """-> fn(count) -> LR as a float: train.lr, times 0.1 from
    count >= lr_scheduler_step * steps_per_epoch on."""
    boundary = config.train.lr_scheduler_step * max(steps_per_epoch, 1)
    init = np.float32(config.train.lr)

    def schedule(count: int) -> float:
        on = np.float32(max(0.0, float(np.sign(boundary - count))))
        return float(init * on + (np.float32(1) - on) * np.float32(0.1) * init)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """-> (clipped grads, global norm before clipping)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads], norm


class ClippedSGD:
    """The optimizer of one training run: `apply_(params, grads, state)`
    clips, steps the parameters in place and returns (global norm of the
    unclipped grads, next OptState)."""

    def __init__(self, config, steps_per_epoch: int):
        self.max_norm = config.train.gradient_clip
        self.schedule = make_lr_schedule(config, steps_per_epoch)

    @torch.no_grad()
    def apply_(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: OptState):
        clipped, norm = clip_by_global_norm(grads, self.max_norm)
        step = -self.schedule(state.count)
        for p, g in zip(params, clipped):
            p.add_((g * step).to(p.dtype))
        return norm, OptState(count=state.count + 1)
