"""BatchNorm with flax semantics on torch's BatchNorm modules.

The port keeps `nn.BatchNorm1d/2d/3d` modules for their parameters and
buffers (state_dict keys, convert.py, bn_fold.py and the eval path stay as
they are) and computes the flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5,
dtype=float32)` forward here, as the JAX package's modules use it:

  * statistics in float32 (the input is cast up from bf16), E[x] and
    E[x^2] - E[x]^2 clipped at 0 (flax's `use_fast_variance`), over the
    stored rows only when a mask is given. An f64 input keeps f64
    statistics (the port's check mode, where a batch split across
    processes then gives the one-process step to f64 rounding); flax's
    dtype=float32 BN would round them to f32;
  * over the global batch when several processes train
    (parallel/distributed.py): each BN call sums [sum x, sum x^2, n] over
    its own part and adds them across a group of processes in one
    all-reduce, forward and backward, so every process normalises with,
    and moves its running stats by, the same global statistics. The group
    is the world where the processes hold disjoint parts (rows, or W slabs
    of the middle and RPN under a model axis, uneven or empty: a process
    of no columns adds n = 0 and still joins); the VFE's table is
    replicated in a model group, so its BN sums over the data group;
  * normalisation with that biased variance, in the wider of the input's
    type and f32: (x - mean) * (rsqrt(var + eps) * scale) + bias, returned
    in float32 (in f64 for an f64 input: under a model axis the VFE's
    gradient is summed over the model group after its backward, and an
    f32 rounding of each member's part would put the check mode's sums
    1e-7 apart);
  * in train mode the running stats move as 0.9 * old + 0.1 * batch with
    the biased variance (torch's own BN uses the unbiased one, and its
    momentum 0.1 is flax's 0.9); in eval mode the running stats normalise.

`running_stats_frozen()` holds the running stats still: the recompute of a
`torch.utils.checkpoint` region (train.remat) runs the forward a second
time, and one train step must move them once. The recompute still
all-reduces its statistics, in the same order on every process.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.parallel import distributed

MOMENTUM = 0.9    # flax convention: the weight of the old running value
EPS = 1e-5

# per thread: autograd runs a checkpoint's recompute on the thread that
# executes the backward, inside the context this sets
_frozen = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Within it, train-mode BN normalises with batch statistics but
    leaves the running stats as they are."""
    before = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = before


def flax_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                    channel_dim: int, mask: torch.Tensor | None = None,
                    group: distributed.Group | None = None) -> torch.Tensor:
    """x with features on `channel_dim`; mask broadcastable to x (True =
    counted in the statistics), or None for all rows. Batch statistics
    summed over `group` (default the world) and a running-stat update when
    `bn.training`, running stats otherwise. Returns float32 (f64 for
    an f64 x). In train mode inside a traced call (tracing.py): a `bn`
    span, and a `bn.backward` span over its backward."""
    call = tracing.current
    if call is None or not bn.training:
        return _batch_norm(bn, x, channel_dim, mask, group)
    with call.span("bn"):
        y = _batch_norm(bn, x, channel_dim, mask, group)
    call.backward_span("bn.backward", y, x)
    return y


def _batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                channel_dim: int, mask: torch.Tensor | None,
                group: distributed.Group | None) -> torch.Tensor:
    dim = channel_dim % x.dim()
    axes = [d for d in range(x.dim()) if d != dim]
    shape = [1] * x.dim()
    shape[dim] = -1
    if bn.training:
        mean, mean2 = _batch_moments(x, axes, mask, group)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if not getattr(_frozen, "on", False):
            with torch.no_grad():
                bn.running_mean.copy_(MOMENTUM * bn.running_mean
                                      + (1 - MOMENTUM) * mean)
                bn.running_var.copy_(MOMENTUM * bn.running_var
                                     + (1 - MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    wide = torch.promote_types(x.dtype, torch.float32)
    mul = torch.rsqrt(var + EPS) * bn.weight
    y = (x.to(wide) - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y.to(wide)


def _batch_moments(x: torch.Tensor, axes: list[int],
                   mask: torch.Tensor | None,
                   group: distributed.Group | None):
    """(E[x], E[x^2]) per channel over `axes` of the global batch (the
    rows where `mask`), in f32 (f64 for an f64 x): one all-reduce over
    `group` of the stacked local sums and counts when several processes
    train."""
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    if mask is None:
        s1 = xs.sum(axes)
        s2 = (xs * xs).sum(axes)
        n = torch.full_like(s1, xs.numel() // s1.numel())
    else:
        m = torch.broadcast_to(mask, xs.shape)
        zero = xs.new_zeros(())
        s1 = torch.where(m, xs, zero).sum(axes)
        s2 = torch.where(m, xs * xs, zero).sum(axes)
        n = m.sum(axes).to(xs.dtype)
    if distributed.world_size() > 1:
        s1, s2, n = distributed.all_reduce_sum(torch.stack([s1, s2, n]),
                                               group)
    return s1 / n, s2 / n
