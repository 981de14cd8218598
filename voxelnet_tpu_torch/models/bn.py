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
    type and f32: (x - mean) * (rsqrt(var + eps) * scale) + bias, then a
    ReLU where the caller asks, stored in the caller's type (by default
    float32, f64 for an f64 input: under a model axis the VFE's gradient
    is summed over the model group after its backward, and an f32
    rounding of each member's part would put the check mode's sums 1e-7
    apart);
  * in train mode the running stats move as 0.9 * old + 0.1 * batch with
    the biased variance (torch's own BN uses the unbiased one, and its
    momentum 0.1 is flax's 0.9); in eval mode the running stats normalise.

Train mode runs as one autograd Function, `BatchNormFn`, over the four
steps of kernels/batch_norm.py: hand-written CUDA launches for bf16 and
f32 CUDA tensors (statistics, normalise + ReLU + cast, and the backward's
reduction and apply; the output in the input's type), their plain torch
versions for CPU tensors and f64. The backward is analytic on both devices
and saves only x and per-channel vectors. The Function makes this layer's
collectives: one all-reduce of the statistics' sums forward, and one of
the gradient's sums backward (for dx; d gamma and d beta go back local, and
the data-parallel gradient all-reduce sums them once).

`running_stats_frozen()` holds the running stats still: the recompute of a
`torch.utils.checkpoint` region (train.remat) runs the forward a second
time, and one train step must move them once. The recompute still
all-reduces its statistics, in the same order on every process.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch import nn

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.kernels import batch_norm
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


def _all_reduce(group: distributed.Group | None):
    """The in-place SUM over `group` (default the world), or None for a
    group of one."""
    group = group or distributed.world_group()
    if group.size == 1:
        return None
    return functools.partial(distributed.all_reduce_in_place, group=group)


class BatchNormFn(torch.autograd.Function):
    """y = relu?((x - mean) * rsqrt(var + eps) * gamma + beta) in
    `out_dtype` with batch statistics over the rows where `mask`, summed
    by `all_reduce` (models/bn.py::_all_reduce) where several processes
    train; the running stats moved where `update`. The backward returns
    this process's d gamma and d beta and dx from the processes' sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, dim, mask,
                all_reduce, relu, out_dtype, update):
        stats = batch_norm.statistics(x, dim, mask, weight, running_mean,
                                      running_var, update, MOMENTUM, EPS,
                                      all_reduce)
        y = batch_norm.normalise(x, dim, stats, bias, relu, out_dtype)
        ctx.save_for_backward(x, mask, bias, stats)
        ctx.dim, ctx.all_reduce, ctx.relu = dim, all_reduce, relu
        ctx.weight_dtype = weight.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mask, bias, stats = ctx.saved_tensors
        dim, relu = ctx.dim, ctx.relu
        # where a copy into x's layout is needed, one for both steps
        dy = batch_norm.readable(dy, x, dim)
        sums = batch_norm.backward_sums(x, dim, dy, stats, bias, relu)
        dx = None
        if ctx.needs_input_grad[0]:
            group_sums = sums
            if ctx.all_reduce is not None:
                group_sums = sums.clone()
                ctx.all_reduce(group_sums)
            dx = batch_norm.backward_input(x, dim, dy, mask, stats, bias,
                                           group_sums, relu)
        d_beta, d_gamma = sums
        if d_gamma.dtype != ctx.weight_dtype:   # the check mode's mixes
            d_beta = d_beta.to(bias.dtype)
            d_gamma = d_gamma.to(ctx.weight_dtype)
        return (dx, d_gamma, d_beta) + (None,) * 8


def flax_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                    channel_dim: int, mask: torch.Tensor | None = None,
                    group: distributed.Group | None = None, *,
                    relu: bool = False,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x with features on `channel_dim`; mask broadcastable to x (True =
    counted in the statistics), or None for all rows. Batch statistics
    summed over `group` (default the world) and a running-stat update when
    `bn.training`, running stats otherwise. Then a ReLU where `relu`.
    Returns `out_dtype`, by default float32 (f64 for an f64 x); in train
    mode a bf16 or f32 CUDA x takes only its own type. In train mode
    inside a traced call (tracing.py): a `bn` span, and a
    `bn.backward` span over its backward."""
    out_dtype = out_dtype or torch.promote_types(x.dtype, torch.float32)
    call = tracing.current
    if call is None or not bn.training:
        return _batch_norm(bn, x, channel_dim, mask, group, relu, out_dtype)
    with call.span("bn"):
        y = _batch_norm(bn, x, channel_dim, mask, group, relu, out_dtype)
    call.backward_span("bn.backward", y, x)
    return y


def _batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                channel_dim: int, mask: torch.Tensor | None,
                group: distributed.Group | None, relu: bool,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Train mode: BatchNormFn (the CUDA kernels for bf16 and f32 CUDA
    tensors, their plain versions on the CPU). Eval mode: the running
    stats, in plain torch."""
    dim = channel_dim % x.dim()
    if bn.training:
        return BatchNormFn.apply(
            x, bn.weight, bn.bias, bn.running_mean, bn.running_var, dim,
            mask, _all_reduce(group), relu, out_dtype,
            not getattr(_frozen, "on", False))
    shape = [1] * x.dim()
    shape[dim] = -1
    wide = torch.promote_types(x.dtype, torch.float32)
    mul = torch.rsqrt(bn.running_var + EPS) * bn.weight
    y = ((x.to(wide) - bn.running_mean.view(shape)) * mul.view(shape)
         + bn.bias.view(shape)).to(wide)
    return (torch.relu(y) if relu else y).to(out_dtype)
