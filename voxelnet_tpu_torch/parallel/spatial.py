"""Spatial W-sharding over a model group (`system.num_model_shards > 1`):
the port's counterpart of what XLA inserts for the sharding constraints of
`voxelnet_tpu/models/voxelnet.py:138-166`.

Each of the M processes of a model group holds W slab m, the columns
[x0, x0 + W/M) with x0 = m * W/M (`slab`), of the dense grid, the middle
stack and the RPN. A conv that reads columns past its slab first takes
them from its neighbours (`halo_exchange`); the heads' maps are gathered
whole on every member (`gather_w`), after which decode, NMS, targets and
the loss run replicated. Both are one SUM all-reduce over the model group
of a zeroed buffer into which each member writes its part: one code path
on gloo (which has only all-reduce and broadcast for CUDA tensors) and
NCCL. The W axis is the last index of every tensor here.
"""

from __future__ import annotations

import torch

from voxelnet_tpu_torch.parallel import distributed
from voxelnet_tpu_torch.parallel.distributed import Group


def slab(width: int, num: int, index: int) -> tuple[int, int]:
    """(x0, wloc): the columns [x0, x0 + wloc) of slab `index` of `num`
    equal slabs of `width` columns. Refuses a width that does not divide,
    as `voxelnet_tpu/models/sparse_conv.py:255-258` does."""
    if width % num:
        raise ValueError(
            f"W={width} must divide by num_model_shards={num} for the "
            "spatial sharding")
    wloc = width // num
    return index * wloc, wloc


def _empty(x: torch.Tensor, width: int) -> torch.Tensor:
    """An empty tensor of x's shape but `width` columns, in x's memory
    format (channels-last activations stay channels-last)."""
    fmt = torch.contiguous_format
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        fmt = torch.channels_last
    elif x.dim() == 5 and x.is_contiguous(
            memory_format=torch.channels_last_3d):
        fmt = torch.channels_last_3d
    return torch.empty(x.shape[:-1] + (width,), dtype=x.dtype,
                       device=x.device, memory_format=fmt)


class _HaloExchange(torch.autograd.Function):
    """x (..., w) -> (..., left + w + right): the left neighbour's last
    `left` columns, x, the right neighbour's first `right` columns; zeros
    past the global edges. Member m writes its first `right` and last
    `left` columns into slot m of a zeroed (M, ..., right + left) buffer,
    one SUM all-reduce, then it reads slots m - 1 and m + 1. The backward
    is the adjoint: each halo's gradient is written into its owner's slot,
    one all-reduce, and added to the owner's edge columns."""

    @staticmethod
    def forward(ctx, x, left, right, group):
        m, num, w = group.index(), group.size, x.shape[-1]
        ctx.geometry = (left, right, group)
        buf = x.new_zeros((num,) + x.shape[:-1] + (right + left,))
        buf[m, ..., :right] = x[..., :right]
        buf[m, ..., right:] = x[..., w - left:]
        distributed.all_reduce_in_place(buf, group)
        out = _empty(x, left + w + right)
        out[..., left:left + w] = x
        out[..., :left] = buf[m - 1, ..., right:] if m > 0 else 0
        out[..., left + w:] = buf[m + 1, ..., :right] if m < num - 1 else 0
        return out

    @staticmethod
    def backward(ctx, grad):
        left, right, group = ctx.geometry
        m, num = group.index(), group.size
        w = grad.shape[-1] - left - right
        buf = grad.new_zeros((num,) + grad.shape[:-1] + (right + left,))
        if m > 0:
            buf[m - 1, ..., right:] = grad[..., :left]
        if m < num - 1:
            buf[m + 1, ..., :right] = grad[..., left + w:]
        distributed.all_reduce_in_place(buf, group)
        dx = grad[..., left:left + w].clone()
        dx[..., :right] += buf[m, ..., :right]
        dx[..., w - left:] += buf[m, ..., right:]
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, left: int, right: int,
                  group: Group) -> torch.Tensor:
    """x (..., w), this member's slab, -> (..., left + w + right) with the
    neighbours' edge columns (zeros past the global edges), differentiable.
    A conv of kernel k, stride s and W padding p then runs with W padding
    0 on it where left = p and the slab's last output reads `right`
    columns past it."""
    if not 0 <= max(left, right) <= x.shape[-1]:
        raise ValueError(f"halo_exchange: halos ({left}, {right}) need a "
                         f"slab of at least as many columns, not "
                         f"{x.shape[-1]}")
    return _HaloExchange.apply(x, left, right, group)


class _GatherW(torch.autograd.Function):
    """x (..., w) -> (..., M * w): each member writes its slab into a
    zeroed full-width tensor, one SUM all-reduce. Every member then
    computes the same loss from the whole map, so the gradient of x is
    this member's slice of the full gradient, without a collective."""

    @staticmethod
    def forward(ctx, x, group):
        m, w = group.index(), x.shape[-1]
        ctx.window = (m * w, w)
        full = x.new_zeros(x.shape[:-1] + (group.size * w,))
        full[..., m * w:(m + 1) * w] = x
        distributed.all_reduce_in_place(full, group)
        return full

    @staticmethod
    def backward(ctx, grad):
        x0, w = ctx.window
        return grad[..., x0:x0 + w].contiguous(), None


def gather_w(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The whole-W tensor from every member's slab x (..., W / M), on
    every member of `group`; differentiable (see _GatherW)."""
    return _GatherW.apply(x, group)
