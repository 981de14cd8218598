"""Train-mode batch norm with flax semantics (models/bn.py) in four steps,
each a hand-written CUDA launch (`csrc/batch_norm.cu`) for CUDA tensors and
a plain torch version for CPU tensors and f64:

  1. `statistics`: per-channel sum x, sum x^2 and n over the rows (those
     where the row mask holds, or all), summed across processes by the
     caller's `all_reduce` where several train; the mean, the biased
     variance clipped at 0, scale = rsqrt(var + eps) * gamma, and the
     running stats moved by 0.9 / 0.1 unless frozen. On one process the
     stats kernel finalizes in its last block; across processes it writes
     the sums, `all_reduce` sums them, and a one-block kernel finalizes;
  2. `normalise`: y = relu?((x - mean) * scale + beta) in f32, stored in
     the caller's type;
  3. `backward_sums`: per channel over every row, d beta = sum g and
     d gamma = sum g * xhat, g = dy * [y > 0] with the ReLU (dy without),
     y and xhat recomputed from x;
  4. `backward_input`: dx = scale * (g - [row counted] * (S_g + xhat *
     S_gxhat) / n), with the sums of step 3 over the processes; the xhat
     term drops where the variance was clamped (the plain formulation's
     clamp passes no gradient there).

models/bn.py's autograd Function runs them. The JAX package has no Pallas
kernel here: flax's BatchNorm is lowered by XLA. The layer is bound by
bytes: 16 an element at bf16 (2 + 2 + 2 forward, 4 + 4 + 2 backward).

The kernels take x with its channels innermost (the VFE's (B, K, T, C), the
middle's NDHWC behind an NCDHW view, the RPN's NHWC), bf16 or f32, C a
multiple of 16 bytes' elements with C / (16 / element bytes) a power of two
<= 256, y, dy and dx in x's type, f32 per-channel parameters, and a row
mask only over the leading dims of a channel-last x. Anything else raises
on CUDA; the plain versions take any layout and mix of types, and also
serve f64 (the port's check mode, on the CPU).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.kernels import _build

# kernel launches since the last reset, by kernel (chip_smoke.py and the
# launch checks of the profile tools read them); inside a traced call each
# launch also adds to the call's `bn.launches` counter
KERNELS = ("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce",
           "bn_bwd_apply")
launches = dict.fromkeys(KERNELS, 0)
# backward steps whose upstream gradient came in a layout the kernels do
# not read (channels not innermost, or rows not evenly spaced) and was
# copied into x's first: the middle's last block, whose output the BEV
# fold's gradient hands back with depth innermost
dy_copies = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    "bn_stats_launch": [_P, _I, _P, _L, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                        _F, _F, _F, _P, _P, _P],
    "bn_finalize_launch": [_P, _I, _P, _P, _P, _I, _F, _F, _F, _P, _P],
    "bn_apply_launch": [_P, _I, _P, _P, _P, _L, _I, _I, _I, _P],
    "bn_bwd_reduce_launch": [_P, _I, _P, _L, _P, _P, _L, _I, _I, _P, _P, _I,
                             _P, _P],
    "bn_bwd_apply_launch": [_P, _I, _P, _L, _P, _P, _P, _P, _P, _L, _I, _I,
                            _I, _P],
    "bn_blocks_per_sm": [_I, _I, ctypes.POINTER(_I)],
}
_THREADS = 256
# csrc/batch_norm.cu's `which` of each grid-stride kernel
_STATS, _APPLY, _BWD_REDUCE, _BWD_APPLY = range(4)
# element type -> code of csrc/batch_norm.cu (1 bf16, 0 f32)
_CODES = {torch.bfloat16: 1, torch.float32: 0}


class Stats(NamedTuple):
    """The rows of a call's (5, C) statistics, as the steps pass them."""

    mean: torch.Tensor
    invstd: torch.Tensor    # rsqrt(var + eps)
    scale: torch.Tensor     # invstd * gamma
    clamped: torch.Tensor   # 1 where E[x^2] - E[x]^2 < 0 (var clipped)
    n: torch.Tensor         # rows counted, each channel


def _shape(x: torch.Tensor, dim: int) -> list[int]:
    shape = [1] * x.dim()
    shape[dim] = -1
    return shape


def _axes(x: torch.Tensor, dim: int) -> list[int]:
    return [d for d in range(x.dim()) if d != dim % x.dim()]


def _wide(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


# ---- the plain versions (CPU tensors; any layout, f64 too) -----------------

def sums_plain(x: torch.Tensor, dim: int,
               mask: torch.Tensor | None) -> torch.Tensor:
    """(3, C): sum x, sum x^2 and n over the rows of x where `mask`
    (broadcastable to x; None: every row), in the wider of x's type and
    f32."""
    xs = x.to(_wide(x))
    axes = _axes(x, dim)
    if mask is None:
        s1 = xs.sum(axes)
        s2 = (xs * xs).sum(axes)
        n = torch.full_like(s1, xs.numel() // max(s1.numel(), 1))
    else:
        m = torch.broadcast_to(mask, xs.shape)
        zero = xs.new_zeros(())
        s1 = torch.where(m, xs, zero).sum(axes)
        s2 = torch.where(m, xs * xs, zero).sum(axes)
        n = m.sum(axes).to(xs.dtype)
    return torch.stack([s1, s2, n])


def finalize_plain(sums: torch.Tensor, weight: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   update: bool, momentum: float,
                   eps: float) -> torch.Tensor:
    """The (5, C) statistics (the rows of Stats) of the (3, C) sums; the
    running stats moved as momentum * old + (1 - momentum) * batch where
    `update`."""
    s1, s2, n = sums
    mean, mean2 = s1 / n, s2 / n
    raw = mean2 - mean * mean
    var = torch.clamp(raw, min=0.0)
    invstd = torch.rsqrt(var + eps)
    if update:
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
    return torch.stack([mean, invstd, invstd * weight,
                        (raw < 0).to(mean.dtype), n])


def normalise_plain(x: torch.Tensor, dim: int, stats: torch.Tensor,
                    bias: torch.Tensor, relu: bool,
                    out_dtype: torch.dtype) -> torch.Tensor:
    st = Stats(*stats)
    shape = _shape(x, dim)
    y = ((x.to(_wide(x)) - st.mean.view(shape)) * st.scale.view(shape)
         + bias.view(shape))
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def _gated(x: torch.Tensor, dim: int, dy: torch.Tensor, st: Stats,
           bias: torch.Tensor, relu: bool):
    """(g, x - mean) in the wider type: dy gated by the recomputed
    ReLU."""
    shape = _shape(x, dim)
    wide = torch.promote_types(_wide(x), dy.dtype)
    t = x.to(wide) - st.mean.view(shape)
    g = dy.to(wide)
    if relu:
        y = t * st.scale.view(shape) + bias.view(shape)
        g = torch.where(y > 0, g, g.new_zeros(()))
    return g, t


def backward_sums_plain(x: torch.Tensor, dim: int, dy: torch.Tensor,
                        stats: torch.Tensor, bias: torch.Tensor,
                        relu: bool) -> torch.Tensor:
    """(2, C): d beta = sum g and d gamma = sum g * xhat over every row."""
    st = Stats(*stats)
    g, t = _gated(x, dim, dy, st, bias, relu)
    axes = _axes(x, dim)
    return torch.stack([g.sum(axes), (g * t).sum(axes) * st.invstd])


def backward_input_plain(x: torch.Tensor, dim: int, dy: torch.Tensor,
                         mask: torch.Tensor | None, stats: torch.Tensor,
                         bias: torch.Tensor, sums: torch.Tensor,
                         relu: bool) -> torch.Tensor:
    """dx from the processes' (2, C) sums, in x's type."""
    st = Stats(*stats)
    g, t = _gated(x, dim, dy, st, bias, relu)
    shape = _shape(x, dim)
    b = torch.where(st.clamped != 0, 0.0, sums[1] / st.n)
    part = torch.addcmul((sums[0] / st.n).view(shape), t,
                         (st.invstd * b).view(shape))
    if mask is not None:
        part = torch.where(torch.broadcast_to(mask, x.shape), part,
                           part.new_zeros(()))
    return ((g - part) * st.scale.view(shape)).to(x.dtype)


# ---- the kernels ------------------------------------------------------------

_sms: dict[int, int] = {}
_resident: dict[tuple[int, int], int] = {}
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _blocks(index: int, which: int, dtype: torch.dtype, work: int) -> int:
    """A grid of at most one wave of the kernel's resident blocks on the
    device's SMs, and at most `work` blocks."""
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    key = (which, _CODES[dtype])
    if key not in _resident:
        out = ctypes.c_int()
        _build.check(_lib().bn_blocks_per_sm(*key, ctypes.byref(out)),
                     "bn_blocks_per_sm")
        _resident[key] = out.value
    return max(1, min(_sms[index] * _resident[key], work))


def _ticket(index: int, stream: int) -> torch.Tensor:
    """The stream's counter of finished reduction blocks, which the last
    block of each launch resets to 0."""
    key = (index, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32,
                                    device=torch.device("cuda", index))
    return _tickets[key]


def _launched(kernel: str) -> None:
    launches[kernel] += 1
    call = tracing.current
    if call is not None:
        call.add("bn.launches", 1)


def _lib():
    return _build.load("batch_norm", _ARGTYPES)


def _plain(x: torch.Tensor) -> bool:
    """The steps run their plain versions for CPU tensors and for f64 (the
    check mode); the kernels for everything else, or raise."""
    return _build.on_cpu(x) or x.dtype == torch.float64


def _rows_apart(t: torch.Tensor, dim: int) -> int | None:
    """Elements between consecutive rows of t taken with its channels
    (`dim`) innermost, where the channels are dense and the rows evenly
    spaced (C for a channels-last tensor, more for a slice of a wider
    one; C for an empty one, an empty W slab's); None otherwise. Plain
    stride arithmetic: no tensor op."""
    dim %= t.dim()
    if t.numel() == 0:
        return t.shape[dim]
    if t.shape[dim] != 1 and t.stride(dim) != 1:
        return None
    apart = want = None
    for d in reversed(range(t.dim())):
        if d == dim or t.shape[d] == 1:
            continue
        if apart is None:
            apart = want = t.stride(d)
        elif t.stride(d) != want:
            return None
        want *= t.shape[d]
    return t.shape[dim] if apart is None else apart


def _grad_apart(dy: torch.Tensor, dim: int) -> int | None:
    """Elements between the rows of dy where the backward kernels read it
    in place: channels innermost, rows evenly spaced on 16-byte
    boundaries (x's own layout, or a slice of a concatenation's
    gradient); None otherwise."""
    apart = _rows_apart(dy, dim)
    if (apart is None or apart % (16 // dy.element_size())
            or dy.data_ptr() % 16):
        return None
    return apart


def rows_of(x: torch.Tensor, dim: int) -> tuple[int, int]:
    """(rows, C) of x for the kernels: raise unless x is a bf16 or f32 CUDA
    tensor whose channels (`dim`) are innermost and dense, with C a width
    the kernels take."""
    what = "batch_norm"
    if not x.is_cuda:
        raise ValueError(f"{what}: the kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _CODES:
        raise ValueError(f"{what}: x must be torch.bfloat16 or "
                         f"torch.float32 on CUDA, got {x.dtype}")
    C = x.shape[dim]
    if _rows_apart(x, dim) != C:
        raise ValueError(f"{what}: the kernels take x with its channels "
                         f"innermost and its rows dense (channels-last), got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}, "
                         f"channel dim {dim}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the kernels take x at a 16-byte aligned "
                         f"address")
    per = 16 // x.element_size()
    lanes = C // per
    if C % per or lanes < 1 or lanes > _THREADS or lanes & (lanes - 1):
        raise ValueError(f"{what}: C must be a multiple of {per} with "
                         f"C / {per} a power of two <= {_THREADS} for "
                         f"{x.dtype}, got C={C}")
    return x.numel() // C, C


def _require_f32(x: torch.Tensor, shape: tuple, **tensors) -> None:
    for name, t in tensors.items():
        if (t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"batch_norm: {name} must be a contiguous f32 "
                             f"{shape} tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _require_mask(x: torch.Tensor, dim: int, mask: torch.Tensor) -> None:
    if (dim % x.dim() != x.dim() - 1 or mask.dtype != torch.bool
            or mask.device != x.device or not mask.is_contiguous()
            or mask.numel() * x.shape[-1] != x.numel()
            or tuple(mask.shape[:-1]) != tuple(x.shape[:-1])):
        raise ValueError(
            f"batch_norm: the kernels take a contiguous bool row mask of "
            f"shape x.shape[:-1] + (1,) on x's device for a channel-last x, "
            f"got {mask.dtype} {tuple(mask.shape)} on {mask.device} for x "
            f"{tuple(x.shape)} with channel dim {dim}")


def _require_grad(x: torch.Tensor, dim: int, dy: torch.Tensor) -> int:
    """Elements between dy's rows; raise unless the backward kernels read
    dy in place (`readable` makes it so) in x's type and shape."""
    apart = _grad_apart(dy, dim)
    if (dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device
            or apart is None):
        raise ValueError(
            f"batch_norm: the backward kernels take dy of x's type and "
            f"shape ({x.dtype} {tuple(x.shape)}) on x's device with its "
            f"channels innermost and its rows evenly spaced on 16-byte "
            f"boundaries, got {dy.dtype} {tuple(dy.shape)} on {dy.device}, "
            f"strides {dy.stride()}")
    return apart


def _finalize_args(weight, running_mean, running_var, update: bool,
                   momentum: float, eps: float) -> list:
    return [weight.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), int(update), momentum, 1 - momentum, eps]


def _reduce_blocks(index: int, which: int, x: torch.Tensor, rows: int,
                   C: int) -> int:
    """Blocks of a reduction over `rows`: one wave, each thread at least 16
    rows."""
    lanes = C // (16 // x.element_size())
    return _blocks(index, which, x.dtype,
                   -(-rows // (_THREADS // lanes * 16)))


def statistics(x: torch.Tensor, dim: int, mask: torch.Tensor | None,
               weight: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, update: bool, momentum: float,
               eps: float,
               all_reduce: Callable[[torch.Tensor], None] | None = None
               ) -> torch.Tensor:
    """Step 1: the (5, C) batch statistics of x (the rows of Stats), its
    (3, C) sums summed in place by `all_reduce` where several processes
    train (None: this process alone); the running stats moved where
    `update`."""
    if _plain(x):
        sums = sums_plain(x, dim, mask)
        if all_reduce is not None:
            all_reduce(sums)
        return finalize_plain(sums, weight, running_mean, running_var,
                              update, momentum, eps)
    rows, C = rows_of(x, dim)
    _require_f32(x, (C,), weight=weight, running_mean=running_mean,
                 running_var=running_var)
    if mask is not None:
        _require_mask(x, dim, mask)
    several = all_reduce is not None
    index = x.get_device()
    stream = _build.stream(index)
    blocks = _reduce_blocks(index, _STATS, x, rows, C)
    # the blocks' partial sums (blocks, 2, C), then their counts (int64)
    scratch = torch.empty(blocks * (2 * C + 2), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((5, C), dtype=torch.float32, device=x.device)
    sums = (torch.empty((3, C), dtype=torch.float32, device=x.device)
            if several else None)
    fin = _finalize_args(weight, running_mean, running_var, update,
                         momentum, eps)
    lib = _lib()
    err = lib.bn_stats_launch(
        x.data_ptr(), _CODES[x.dtype],
        None if mask is None else mask.data_ptr(), rows, C,
        scratch.data_ptr(), scratch.data_ptr() + 4 * blocks * 2 * C,
        _ticket(index, stream).data_ptr(), blocks,
        *fin[:3], 0 if several else fin[3], *fin[4:],
        None if several else stats.data_ptr(),
        None if sums is None else sums.data_ptr(), stream)
    _build.check(err, "bn_stats")
    _launched("bn_stats")
    if several:
        all_reduce(sums)
        err = lib.bn_finalize_launch(sums.data_ptr(), C, *fin,
                                     stats.data_ptr(), stream)
        _build.check(err, "bn_finalize")
        _launched("bn_finalize")
    return stats


def normalise(x: torch.Tensor, dim: int, stats: torch.Tensor,
              bias: torch.Tensor, relu: bool,
              out_dtype: torch.dtype) -> torch.Tensor:
    """Step 2: relu?((x - mean) * scale + beta) in `out_dtype` (x's own on
    CUDA), in x's layout."""
    if _plain(x):
        return normalise_plain(x, dim, stats, bias, relu, out_dtype)
    rows, C = rows_of(x, dim)
    _require_f32(x, (C,), bias=bias)
    _require_f32(x, (5, C), stats=stats)
    if out_dtype != x.dtype:
        raise ValueError(f"batch_norm: the kernels store y in x's type "
                         f"({x.dtype}), got out_dtype {out_dtype}")
    y = torch.empty_like(x)
    vecs = rows * C // (16 // x.element_size())
    if vecs:
        index = x.get_device()
        err = _lib().bn_apply_launch(
            x.data_ptr(), _CODES[x.dtype], stats.data_ptr(),
            bias.data_ptr(), y.data_ptr(), vecs, C, int(relu),
            _blocks(index, _APPLY, x.dtype, -(-vecs // _THREADS)),
            _build.stream(index))
        _build.check(err, "bn_apply")
        _launched("bn_apply")
    return y


def readable(dy: torch.Tensor, x: torch.Tensor, dim: int) -> torch.Tensor:
    """dy for both backward steps: itself for the plain versions and where
    the kernels read it in place, else a copy in x's layout (counted in
    `dy_copies`)."""
    if _plain(x) or _grad_apart(dy, dim) is not None:
        return dy
    global dy_copies
    dy_copies += 1
    return torch.empty_like(x, dtype=dy.dtype).copy_(dy)


def backward_sums(x: torch.Tensor, dim: int, dy: torch.Tensor,
                  stats: torch.Tensor, bias: torch.Tensor,
                  relu: bool) -> torch.Tensor:
    """Step 3: (2, C) d beta, d gamma of this process's rows."""
    if _plain(x):
        return backward_sums_plain(x, dim, dy, stats, bias, relu)
    rows, C = rows_of(x, dim)
    _require_f32(x, (5, C), stats=stats)
    _require_f32(x, (C,), bias=bias)
    apart = _require_grad(x, dim, dy)
    index = x.get_device()
    stream = _build.stream(index)
    blocks = _reduce_blocks(index, _BWD_REDUCE, x, rows, C)
    partial = torch.empty((blocks, 2, C), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    err = _lib().bn_bwd_reduce_launch(
        x.data_ptr(), _CODES[x.dtype], dy.data_ptr(), apart,
        stats.data_ptr(), bias.data_ptr(), rows, C, int(relu),
        partial.data_ptr(), _ticket(index, stream).data_ptr(), blocks,
        out.data_ptr(), stream)
    _build.check(err, "bn_bwd_reduce")
    _launched("bn_bwd_reduce")
    return out


def backward_input(x: torch.Tensor, dim: int, dy: torch.Tensor,
                   mask: torch.Tensor | None, stats: torch.Tensor,
                   bias: torch.Tensor, sums: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    """Step 4: dx in x's type and layout from the processes' (2, C)
    sums."""
    if _plain(x):
        return backward_input_plain(x, dim, dy, mask, stats, bias, sums,
                                    relu)
    rows, C = rows_of(x, dim)
    _require_f32(x, (5, C), stats=stats)
    _require_f32(x, (C,), bias=bias)
    _require_f32(x, (2, C), sums=sums)
    if mask is not None:
        _require_mask(x, dim, mask)
    apart = _require_grad(x, dim, dy)
    dx = torch.empty_like(x)
    vecs = rows * C // (16 // x.element_size())
    if vecs:
        index = x.get_device()
        err = _lib().bn_bwd_apply_launch(
            x.data_ptr(), _CODES[x.dtype], dy.data_ptr(), apart,
            None if mask is None else mask.data_ptr(), stats.data_ptr(),
            bias.data_ptr(), sums.data_ptr(), dx.data_ptr(), vecs, C,
            int(relu), _blocks(index, _BWD_APPLY, x.dtype,
                               -(-vecs // _THREADS)),
            _build.stream(index))
        _build.check(err, "bn_bwd_apply")
        _launched("bn_bwd_apply")
    return dx
