"""The train-mode batch norm's autograd Function (models/bn.py::
BatchNormFn, behind flax_batch_norm) on the CPU, where it runs the plain
steps of kernels/batch_norm.py: the forward, the analytic backward and the
running stats held to autograd of the plain formulation that the port used
before the Function (kept here as the oracle), in f64 and in bf16; the CUDA
wrapper's refusals without a card."""

import contextlib

import numpy as np
import pytest
import torch
from torch_port_helpers import two_torch_threads  # noqa: F401
from torch.utils.checkpoint import checkpoint

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.kernels import batch_norm as bn_kernels
from voxelnet_tpu_torch.models import bn as bn_mod

REL = 1e-9


def oracle(bn, x, dim, mask, relu, out_dtype, update=True):
    """The port's train-mode BN before the Function, by autograd: f32 (f64
    for f64) statistics over the rows where mask, var clipped at 0, the
    running stats moved by 0.9 / 0.1, then a ReLU where asked and the
    cast."""
    dim %= x.dim()
    axes = [d for d in range(x.dim()) if d != dim]
    shape = [1] * x.dim()
    shape[dim] = -1
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    if mask is None:
        s1, s2 = xs.sum(axes), (xs * xs).sum(axes)
        n = torch.full_like(s1, xs.numel() // s1.numel())
    else:
        m = torch.broadcast_to(mask, xs.shape)
        zero = xs.new_zeros(())
        s1 = torch.where(m, xs, zero).sum(axes)
        s2 = torch.where(m, xs * xs, zero).sum(axes)
        n = m.sum(axes).to(xs.dtype)
    mean, mean2 = s1 / n, s2 / n
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    if update:
        with torch.no_grad():
            bn.running_mean.copy_(0.9 * bn.running_mean + (1 - 0.9) * mean)
            bn.running_var.copy_(0.9 * bn.running_var + (1 - 0.9) * var)
    mul = torch.rsqrt(var + 1e-5) * bn.weight
    y = (xs - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return (torch.relu(y) if relu else y).to(out_dtype)


# name -> (shape, channel dim, mask, relu)
CASES = {
    "vfe1-mask": ((2, 6, 5, 16), -1, True, False),
    "vfe2-mask": ((2, 6, 5, 64), -1, True, False),
    "vfe-no-mask": ((2, 6, 5, 64), -1, False, False),
    "middle-relu": ((2, 64, 3, 4, 5), 1, False, True),
    "middle-no-relu": ((2, 64, 3, 4, 5), 1, False, False),
    "rpn128-relu": ((2, 128, 4, 5), 1, False, True),
    "rpn256-relu": ((2, 256, 3, 4), 1, False, True),
    "relu-mask-last": ((2, 4, 5, 16), 3, True, True),
    "constant-channel": ((2, 16, 3, 4, 5), 1, False, False),
    "constant-channel-mask": ((2, 6, 5, 16), -1, True, False),
}


def _inputs(name, dtype, seed=0):
    shape, dim, masked, relu = CASES[name]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.3, 2.0, shape)).to(dtype)
    c = shape[dim]
    mask = None
    if masked:
        counts = rng.integers(0, shape[2] + 1, shape[:2])
        counts[:, 0] = shape[2]
        mask = torch.from_numpy(np.arange(shape[2])[None, None, :]
                                < counts[..., None])[..., None]
    if name.startswith("constant"):
        assert _engage_clamp(x, dim, mask) == (dtype == torch.float64)
    bn = torch.nn.BatchNorm1d(c).to(dtype if dtype == torch.float64
                                    else torch.float32).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, c)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
    w = torch.from_numpy(rng.normal(0, 1, shape))
    return x, dim, mask, relu, bn, w


def _engage_clamp(x, dim, mask) -> bool:
    """Make channel 3 of x nearly constant, at a level whose statistics
    give E[x^2] - E[x]^2 < 0 over the counted rows in the statistics' type
    -> whether one did. In f64 the channel is 1e5 + 3e-4 noise: the
    cancellation's rounding exceeds its true variance, yet x - mean is far
    from 0, so a backward that kept the variance term would show. In bf16
    a constant's sums over a few dozen rows are exact and none does: the
    channel's variance is then 0."""
    idx = [slice(None)] * x.dim()
    idx[dim] = 3
    noise = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, x[tuple(idx)].shape))
    for v in np.linspace(0.1, 3.0, 300):
        if x.dtype == torch.float64:
            x[tuple(idx)] = 1e5 * v + 3e-4 * noise
        else:
            x[tuple(idx)] = float(v)
        s1, s2, n = bn_kernels.sums_plain(x, dim, mask)[:, 3]
        if float(s2 / n - (s1 / n) * (s1 / n)) < 0:
            return True
    return False


def _run(fn, bn, x, w, out_dtype):
    """fn(bn, x) -> y; the backward of sum(y * w) -> y, x's, gamma's and
    beta's gradients and the running stats."""
    x = x.clone().requires_grad_()
    y = fn(bn, x)
    assert y.dtype == out_dtype
    (y.to(w.dtype) * w).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def _close(got, want, rtol, what):
    torch.testing.assert_close(
        got.double(), want.double(), rtol=rtol,
        atol=rtol * max(float(want.double().abs().max()), 1e-30),
        msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("remat", ["none", "checkpoint"])
@pytest.mark.parametrize("dtype", ["f64", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_autograd_of_the_plain_formulation(name, dtype,
                                                            remat):
    """flax_batch_norm in train mode (the Function) against autograd of
    the plain formulation: y, dx (non-zero upstream gradients on rows the
    mask leaves out too), d gamma, d beta and the running stats, moved
    once also where the forward is recomputed under torch.utils.checkpoint
    with running_stats_frozen(), as train.remat runs it. f64 at rel 1e-9;
    bf16 in and out (the port's compute type) with f32 statistics: y
    equal (the same f32 operations), the gradients within bf16 rounding
    (the analytic backward sums in another order)."""
    dt = torch.float64 if dtype == "f64" else torch.bfloat16
    x, dim, mask, relu, bn, w = _inputs(name, dt)
    bn_want = torch.nn.BatchNorm1d(bn.num_features).to(bn.weight.dtype)
    bn_want.load_state_dict(bn.state_dict())
    bn_want.train()

    def fused(m, inp):
        def f(t):
            return bn_mod.flax_batch_norm(m, t, dim, mask, relu=relu,
                                          out_dtype=dt)
        if remat == "none":
            return f(inp)
        return checkpoint(f, inp, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), bn_mod.running_stats_frozen()))

    if name.startswith("constant"):
        stats = bn_kernels.statistics(x, dim, mask, bn.weight,
                                      bn.running_mean, bn.running_var, False,
                                      0.9, 1e-5)
        assert bn_kernels.Stats(*stats).clamped.tolist() == [
            float(c == 3 and dtype == "f64") for c in range(bn.num_features)]
    got = _run(fused, bn, x, w, dt)
    want = _run(lambda m, inp: oracle(m, inp, dim, mask, relu, dt),
                bn_want, x, w, dt)
    for key in ("running_mean", "running_var", "y"):
        _close(got[key], want[key], REL if dt == torch.float64 else 0, key)
    rtol = REL if dt == torch.float64 else 2 ** -7
    for key in ("weight_grad", "bias_grad"):
        _close(got[key], want[key], REL if dt == torch.float64 else 1e-5,
               key)
    _close(got["x_grad"], want["x_grad"], rtol, "x_grad")


def test_traced_call_counts_no_launch_on_the_cpu():
    """The plain steps launch nothing: inside a traced call the
    `bn.launches` counter stays empty on the CPU, and the launch counts do
    not move."""
    x, dim, mask, relu, bn, w = _inputs("vfe1-mask", torch.float64)
    before = dict(bn_kernels.launches)
    with tracing.call("train", [], "cpu") as call:
        _run(lambda m, inp: bn_mod.flax_batch_norm(m, inp, dim, mask),
             bn, x, w, torch.float64)
    assert call.count("bn.launches") == 0
    assert bn_kernels.launches == before


@pytest.mark.parametrize("make, match", [
    (lambda: torch.zeros(2, 16), "CUDA tensors"),
])
def test_kernel_wrapper_refuses_cpu_tensors(make, match):
    """The kernels' own entry refuses a CPU tensor (the steps take their
    plain versions for those before reaching it)."""
    with pytest.raises(ValueError, match=match):
        bn_kernels.rows_of(make(), 1)


def test_backward_reads_gradient_rows_where_they_lie(monkeypatch):
    """The backward kernels read the upstream gradient in place where its
    channels are innermost and its rows evenly spaced (a slice of the
    RPN's concatenation's gradient), and copy it into x's layout only
    otherwise (the BEV fold's gradient, depth innermost). The layout
    logic is stride arithmetic, run here on CPU tensors as if the
    kernels took them; the plain steps never copy."""
    x = torch.zeros(2, 4, 5, 16).movedim(-1, 1)            # NHWC
    cat = torch.zeros(2, 4, 5, 48).movedim(-1, 1)          # 3 of them
    folded = torch.zeros(2, 4, 5, 16, 3).permute(0, 3, 4, 1, 2)
    x5 = torch.zeros(2, 3, 4, 5, 16).movedim(-1, 1)
    copies = bn_kernels.dy_copies
    assert bn_kernels.readable(folded, x5, 1) is folded
    assert bn_kernels.dy_copies == copies
    monkeypatch.setattr(bn_kernels, "_plain", lambda t: False)
    dy = bn_kernels.readable(cat[:, 16:32], x, 1)
    assert dy.data_ptr() == cat[:, 16:32].data_ptr()
    assert bn_kernels._grad_apart(dy, 1) == 48
    assert bn_kernels._grad_apart(bn_kernels.readable(x + 1, x, 1), 1) == 16
    assert bn_kernels._rows_apart(torch.zeros(2, 16, 4, 4), 1) is None
    assert bn_kernels._rows_apart(torch.zeros(4, 32)[:, :16], 1) == 32
    assert bn_kernels._rows_apart(torch.zeros(1, 16), 1) == 16
    # an empty W slab, in whatever strides its maker gave it
    assert bn_kernels._rows_apart(torch.zeros(2, 16, 3, 0), 1) == 16
    dy = bn_kernels.readable(folded, x5, 1)
    assert bn_kernels.dy_copies == copies + 1
    assert bn_kernels._grad_apart(dy, 1) == 16
    assert dy.stride() == x5.stride() and torch.equal(dy, folded)
