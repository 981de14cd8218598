"""Streaming dense-grid build: sorted voxel rows -> (B, n_cells, C), and its
gradient.

Counterpart of `voxelnet_tpu/kernels/dense_build.py` (`dense_build_pallas`
with its custom_vjp). Per frame the linear cell ids ascend and padding rows
carry the id `n_cells` at the end, the order the voxelizer emits.
`dense_build` launches `csrc/dense_build.cu` for CUDA tensors and runs
`dense_build_plain` for CPU tensors; there is no fallback from one to the
other. `dense_build_autograd` adds the backward: a row gather of the
grid's gradient at `ids`, zero for padding rows, as the JAX `_bwd` does in
XLA (not in Pallas), so here it is a torch gather.
"""

from __future__ import annotations

import ctypes

import torch

from voxelnet_tpu_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P = ctypes.c_void_p
_SIG = [_P] * 3 + [ctypes.c_int] * 4 + [_P]
_ARGTYPES = {"dense_build_launch": _SIG, "dense_build_f32_launch": _SIG}
# element type -> (exported launcher, elements per 16-byte chunk)
_LAUNCHERS = {torch.bfloat16: ("dense_build_launch", 8),
              torch.float32: ("dense_build_f32_launch", 4)}


def dense_build_plain(feat: torch.Tensor, ids: torch.Tensor,
                      n_cells: int) -> torch.Tensor:
    """Plain torch version: zero grid plus a row copy; padding rows go to
    a spare row past the grid that is cut off."""
    B, K, C = feat.shape
    flat = feat.new_zeros((B * n_cells + 1, C))
    base = torch.arange(B, device=feat.device)[:, None] * n_cells
    target = torch.where(ids < n_cells, base + ids.long(), B * n_cells)
    flat.index_copy_(0, target.reshape(-1), feat.reshape(-1, C))
    return flat[: B * n_cells].view(B, n_cells, C)


def dense_build(feat: torch.Tensor, ids: torch.Tensor,
                n_cells: int) -> torch.Tensor:
    """feat (B, K, C), ids (B, K) i32 ascending per frame (padding =
    n_cells) -> (B, n_cells, C), contiguous (NDHWC for a (D, H, W) grid).
    The kernel takes bf16 rows with C a multiple of 8, or f32 rows with C a
    multiple of 4."""
    if _build.on_cpu(feat):
        return dense_build_plain(feat, ids, n_cells)
    index = _build.require_cuda("dense_build", feat, ids)
    B, K, C = feat.shape
    if feat.dtype not in _LAUNCHERS:
        raise ValueError(f"dense_build: feat must be torch.bfloat16 or "
                         f"torch.float32, got {feat.dtype}")
    fn, per_chunk = _LAUNCHERS[feat.dtype]
    _build.require_shapes("dense_build",
                          ("feat", feat, feat.dtype, (B, K, C)),
                          ("ids", ids, torch.int32, (B, K)))
    if C % per_chunk or not 0 < n_cells < 2 ** 31 or K < 1:
        raise ValueError(f"dense_build: need C % {per_chunk} == 0, K >= 1 "
                         f"and 0 < n_cells < 2**31 (C={C}, K={K}, "
                         f"n={n_cells})")
    out = torch.empty((B, n_cells, C), dtype=feat.dtype, device=feat.device)
    lib = _build.load("dense_build", _ARGTYPES)
    err = getattr(lib, fn)(feat.data_ptr(), ids.data_ptr(), out.data_ptr(),
                           B, K, n_cells, C, _build.stream(index))
    _build.check(err, "dense_build")
    global launches
    launches += 1
    return out


def dense_build_grad(grad: torch.Tensor, ids: torch.Tensor,
                     n_cells: int) -> torch.Tensor:
    """d(dense_build)/d(feat): grad (B, n_cells, C) -> (B, K, C), the rows
    at `ids`, zero where ids == n_cells (padding)."""
    C = grad.shape[-1]
    safe = torch.clamp(ids, max=n_cells - 1).long()
    rows = torch.gather(grad, 1, safe[..., None].expand(-1, -1, C))
    return rows * (ids < n_cells)[..., None].to(rows.dtype)


class _DenseBuild(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, ids, n_cells):
        ctx.save_for_backward(ids)
        ctx.n_cells = n_cells
        return dense_build(feat, ids, n_cells)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return dense_build_grad(grad, ids, ctx.n_cells), None, None


def dense_build_autograd(feat: torch.Tensor, ids: torch.Tensor,
                         n_cells: int) -> torch.Tensor:
    """`dense_build` with a gradient with respect to `feat`."""
    return _DenseBuild.apply(feat, ids, n_cells)
