"""Streaming dense-grid build (forward): sorted voxel rows -> (B, n_cells, C).

Counterpart of `voxelnet_tpu/kernels/dense_build.py` (`dense_build_pallas`
forward). Per frame the linear cell ids ascend and padding rows carry the
id `n_cells` at the end, the order the voxelizer emits. `dense_build`
launches `csrc/dense_build.cu` for CUDA tensors and runs
`dense_build_plain` for CPU tensors; there is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from voxelnet_tpu_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = {"dense_build_launch": [_P] * 3 + [ctypes.c_int] * 4 + [_P]}


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
    The kernel takes bf16 rows with C a multiple of 8."""
    if _build.on_cpu(feat):
        return dense_build_plain(feat, ids, n_cells)
    _build.require_cuda("dense_build", feat, ids)
    B, K, C = feat.shape
    _build.require_shapes("dense_build", {
        "feat": (feat, torch.bfloat16, (B, K, C)),
        "ids": (ids, torch.int32, (B, K))})
    if C % 8 or not 0 < n_cells < 2 ** 31 or K < 1:
        raise ValueError(f"dense_build: need C % 8 == 0, K >= 1 and "
                         f"0 < n_cells < 2**31 (C={C}, K={K}, n={n_cells})")
    out = torch.empty((B, n_cells, C), dtype=feat.dtype, device=feat.device)
    lib = _build.load("dense_build", _ARGTYPES)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dense_build_launch(feat.data_ptr(), ids.data_ptr(),
                                 out.data_ptr(), B, K, n_cells, C, stream)
    _build.check(err, "dense_build")
    global launches
    launches += 1
    return out
