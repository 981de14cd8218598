"""Run-copy voxel table: sorted channel-planar points + run starts ->
raw (B, K, T, 4) table.

Counterpart of the three run-copy kernels of
`voxelnet_tpu/kernels/voxelize_pallas.py` (`build_voxel_table_planar_t`,
`build_voxel_table_planar`, `build_voxel_table`): one function in three
TPU layouts, here one kernel. `run_copy` launches `csrc/run_copy.cu` for
CUDA tensors and runs `run_copy_plain` for CPU tensors; there is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from voxelnet_tpu_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = {"run_copy_launch": [_P] * 3 + [ctypes.c_int] * 4 + [_P]}


def gather_index(run_start: torch.Tensor, points_per_voxel: int):
    """(B, K) run starts -> (B, 4, K * T) int64 index into the stream
    zero-padded by T points (a run starting at N reads only zeros)."""
    B, K = run_start.shape
    t = torch.arange(points_per_voxel, device=run_start.device)
    idx = (run_start.long()[..., None] + t).reshape(B, 1, -1)
    return idx.expand(B, 4, K * points_per_voxel)


def run_copy_plain(planar: torch.Tensor, run_start: torch.Tensor,
                   points_per_voxel: int) -> torch.Tensor:
    """Plain torch version: one gather on the zero-padded stream."""
    B, _, _ = planar.shape
    K, T = run_start.shape[1], points_per_voxel
    padded = torch.nn.functional.pad(planar, (0, T))
    tab = torch.gather(padded, 2, gather_index(run_start, T))
    return tab.view(B, 4, K, T).permute(0, 2, 3, 1).contiguous()


def run_copy(planar: torch.Tensor, run_start: torch.Tensor,
             points_per_voxel: int) -> torch.Tensor:
    """planar (B, 4, N) f32 points sorted by voxel id, run_start (B, K)
    i32 (N = empty voxel) -> table (B, K, T, 4) f32 with
    table[b, k, t, c] = planar[b, c, run_start[b, k] + t], 0 at or past N.
    """
    if _build.on_cpu(planar):
        return run_copy_plain(planar, run_start, points_per_voxel)
    index = _build.require_cuda("run_copy", planar, run_start)
    B, _, N = planar.shape
    K = run_start.shape[1]
    _build.require_shapes("run_copy",
                          ("planar", planar, torch.float32, (B, 4, N)),
                          ("run_start", run_start, torch.int32, (B, K)))
    T = points_per_voxel
    if T < 1 or N + T >= 2 ** 31 or K * T >= 2 ** 31 or B > 65535:
        raise ValueError(f"run_copy: need points_per_voxel >= 1, "
                         f"N + T < 2**31, K * T < 2**31 and B <= 65535 "
                         f"(B={B}, N={N}, K={K}, T={T})")
    out = torch.empty((B, K, T, 4), dtype=torch.float32, device=planar.device)
    lib = _build.load("run_copy", _ARGTYPES)
    err = lib.run_copy_launch(planar.data_ptr(), run_start.data_ptr(),
                              out.data_ptr(), B, N, K, T,
                              _build.stream(index))
    _build.check(err, "run_copy")
    global launches
    launches += 1
    return out
