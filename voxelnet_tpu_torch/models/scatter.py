"""Sparse voxel features -> dense (B, D, H, W, C) grid, as
`voxelnet_tpu/models/scatter.py::scatter_to_dense_streamed`, with a
gradient with respect to the voxel features; or one W slab of it under
spatial sharding (parallel/spatial.py)."""

from __future__ import annotations

import torch

from voxelnet_tpu_torch.kernels.dense_build import dense_build_autograd


def scatter_to_dense_streamed(voxel_features: torch.Tensor,
                              coords: torch.Tensor, counts: torch.Tensor,
                              grid_dzyx: tuple[int, int, int],
                              w_window=None) -> torch.Tensor:
    """(B, K, C) + zyx coords (B, K, 3) + counts (B, K) -> (B, D, H, W, C),
    contiguous. Needs the voxelizer's order: ascending (z*H + y)*W + x per
    frame with empty voxels (count 0) trailing.

    w_window=(x0, wloc) builds only the columns [x0, x0 + wloc), as
    (B, D, H, wloc, C). The kernel's ids must ascend with padding
    trailing, so each frame's rows in the window are first moved to the
    front by a stable partition (their order kept, a row gather that
    autograd carries back) and given the slab's ids
    (z*H + y)*wloc + x - x0."""
    D, H, W = grid_dzyx
    x0, wloc = (0, W) if w_window is None else w_window
    live = counts > 0
    if w_window is not None:
        x = coords[..., 2]
        live = live & (x >= x0) & (x < x0 + wloc)
        order = torch.argsort((~live).to(torch.int32), dim=1, stable=True)
        voxel_features = torch.gather(
            voxel_features, 1,
            order[..., None].expand(-1, -1, voxel_features.shape[-1]))
        coords = torch.gather(coords, 1, order[..., None].expand(-1, -1, 3))
        live = torch.gather(live, 1, order)
    n = D * H * wloc
    linear = (coords[..., 0] * H + coords[..., 1]) * wloc + coords[..., 2] - x0
    ids = torch.where(live, linear, n).to(torch.int32)
    dense = dense_build_autograd(voxel_features, ids, n)
    b, _, c = voxel_features.shape
    return dense.view(b, D, H, wloc, c)
