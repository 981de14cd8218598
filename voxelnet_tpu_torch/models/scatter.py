"""Sparse voxel features -> dense (B, D, H, W, C) grid, as
`voxelnet_tpu/models/scatter.py::scatter_to_dense_streamed`, with a
gradient with respect to the voxel features."""

from __future__ import annotations

import torch

from voxelnet_tpu_torch.kernels.dense_build import dense_build_autograd


def scatter_to_dense_streamed(voxel_features: torch.Tensor,
                              coords: torch.Tensor, counts: torch.Tensor,
                              grid_dzyx: tuple[int, int, int]) -> torch.Tensor:
    """(B, K, C) + zyx coords (B, K, 3) + counts (B, K) -> (B, D, H, W, C),
    contiguous. Needs the voxelizer's order: ascending (z*H + y)*W + x per
    frame with empty voxels (count 0) trailing."""
    D, H, W = grid_dzyx
    n = D * H * W
    linear = (coords[..., 0] * H + coords[..., 1]) * W + coords[..., 2]
    ids = torch.where(counts > 0, linear, n).to(torch.int32)
    dense = dense_build_autograd(voxel_features, ids, n)
    b, _, c = voxel_features.shape
    return dense.view(b, D, H, W, c)
