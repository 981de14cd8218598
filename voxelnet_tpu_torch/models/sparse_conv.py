"""Sparse 3x3x3 convolution over the occupied-voxel table: middle block 1
under `data.middle_backend='sparse1'`, as
`voxelnet_tpu/models/sparse_conv.py::sparse_conv3x3`.

Block 1 reads a grid that is zero everywhere but at the ~1% of sites that
hold a voxel, so the conv is computed from the (B, K, C) voxel table the VFE
already produces: one (B * K, C) x (C, 27 * Cout) product, every offset's
contribution of every voxel, then the sum of those contributions into the
(B, Do, H, W, Cout) output (kernels/sparse_conv.py, a CUDA kernel on the
card). The 128-channel dense grid is never built. The same convolution as
the dense Conv3d of the grid, to one bf16 ulp (the sums run in another
order).
"""

from __future__ import annotations

import torch

from voxelnet_tpu_torch.kernels.sparse_conv import (depth_out,
                                                    sparse_conv_autograd)
from voxelnet_tpu_torch.parallel.spatial import no_columns


def weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (Cout, Cin, 3, 3, 3) -> (Cin, 27 * Cout), offset-major
    o = (kd * 3 + ky) * 3 + kx: JAX's `transpose(kernel, (3, 0, 1, 2, 4))`
    of the same weight (`sparse_conv.py:86`). A view where the weight is
    laid out in that order (models/voxelnet.py::prepare_for_inference)."""
    return weight.permute(1, 2, 3, 4, 0).reshape(weight.shape[1], -1)


def sparse_conv3x3(feat: torch.Tensor, coords: torch.Tensor,
                   counts: torch.Tensor, occ: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor, stride_d: int,
                   pad_d: int, w_window=None,
                   relu: bool = False) -> torch.Tensor:
    """Exact 3x3x3 / stride (stride_d, 1, 1) / pad (pad_d, 1, 1) conv of the
    zero-backed voxel table.

    feat (B, K, C) in the compute type; coords (B, K, 3) int32 zyx and
    counts (B, K) int32 (0 marks padding rows, whose coords are arbitrary
    and whose features are masked here); occ their
    kernels/sparse_conv.py::occupancy_map (B, D, H, W), which carries the
    grid; weight the Conv3d's (Cout, C, 3, 3, 3), bias (Cout,).
    w_window=(x0, wloc) computes only output columns [x0, x0 + wloc) (the
    spatial-sharding unit); an empty window (wloc 0, where occ may have
    no columns) runs nothing and returns `no_columns`. relu=True applies
    a ReLU to the output in the sum's store (the block's ReLU where no BN
    sits between).

    The product is rounded to feat's type and then widened, as JAX computes
    `vals` in feat.dtype (`sparse_conv.py:87`); the sum and the bias run in
    f32 (f64 for an f64 feat, where JAX's acc_dtype would round to f32, as
    the port's f64 check mode keeps its BN statistics in f64).
    Returns (B, Do, H, wloc, Cout) in feat's type."""
    B, K, _ = feat.shape
    if w_window is not None and w_window[1] == 0:
        D, H = occ.shape[1:3]
        return no_columns((B, depth_out(D, stride_d, pad_d), H, 0,
                           weight.shape[0]), feat, weight, bias)
    feat = torch.where((counts > 0)[..., None], feat, 0)
    vals = feat @ weight_matrix(weight.to(feat.dtype))
    acc = torch.promote_types(feat.dtype, torch.float32)
    return sparse_conv_autograd(vals.view(B, K, 27, -1), coords, counts, occ,
                                bias.to(acc), stride_d, pad_d, w_window, relu)
