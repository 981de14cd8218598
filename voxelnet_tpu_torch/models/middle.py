"""3D convolutional middle layers, the `conv3d` and `sparse1` lowerings of
`voxelnet_tpu/models/middle.py`: three Conv3D+BN+ReLU blocks collapsing the
depth axis (Car: 10 -> 5 -> 3 -> 2), then the c-major depth->BEV fold
(bev_channel = c * D' + d). `forward` takes the dense grid; `from_table`
(sparse1) runs block 1 on its own Conv_0 weight and bias straight from the
voxel table (models/sparse_conv.py) and blocks 2-3 as Conv3d. Both share
one parameter tree, whose module names follow the flax tree so the weight
bridge (convert.py) maps paths one to one.

Conv weights are cast to the input's dtype at use (f32 master weights,
as flax's `dtype`/`param_dtype`; a no-op on the inference copy, whose
weights `prepare_for_inference` cast once). Train mode normalises with
batch statistics in f32 (models/bn.py); eval mode with torch's BN on the
running stats, or not at all once folded.

Under spatial sharding (`mesh`, a parallel/mesh.ProcessMesh with a model
axis) each process holds one W slab (parallel/spatial.py): each Conv3d
(W kernel 3, padding 1) runs with W padding 0 on its slab widened by a
halo of one column a side, and sparse1's block 1 computes its slab's
output columns from the whole voxel table, halo-free
(`voxelnet_tpu/models/sparse_conv.py::sparse_conv3x3_sharded`). The BN
statistics sum over the world: its processes hold disjoint slabs of
disjoint rows, and halo columns never enter them."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from voxelnet_tpu_torch.models.bn import flax_batch_norm
from voxelnet_tpu_torch.models.sparse_conv import sparse_conv3x3
from voxelnet_tpu_torch.parallel.spatial import halo_exchange, slab

# (cout, depth stride, depth pad) per block
BLOCKS = ((64, 2, 1), (64, 1, 0), (64, 2, 1))


def depth_out(din: int) -> int:
    for _, stride, pad in BLOCKS:
        din = (din + 2 * pad - 3) // stride + 1
    return din


class ConvBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int, stride_d: int, pad_d: int):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, cout, 3, stride=(stride_d, 1, 1),
                                padding=(pad_d, 1, 1))
        self.BatchNorm_0 = nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """x (B, C, D, H, W), or this process's W slab of it under a
        model axis of `mesh`."""
        conv = self.Conv_0
        padding = conv.padding
        if mesh is not None:
            x = halo_exchange(x, 1, 1, mesh.model_group)
            padding = padding[:2] + (0,)
        y = F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                     conv.stride, padding)
        return bn_relu(self.BatchNorm_0, y, x.dtype)

    def from_table(self, feat, coords, counts, occ,
                   w_window=None) -> torch.Tensor:
        """The block on the zero-backed voxel table (B, K, C) with its
        occupancy map: sparse conv (f32 bias), BN, ReLU -> NCDHW indices
        over NDHWC memory, as `forward` returns; only the output columns
        of w_window=(x0, wloc) where given. Once the BN is folded away
        (bn_fold.py), the ReLU runs in the sum's store instead of a pass
        of its own."""
        conv = self.Conv_0
        folded = self.BatchNorm_0 is None
        y = sparse_conv3x3(feat, coords, counts, occ, conv.weight, conv.bias,
                           conv.stride[0], conv.padding[0], w_window,
                           relu=folded)
        y = y.permute(0, 4, 1, 2, 3)
        return y if folded else bn_relu(self.BatchNorm_0, y, feat.dtype)


def bn_relu(bn, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """BN (flax batch statistics in train mode; torch's eval BN, or none
    once folded by bn_fold.py) in f32 (in the type of the BN's parameters
    where a caller made them f64), then ReLU, in `dtype`."""
    if bn is not None and bn.training:
        y = flax_batch_norm(bn, y, 1)
    elif bn is not None:
        y = bn(y.to(bn.weight.dtype))
    return torch.relu(y).to(dtype)


class MiddleLayers(nn.Module):
    def __init__(self, cin: int = 128):
        super().__init__()
        for i, (cout, stride, pad) in enumerate(BLOCKS):
            self.add_module(f"ConvBlock3D_{i}",
                            ConvBlock3D(cin, cout, stride, pad))
            cin = cout

    def forward(self, dense: torch.Tensor, mesh=None) -> torch.Tensor:
        """dense (B, D, H, W, C) -> BEV (B, C' * D', H, W); under a model
        axis of `mesh`, this process's W slab of each.

        The grid enters the convs as a permuted view: NCDHW indices over
        NDHWC memory (channels_last_3d), no copy."""
        x = dense.permute(0, 4, 1, 2, 3)
        for block in self.children():
            x = block(x, mesh)
        return _bev(x)

    def from_table(self, feat: torch.Tensor, coords: torch.Tensor,
                   counts: torch.Tensor, occ: torch.Tensor,
                   mesh=None) -> torch.Tensor:
        """sparse1: voxel table feat (B, K, C) in the compute type, int32
        coords (B, K, 3) and counts (B, K), and their occupancy map
        (B, D, H, W) of the whole grid -> BEV (B, C' * D', H, W); block 1
        from the table, blocks 2-3 and the fold as `forward`. Under a
        model axis of `mesh`, block 1 computes this process's W slab
        (whose taps read the map's columns on either side of it)."""
        first, *rest = self.children()
        window = None
        if mesh is not None:
            window = slab(occ.shape[-1], mesh.num_model, mesh.model_index)
        x = first.from_table(feat, coords, counts, occ, window)
        for block in rest:
            x = block(x, mesh)
        return _bev(x)


def _bev(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D', H, W) -> (B, C * D', H, W)"""
    b, _, _, h, w = x.shape
    # c-major fold; NHWC memory for the channels-last RPN
    return x.permute(0, 3, 4, 1, 2).reshape(b, h, w, -1).permute(0, 3, 1, 2)
