"""Voxel Feature Encoding, eval mode: the parameters of
`voxelnet_tpu/models/vfe.py::FeatureLearningNet` (vfe1 7->32, vfe2 32->128,
each a Dense `fcn` + BatchNorm `bn`), run by the fused kernel."""

from __future__ import annotations

import torch
from torch import nn

from voxelnet_tpu_torch.kernels.vfe_fused import fold_layer, vfe_fused
from voxelnet_tpu_torch.ops.voxelize import Prepared


class VFELayer(nn.Module):
    """Dense(cin -> cout/2) + BN; ReLU, the masked max and the concat live
    in the kernel."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.fcn = nn.Linear(cin, cout // 2)
        self.bn = nn.BatchNorm1d(cout // 2, eps=1e-5, momentum=0.1)


class FeatureLearningNet(nn.Module):
    """Prepared (sorted) points -> voxelwise features (B, K, 128) bf16."""

    def __init__(self, points_per_voxel: int):
        super().__init__()
        self.points_per_voxel = points_per_voxel
        self.vfe1 = VFELayer(7, 32)
        self.vfe2 = VFELayer(32, 128)

    def forward(self, prep: Prepared) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "FeatureLearningNet runs in eval mode only (masked-BN "
                "training is not ported)")
        w1, a1 = fold_layer(self.vfe1.fcn, self.vfe1.bn, 8)
        w2, a2 = fold_layer(self.vfe2.fcn, self.vfe2.bn, 32)
        return vfe_fused(prep.sorted_planar, prep.run_start, prep.num_voxels,
                         prep.counts, w1, a1, w2, a2, self.points_per_voxel)
