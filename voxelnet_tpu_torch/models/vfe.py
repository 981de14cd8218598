"""Voxel Feature Encoding: the parameters of
`voxelnet_tpu/models/vfe.py::FeatureLearningNet` (vfe1 7->32, vfe2 32->128,
each a Dense `fcn` + BatchNorm `bn`) and its two forwards:

  * `forward(prep)`, inference in eval mode: the fused kernel
    (kernels/vfe_fused.py) straight from the sorted point stream;
  * `table(features, counts)`, either mode: the flax module's math on the
    explicit (B, K, T, 7) table, as the train and eval steps use it, and
    inference with `compat.bn_over_padding`.

`bn_over_padding` (compat.bn_over_padding) gives the reference's
ghost-activation semantics (voxelnet/model.py:74-77, 100), as the JAX
module's flag does: BN statistics over every slot, empty ones included,
and maxima over every slot (the zero rows' activations too). The fused
kernel implements only the masked semantics, so `forward` refuses it.
"""

from __future__ import annotations

import torch
from torch import nn

from voxelnet_tpu_torch.kernels.vfe_fused import fold_layer, vfe_fused
from voxelnet_tpu_torch.models.bn import flax_batch_norm
from voxelnet_tpu_torch.ops.voxelize import Prepared

# masked-max fill; cast to the compute dtype before use, as the JAX
# module does (-1e9 in bf16 is -999817216)
NEG_FILL = -1e9


def _masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over the point axis (2) of the rows where mask (B, K, T, 1)."""
    fill = torch.tensor(NEG_FILL, dtype=x.dtype, device=x.device)
    return torch.where(mask, x, fill).amax(dim=2, keepdim=True)


class VFELayer(nn.Module):
    """Dense(cin -> cout/2), ReLU, BN, masked max, concat."""

    def __init__(self, cin: int, cout: int, bn_over_padding: bool = False):
        super().__init__()
        self.fcn = nn.Linear(cin, cout // 2)
        self.bn = nn.BatchNorm1d(cout // 2, eps=1e-5, momentum=0.1)
        self.bn_over_padding = bn_over_padding

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                group=None) -> torch.Tensor:
        """x (B, K, T, cin), mask (B, K, T, 1) bool -> (B, K, T, cout) in
        x's dtype. The Dense runs in x's dtype on f32 master weights cast
        at use; the BN's statistics (summed over `group`, default the
        world) and the max cover the stored points only, or every slot
        with bn_over_padding."""
        dtype = x.dtype
        y = torch.relu(nn.functional.linear(x, self.fcn.weight.to(dtype),
                                            self.fcn.bias.to(dtype)))
        if self.bn_over_padding:
            y = flax_batch_norm(self.bn, y, -1, group=group, out_dtype=dtype)
            agg = y.amax(dim=2, keepdim=True)
        else:
            y = flax_batch_norm(self.bn, y, -1, mask, group, out_dtype=dtype)
            agg = _masked_max(y, mask)
        return torch.cat([y, agg.expand_as(y)], dim=-1) * mask.to(dtype)


class FeatureLearningNet(nn.Module):
    """Voxel points -> voxelwise features (B, K, 128)."""

    def __init__(self, points_per_voxel: int, bn_over_padding: bool = False):
        super().__init__()
        self.points_per_voxel = points_per_voxel
        self.bn_over_padding = bn_over_padding
        self.vfe1 = VFELayer(7, 32, bn_over_padding)
        self.vfe2 = VFELayer(32, 128, bn_over_padding)

    def forward(self, prep: Prepared) -> torch.Tensor:
        """Prepared (sorted) points -> (B, K, 128) bf16 through the fused
        kernel, BN folded from the running stats (eval mode only)."""
        if self.training:
            raise NotImplementedError(
                "the fused VFE kernel runs in eval mode only; train mode "
                "runs FeatureLearningNet.table on the voxel table")
        if self.bn_over_padding:
            raise NotImplementedError(
                "the fused VFE kernel implements the masked max only; "
                "bn_over_padding runs FeatureLearningNet.table")
        w1, a1 = fold_layer(self.vfe1.fcn, self.vfe1.bn, 8)
        w2, a2 = fold_layer(self.vfe2.fcn, self.vfe2.bn, 32)
        return vfe_fused(prep.sorted_planar, prep.run_start, prep.num_voxels,
                         prep.counts, w1, a1, w2, a2, self.points_per_voxel)

    def table(self, features: torch.Tensor, counts: torch.Tensor,
              dtype: torch.dtype, group=None) -> torch.Tensor:
        """features (B, K, T, 7) f32, counts (B, K) -> (B, K, 128) in
        `dtype` (the compute dtype), zero for empty voxels. Train-mode BN
        statistics sum over `group`: the data group where a model group
        replicates the table (parallel/mesh.py), else the world (None)."""
        T = features.shape[2]
        mask = (torch.arange(T, device=features.device)
                < counts[..., None])[..., None]
        x = self.vfe1(features.to(dtype), mask, group)
        x = self.vfe2(x, mask, group)
        # with bn_over_padding the zero rows take part: each channel >= 0
        voxelwise = (x.amax(dim=2) if self.bn_over_padding
                     else _masked_max(x, mask)[:, :, 0])
        return voxelwise * (counts > 0)[..., None].to(dtype)
