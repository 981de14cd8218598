"""Eval-time BatchNorm folding, as `voxelnet_tpu/models/bn_fold.py`.

At eval a BN is the per-channel affine y * s + t with s = scale /
sqrt(var + eps) and t = bias - mean * s, so each (conv, BN) pair folds into
the conv: weight * s on the out-channel axis, bias * s + t. The out-channel
axis is dim 0 of a Conv2d/Conv3d weight and dim 1 of a ConvTranspose2d
weight (cin, cout, kh, kw). The VFE's BNs fold in the fused kernel's
wrapper instead (kernels/vfe_fused.py::fold_layer).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def fold_pair_(conv: nn.Module, bn: nn.Module) -> None:
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    t = bn.bias - bn.running_mean * s
    out_dim = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
    shape = [1] * conv.weight.dim()
    shape[out_dim] = -1
    conv.weight.mul_(s.view(shape))
    conv.bias.copy_(conv.bias * s + t)


def fold_bn_(model: nn.Module) -> nn.Module:
    """Fold every (Conv_0 | ConvTranspose_0, BatchNorm_0) sibling pair of
    the middle and RPN stacks in place and drop the BN (set it to None, so
    the block skips it). Returns the model."""
    for m in list(model.modules()):
        bn = getattr(m, "BatchNorm_0", None)
        conv = getattr(m, "Conv_0", getattr(m, "ConvTranspose_0", None))
        if bn is not None and conv is not None:
            fold_pair_(conv, bn)
            m.BatchNorm_0 = None
    return model
