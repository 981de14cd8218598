"""Parameter initialization with an explicit torch.Generator.

The same distributions as `voxelnet_tpu/models/init.py` (the reference's
torch defaults): weights and biases uniform in +-1/sqrt(fan_in), where a
transposed conv's fan is its out-channels times its taps (weight.shape[1]
of torch's (cin, cout, kh, kw) layout). BatchNorm starts at scale 1,
bias 0, mean 0, var 1. The numbers differ from JAX's for the same seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_WEIGHTED = (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)
_BN = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)


@torch.no_grad()
def init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _WEIGHTED):
            fan = m.weight.shape[1] * math.prod(m.weight.shape[2:])
            bound = 1.0 / math.sqrt(fan)
            for p in (m.weight, m.bias):
                p.copy_(torch.empty(p.shape).uniform_(
                    -bound, bound, generator=generator))
        elif isinstance(m, _BN):
            m.reset_parameters()
    return model


@torch.no_grad()
def randomize_bn_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random BN affines and running stats (scale and var in [0.5, 1.5],
    bias and mean ~ N(0, 0.1)), so a BN fold has something to fold."""
    for m in model.modules():
        if isinstance(m, _BN):
            n = m.num_features
            m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
            m.bias.copy_(0.1 * torch.randn(n, generator=generator))
            m.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
            m.running_var.copy_(torch.rand(n, generator=generator) + 0.5)
    return model
