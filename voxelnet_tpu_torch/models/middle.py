"""3D convolutional middle layers, the `conv3d` lowering of
`voxelnet_tpu/models/middle.py`: three Conv3D+BN+ReLU blocks collapsing the
depth axis (Car: 10 -> 5 -> 3 -> 2), then the c-major depth->BEV fold
(bev_channel = c * D' + d). Module names follow the flax tree so the
weight bridge (convert.py) maps paths one to one."""

from __future__ import annotations

import torch
from torch import nn

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(x)
        if self.BatchNorm_0 is not None:   # None once folded (bn_fold.py)
            y = self.BatchNorm_0(y.float())
        return torch.relu(y).to(x.dtype)


class MiddleLayers(nn.Module):
    def __init__(self, cin: int = 128):
        super().__init__()
        for i, (cout, stride, pad) in enumerate(BLOCKS):
            self.add_module(f"ConvBlock3D_{i}",
                            ConvBlock3D(cin, cout, stride, pad))
            cin = cout

    def forward(self, dense: torch.Tensor) -> torch.Tensor:
        """dense (B, D, H, W, C) -> BEV (B, C' * D', H, W).

        The grid enters the convs as a permuted view: NCDHW indices over
        NDHWC memory (channels_last_3d), no copy."""
        x = dense.permute(0, 4, 1, 2, 3)
        for block in self.children():
            x = block(x)
        b, _, _, h, w = x.shape
        # c-major fold; NHWC memory for the channels-last RPN
        return x.permute(0, 3, 4, 1, 2).reshape(b, h, w, -1).permute(
            0, 3, 1, 2)
