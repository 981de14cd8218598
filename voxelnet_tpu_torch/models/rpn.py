"""2D convolutional Region Proposal Network, as `voxelnet_tpu/models/rpn.py`:
three conv blocks (5 + 6 + 6 convs), each deconvolved to a common
(H/2, W/2) map, concatenated to 768 channels, then 1x1 cls/reg heads that
return f32 logits. flax 'SAME' (k3 s1) is padding 1, 'VALID' (k2 s2, k4 s4)
padding 0. Module names follow the flax tree. Weights are cast at use and
BN runs as in models/middle.py (`bn_relu`).

Under spatial sharding (`mesh`, a parallel/mesh.ProcessMesh with a model
axis) each process holds one W slab of every map (parallel/spatial.py),
cut in units of 4 * block1_stride BEV columns, one column of the coarsest
map: at every level a slab starts on a multiple of the level's unit and
spans whole units, so each conv reads the halo its taps need, then runs
with W padding 0: k3 s1 a column a side; k3 s2 only the left one (a slab
starts at an even column and spans an even number, so its last output's
taps end inside it); the k3 s1 deconv a column a side, its W padding 2
cropping the output back to the slab; the k2 s2 and k4 s4 deconvs and the
1x1 heads none. An empty slab runs no conv (`apply_conv`) but joins
every collective. The heads' maps are then gathered whole on every
process of the model group (`gather_w`)."""

from __future__ import annotations

import torch
from torch import nn

from voxelnet_tpu_torch.models.middle import apply_conv, bn_relu
from voxelnet_tpu_torch.parallel.spatial import gather_w, halo_exchange


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        conv = self.Conv_0
        padding, empty = conv.padding, x.shape[-1] == 0
        if mesh is not None:
            right = 1 if conv.stride[1] == 1 else 0
            x = halo_exchange(x, 1, right, mesh.model_group)
            padding = (padding[0], 0)
        return bn_relu(self.BatchNorm_0, apply_conv(conv, x, padding, empty),
                       x.dtype)


class DeconvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            cin, cout, kernel, stride=stride, padding=1 if stride == 1 else 0)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        conv = self.ConvTranspose_0
        padding, empty = conv.padding, x.shape[-1] == 0
        if mesh is not None and conv.stride[1] == 1:
            x = halo_exchange(x, 1, 1, mesh.model_group)
            padding = (padding[0], 2)
        return bn_relu(self.BatchNorm_0, apply_conv(conv, x, padding, empty),
                       x.dtype)


class RPN(nn.Module):
    """BEV (B, cin, H, W) -> cls logits (B, H', W', 2), reg (B, H', W', 14),
    H' = H / 2 for block1_stride 2 (H for 1); under a model axis of
    `mesh` from this process's W slab of the BEV map, its columns from
    `x0` of `width`, to the whole maps."""

    def __init__(self, cin: int = 128, block1_stride: int = 2):
        super().__init__()
        self.block1_stride = block1_stride
        convs = ([(cin, 128, block1_stride)] + [(128, 128, 1)] * 4
                 + [(128, 128, 2)] + [(128, 128, 1)] * 5
                 + [(128, 256, 2)] + [(256, 256, 1)] * 5)
        for i, (ci, co, s) in enumerate(convs):
            self.add_module(f"ConvBNReLU_{i}", ConvBNReLU(ci, co, s))
        self.DeconvBNReLU_0 = DeconvBNReLU(128, 256, 3, 1)
        self.DeconvBNReLU_1 = DeconvBNReLU(128, 256, 2, 2)
        self.DeconvBNReLU_2 = DeconvBNReLU(256, 256, 4, 4)
        self.prob_conv = nn.Conv2d(768, 2, 1)
        self.reg_conv = nn.Conv2d(768, 14, 1)

    def _convs(self, x, lo, hi, mesh):
        for i in range(lo, hi):
            x = getattr(self, f"ConvBNReLU_{i}")(x, mesh)
        return x

    def forward(self, x: torch.Tensor, mesh=None, x0: int = 0,
                width: int | None = None):
        empty = x.shape[-1] == 0
        x = self._convs(x, 0, 5, mesh)
        up1 = self.DeconvBNReLU_0(x, mesh)
        x = self._convs(x, 5, 11, mesh)
        up2 = self.DeconvBNReLU_1(x, mesh)
        x = self._convs(x, 11, 17, mesh)
        up3 = self.DeconvBNReLU_2(x, mesh)
        feats = torch.cat([up3, up2, up1], dim=1)
        cls = apply_conv(self.prob_conv, feats, empty=empty)
        reg = apply_conv(self.reg_conv, feats, empty=empty)
        if mesh is not None:
            # one gather of both heads' channels, at the BEV map's
            # columns / block1_stride
            s = self.block1_stride
            cls, reg = gather_w(torch.cat([cls, reg], dim=1), x0 // s,
                                width // s, mesh.model_group).split(
                                    [cls.shape[1], reg.shape[1]], dim=1)
        return (cls.permute(0, 2, 3, 1).float(),
                reg.permute(0, 2, 3, 1).float())
