"""Plain float32 VoxelNet (arXiv:1711.06396 §2), written from the
configuration file's numbers alone: voxelization, the two VFE layers,
the dense scatter, the three Conv3D middle blocks, the RPN and its heads.

It imports nothing of the measured program. Parameters come as a dict
of tensors under the names of `param_specs` (the names the program's
state dict uses); running statistics are read, and in train mode moved,
in that dict. Batch-norm follows the configuration's training
semantics: statistics in float32 over the batch, the biased variance
E[x^2] - E[x]^2, eps 1e-5, running statistics moved as 0.9 old + 0.1
batch; the VFE's statistics and maxima cover the stored points only.

`quant`, where given, rounds the input and the weight of every linear
layer and convolution before the product (the control's lower
precision, see `fp8`); the product itself accumulates in float32.
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict

import numpy as np
import torch
from torch.nn import functional as F

EPS = 1e-5
MOMENTUM = 0.9
# (cout, depth stride, depth pad) of the three middle blocks
MIDDLE = ((64, 2, 1), (64, 1, 0), (64, 2, 1))
NEG = -1e9


def grid_dzyx(obj: dict) -> tuple[int, int, int]:
    return (int(round((obj["z_max"] - obj["z_min"]) / obj["z_voxel_size"])),
            int(round((obj["y_max"] - obj["y_min"]) / obj["y_voxel_size"])),
            int(round((obj["x_max"] - obj["x_min"]) / obj["x_voxel_size"])))


def middle_depths(depth: int) -> list[int]:
    """The depth after each middle block."""
    out = []
    for _, stride, pad in MIDDLE:
        depth = (depth + 2 * pad - 3) // stride + 1
        out.append(depth)
    return out


def rpn_convs(cin: int, block1_stride: int) -> list[tuple[int, int, int]]:
    """(cin, cout, stride) of the RPN's 17 3x3 convolutions."""
    return ([(cin, 128, block1_stride)] + [(128, 128, 1)] * 4
            + [(128, 128, 2)] + [(128, 128, 1)] * 5
            + [(128, 256, 2)] + [(256, 256, 1)] * 5)


# the RPN's three transposed convolutions: (cin, cout, kernel, stride)
DECONVS = ((128, 256, 3, 1), (128, 256, 2, 2), (256, 256, 4, 4))


def param_specs(cfg: dict) -> "OrderedDict[str, tuple]":
    """name -> (shape, kind, fan_in), kind one of 'weight', 'bias',
    'bn_weight', 'bn_bias', 'bn_mean', 'bn_var', 'bn_count'. fan_in is
    the number of inputs one output sums (a transposed convolution's per
    output pixel)."""
    specs: OrderedDict = OrderedDict()

    def bn(prefix, n):
        for key, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                          ("running_mean", "bn_mean"),
                          ("running_var", "bn_var"),
                          ("num_batches_tracked", "bn_count")):
            specs[f"{prefix}.{key}"] = ((n,) if kind != "bn_count" else (),
                                        kind, n)

    def layer(prefix, wshape, fan, nout):
        specs[f"{prefix}.weight"] = (wshape, "weight", fan)
        specs[f"{prefix}.bias"] = ((nout,), "bias", fan)

    for name, cin, cout in (("vfe1", 7, 16), ("vfe2", 32, 64)):
        layer(f"feature_net.{name}.fcn", (cout, cin), cin, cout)
        bn(f"feature_net.{name}.bn", cout)
    cin = 128
    for i, (cout, _, _) in enumerate(MIDDLE):
        p = f"middle.ConvBlock3D_{i}"
        layer(f"{p}.Conv_0", (cout, cin, 3, 3, 3), cin * 27, cout)
        bn(f"{p}.BatchNorm_0", cout)
        cin = cout
    depth = middle_depths(grid_dzyx(cfg["object"])[0])[-1]
    for i, (ci, co, _) in enumerate(rpn_convs(64 * depth,
                                              cfg["rpn"]["block1_stride"])):
        p = f"rpn.ConvBNReLU_{i}"
        layer(f"{p}.Conv_0", (co, ci, 3, 3), ci * 9, co)
        bn(f"{p}.BatchNorm_0", co)
    for i, (ci, co, k, s) in enumerate(DECONVS):
        p = f"rpn.DeconvBNReLU_{i}"
        layer(f"{p}.ConvTranspose_0", (ci, co, k, k), ci * (k // s) ** 2, co)
        bn(f"{p}.BatchNorm_0", co)
    layer("rpn.prob_conv", (2, 768, 1, 1), 768, 2)
    layer("rpn.reg_conv", (14, 768, 1, 1), 768, 14)
    return specs


# ---------------------------------------------------------------- voxels

def voxelize_frame(points: np.ndarray, cfg: dict, max_voxels: int):
    """One frame's points (N, 4) -> (features (K, T, 7) f32, coords (K, 3)
    i32 zyx, counts (K,) i32), K = max_voxels, live voxels first in
    ascending (z*H + y)*W + x, then zero padding. Binning is floor((p -
    min) / size) in float32; each voxel keeps its first T points in the
    order given; above max_voxels the lowest ids are kept. Features are
    x, y, z, r and the offsets from the centroid of the stored points."""
    obj = cfg["object"]
    D, H, W = grid_dzyx(obj)
    T = obj["points_per_voxel"]
    pts = np.asarray(points, np.float32).reshape(-1, 4)
    f32 = np.float32
    vx = np.floor((pts[:, 0] + f32(-obj["x_min"])) / f32(obj["x_voxel_size"]))
    vy = np.floor((pts[:, 1] + f32(-obj["y_min"])) / f32(obj["y_voxel_size"]))
    vz = np.floor((pts[:, 2] + f32(-obj["z_min"])) / f32(obj["z_voxel_size"]))
    inside = ((vz >= 0) & (vz < D) & (vy >= 0) & (vy < H) & (vx >= 0)
              & (vx < W))
    pts = pts[inside]
    ids = ((vz[inside].astype(np.int64) * H + vy[inside].astype(np.int64))
           * W + vx[inside].astype(np.int64))
    order = np.argsort(ids, kind="stable")
    ids, pts = ids[order], pts[order]
    uniq, start, n = np.unique(ids, return_index=True, return_counts=True)
    k = min(len(uniq), max_voxels)
    feats = np.zeros((max_voxels, T, 7), np.float32)
    counts = np.zeros((max_voxels,), np.int32)
    coords = np.zeros((max_voxels, 3), np.int32)
    counts[:k] = np.minimum(n[:k], T)
    slot = np.arange(len(ids)) - np.repeat(start, n)
    rank = np.repeat(np.arange(len(uniq)), n)
    keep = (slot < T) & (rank < k)
    feats[rank[keep], slot[keep], :4] = pts[keep]
    cnt = np.maximum(counts[:k], 1).astype(np.float32)[:, None, None]
    centroid = feats[:k, :, :3].sum(axis=1, keepdims=True) / cnt
    mask = (np.arange(T)[None, :] < counts[:k, None])[..., None]
    feats[:k, :, 4:] = (feats[:k, :, :3] - centroid) * mask
    u = uniq[:k]
    coords[:k] = np.stack([u // (H * W), (u // W) % H, u % W], axis=1)
    return feats, coords, counts


def voxelize(points: np.ndarray, num_points: np.ndarray, cfg: dict):
    """(B, N, 4) padded points and (B,) counts -> stacked voxelize_frame
    outputs as numpy arrays."""
    max_voxels = cfg["data"]["max_voxels"]
    out = [voxelize_frame(points[b, : int(num_points[b])], cfg, max_voxels)
           for b in range(len(points))]
    return tuple(np.stack(parts) for parts in zip(*out))


# ---------------------------------------------------------------- layers

def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in x's type (a diagnostic)."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


def _to_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 `dtype` with one scale for the tensor (its
    largest magnitude onto `top`), back in x's type."""
    amax = x.abs().amax().clamp(min=1e-12)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8(torch.autograd.Function):
    """Forward: e4m3. Backward: the gradient that flows back through the
    rounded tensor rounded to e5m2 (the split of float8 training: e4m3
    for values, e5m2 for gradients)."""

    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor; in a
    backward pass the gradient into it rounded to e5m2 (the control's
    precision: a linear layer's or convolution's inputs, weights and the
    gradients of both in float8, products accumulated in float32)."""
    return _FP8.apply(x)


class BN:
    """The batch-norm of one layer over the params dict: 'eval' normalises
    with the running statistics; 'train' with the batch's, and moves the
    running ones; 'calibrate' sets the running statistics from the
    batch's (the mean times U(0.25, 0.75), the second moment times
    U(0.8, 1.25) and at least a tenth of the layer's mean one, drawn from
    `noise`, a torch.Generator), then normalises with them."""

    def __init__(self, params: dict, mode: str, noise=None):
        self.p, self.mode, self.noise = params, mode, noise

    def __call__(self, prefix: str, x: torch.Tensor, channel_dim: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
        p = self.p
        dim = channel_dim % x.dim()
        axes = [d for d in range(x.dim()) if d != dim]
        shape = [1] * x.dim()
        shape[dim] = -1
        rm, rv = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
        if self.mode == "eval":
            mean, var = rm, rv
        else:
            if mask is None:
                mean = x.mean(axes)
                mean2 = (x * x).mean(axes)
            else:
                m = torch.broadcast_to(mask, x.shape).to(x.dtype)
                n = m.sum(axes)
                mean = (x * m).sum(axes) / n
                mean2 = (x * x * m).sum(axes) / n
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                if self.mode == "train":
                    rm.copy_(MOMENTUM * rm + (1 - MOMENTUM) * mean)
                    rv.copy_(MOMENTUM * rv + (1 - MOMENTUM) * var)
                else:
                    # a share of the mean and the second moment: the
                    # grid's empty cells make many channels nearly
                    # constant, and their own mean and variance would
                    # make the layer subtract two near-equal numbers
                    g = self.noise
                    u = torch.rand((2,) + tuple(mean.shape), generator=g,
                                   device=g.device).to(rm)
                    rm.copy_(mean * (0.25 + 0.5 * u[0]))
                    # no channel scaled up by more than a few times the
                    # layer's typical one: a channel all but silent in
                    # this batch may not be in the next
                    rv.copy_(torch.maximum(mean2 * (0.8 + 0.45 * u[1]),
                                           0.1 * mean2.mean()))
                    mean, var = rm, rv
        scale = p[f"{prefix}.weight"] * torch.rsqrt(var + EPS)
        return ((x - mean.view(shape)) * scale.view(shape)
                + p[f"{prefix}.bias"].view(shape))


class Net:
    """The forward pass over a params dict (see module docstring)."""

    def __init__(self, cfg: dict, params: dict, bn_mode: str = "eval",
                 quant=None, noise=None):
        self.cfg, self.p = cfg, params
        self.bn = BN(params, bn_mode, noise)
        self.q = quant or (lambda t: t)
        obj = cfg["object"]
        self.grid = grid_dzyx(obj)
        self.T = obj["points_per_voxel"]
        self.stride1 = cfg["rpn"]["block1_stride"]

    def _w(self, name):
        return self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"]

    def vfe(self, feats: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        """(B, K, T, 7), (B, K) -> voxelwise features (B, K, 128)."""
        T = feats.shape[2]
        mask = (torch.arange(T, device=feats.device)
                < counts[..., None])[..., None]
        x = feats
        for name in ("vfe1", "vfe2"):
            w, b = self._w(f"feature_net.{name}.fcn")
            y = torch.relu(F.linear(self.q(x), w, b))
            y = self.bn(f"feature_net.{name}.bn", y, -1, mask)
            agg = torch.where(mask, y, NEG).amax(dim=2, keepdim=True)
            x = torch.cat([y, agg.expand_as(y)], dim=-1) * mask
        out = torch.where(mask, x, NEG).amax(dim=2)
        return out * (counts > 0)[..., None]

    def scatter(self, vw, coords, counts) -> torch.Tensor:
        """-> the dense grid (B, 128, D, H, W), zero where no voxel is."""
        B, K, C = vw.shape
        D, H, W = self.grid
        live = counts > 0
        b = torch.arange(B, device=vw.device)[:, None].expand(B, K)[live]
        c = coords[live].long()
        dense = vw.new_zeros((B, D, H, W, C))
        dense = dense.index_put((b, c[:, 0], c[:, 1], c[:, 2]), vw[live])
        return dense.permute(0, 4, 1, 2, 3)

    def middle(self, x: torch.Tensor) -> torch.Tensor:
        for i, (_, stride, pad) in enumerate(MIDDLE):
            pre = f"middle.ConvBlock3D_{i}"
            w, b = self._w(f"{pre}.Conv_0")
            x = F.conv3d(self.q(x), w, b, (stride, 1, 1), (pad, 1, 1))
            x = torch.relu(self.bn(f"{pre}.BatchNorm_0", x, 1))
        B, C, Dd, H, W = x.shape
        # the depth fold, channel-major: bev channel = c * D' + d
        return x.reshape(B, C * Dd, H, W)

    def rpn(self, x: torch.Tensor):
        convs = rpn_convs(x.shape[1], self.stride1)
        ups = []
        for i, (_, _, stride) in enumerate(convs):
            pre = f"rpn.ConvBNReLU_{i}"
            w, b = self._w(f"{pre}.Conv_0")
            x = F.conv2d(self.q(x), w, b, stride, 1)
            x = torch.relu(self.bn(f"{pre}.BatchNorm_0", x, 1))
            if i in (4, 10, 16):
                j = (4, 10, 16).index(i)
                _, _, k, s = DECONVS[j]
                dpre = f"rpn.DeconvBNReLU_{j}"
                w, b = self._w(f"{dpre}.ConvTranspose_0")
                u = F.conv_transpose2d(self.q(x), w, b, s, 1 if s == 1 else 0)
                ups.append(torch.relu(self.bn(f"{dpre}.BatchNorm_0", u, 1)))
        feats = self.q(torch.cat(ups[::-1], dim=1))
        w, b = self._w("rpn.prob_conv")
        cls = F.conv2d(feats, w, b)
        w, b = self._w("rpn.reg_conv")
        reg = F.conv2d(feats, w, b)
        return cls.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1)

    def __call__(self, feats, coords, counts):
        """Voxel table -> (cls logits (B, H', W', 2), reg (B, H', W', 14))."""
        vw = self.vfe(feats, counts)
        return self.rpn(self.middle(self.scatter(vw, coords, counts)))


@contextlib.contextmanager
def full_f32():
    """float32 products in float32, not TF32, on the card, for the
    reference's computations; the settings restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def maps(cfg: dict, params: dict, points: np.ndarray,
         num_points: np.ndarray, device, bn_mode: str = "eval", quant=None,
         noise=None):
    """Padded points (B, N, 4) -> the float32 maps, frame by frame (one
    frame's dense grid at a time, so that the reference fits beside what
    the card already holds)."""
    feats, coords, counts = voxelize(points, num_points, cfg)
    net = Net(cfg, params, bn_mode, quant, noise)
    if bn_mode != "eval":
        with full_f32():
            return net(*(torch.from_numpy(a).to(device)
                         for a in (feats, coords, counts)))
    cls, reg = [], []
    with torch.no_grad(), full_f32():
        for b in range(len(points)):
            c, r = net(*(torch.from_numpy(a[b:b + 1]).to(device)
                         for a in (feats, coords, counts)))
            cls.append(c)
            reg.append(r)
    return torch.cat(cls), torch.cat(reg)


def fan_scale(fan: int) -> float:
    """The bound of a uniform draw with the variance 2 / fan (He)."""
    return math.sqrt(6.0 / fan)
