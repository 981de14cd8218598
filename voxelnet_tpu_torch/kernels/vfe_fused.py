"""Fused voxel table + VFE stack (inference): sorted point stream ->
voxelwise features (B, K, 128) bf16.

Counterpart of `voxelnet_tpu/kernels/vfe_fused.py`. `vfe_fused` launches
the CUDA kernel `csrc/vfe_fused.cu` for CUDA tensors and runs
`vfe_fused_plain`, the same function in plain torch, for CPU tensors; there
is no fallback from one to the other. `fold_layer` folds a VFE layer's
eval-mode BatchNorm into the per-channel affine both take.
"""

from __future__ import annotations

import ctypes

import torch

from voxelnet_tpu_torch.kernels import _build

MAX_POINTS_PER_VOXEL = 127  # as the TPU kernel (a voxel's run fits 128 lanes)
BN_EPS = 1e-5

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = {"vfe_fused_launch": [_P] * 9 + [ctypes.c_int] * 4 + [_P],
             "vfe_fused_info": [_P]}


def fold_layer(fcn: torch.nn.Linear, bn: torch.nn.BatchNorm1d,
               cin_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One VFE layer -> (w (cout, cin_pad) f32 zero-padded, a (cout, 3) f32
    columns: dense bias, BN scale, BN shift) from the running stats."""
    w = fcn.weight.detach().to(torch.float32)
    w = torch.nn.functional.pad(w, (0, cin_pad - w.shape[1]))
    scale = bn.weight.detach() / torch.sqrt(bn.running_var + BN_EPS)
    shift = bn.bias.detach() - bn.running_mean * scale
    a = torch.stack([fcn.bias.detach(), scale, shift], dim=1)
    return w.contiguous(), a.to(torch.float32).contiguous()


def vfe_fused_plain(planar, run_start, num_voxels, counts, w1, a1, w2, a2,
                    points_per_voxel: int) -> torch.Tensor:
    """Plain torch version of the kernel, same rounding points: dot inputs
    in bf16 with f32 accumulation, relu(y + b), y * scale + shift, bf16,
    max over the points t < count, output [agg2, agg2] * (count > 0)."""
    B, _, N = planar.shape
    K = run_start.shape[1]
    T = points_per_voxel
    t = torch.arange(T, device=planar.device)
    idx = torch.clamp(run_start.long()[..., None] + t, max=N - 1)
    tab = torch.gather(planar, 2, idx.reshape(B, 1, K * T).expand(B, 4, K * T))
    tab = tab.reshape(B, 4, K, T).permute(0, 2, 3, 1)          # (B, K, T, 4)
    mask = (t < counts[..., None]) & (
        torch.arange(K, device=planar.device) < num_voxels[:, None])[..., None]
    maskf = mask[..., None].to(torch.float32)
    tab = tab * maskf
    denom = torch.clamp(counts.to(torch.float32), min=1.0)[..., None, None]
    centroid = tab[..., :3].sum(dim=2, keepdim=True) / denom
    offs = (tab[..., :3] - centroid) * maskf
    feat = torch.cat([tab, offs, torch.zeros_like(offs[..., :1])], dim=-1)

    def layer(x, w, a):
        bf = torch.bfloat16
        y = x.to(bf).to(torch.float32) @ w.to(bf).to(torch.float32).T
        y = torch.relu(y + a[:, 0])
        y = (y * a[:, 1] + a[:, 2]).to(bf).to(torch.float32)
        agg = torch.where(mask[..., None], y, -1e9).amax(dim=2, keepdim=True)
        return y, agg

    y1, agg1 = layer(feat, w1, a1)
    x2 = torch.cat([y1, agg1.expand_as(y1)], dim=-1) * maskf
    _, agg2 = layer(x2, w2, a2)
    occupied = (counts > 0)[..., None].to(torch.float32)
    return (torch.cat([agg2, agg2], dim=-1)[:, :, 0] * occupied).to(
        torch.bfloat16)


def vfe_fused(planar: torch.Tensor, run_start: torch.Tensor,
              num_voxels: torch.Tensor, counts: torch.Tensor,
              w1: torch.Tensor, a1: torch.Tensor, w2: torch.Tensor,
              a2: torch.Tensor, points_per_voxel: int) -> torch.Tensor:
    """planar (B, 4, N) f32 sorted points, run_start (B, K) i32,
    num_voxels (B,) i32, counts (B, K) i32 (<= points_per_voxel), folded
    w1 (16, 8), a1 (16, 3), w2 (64, 32), a2 (64, 3) f32 ->
    (B, K, 128) bf16."""
    args = (planar, run_start, num_voxels, counts, w1, a1, w2, a2)
    if _build.on_cpu(planar):
        return vfe_fused_plain(*args, points_per_voxel)
    index = _build.require_cuda("vfe_fused", *args)
    B, _, N = planar.shape
    K = run_start.shape[1]
    _build.require_shapes("vfe_fused",
                          ("planar", planar, torch.float32, (B, 4, N)),
                          ("run_start", run_start, torch.int32, (B, K)),
                          ("num_voxels", num_voxels, torch.int32, (B,)),
                          ("counts", counts, torch.int32, (B, K)),
                          ("w1", w1, torch.float32, (16, 8)),
                          ("a1", a1, torch.float32, (16, 3)),
                          ("w2", w2, torch.float32, (64, 32)),
                          ("a2", a2, torch.float32, (64, 3)))
    if not 0 < points_per_voxel <= MAX_POINTS_PER_VOXEL or N >= 2 ** 31:
        raise ValueError(f"vfe_fused: points_per_voxel {points_per_voxel} "
                         f"must be in [1, {MAX_POINTS_PER_VOXEL}] and "
                         f"N={N} < 2**31")
    out = torch.empty((B, K, 128), dtype=torch.bfloat16, device=planar.device)
    lib = _build.load("vfe_fused", _ARGTYPES)
    err = lib.vfe_fused_launch(*(t.data_ptr() for t in args), out.data_ptr(),
                               B, N, K, points_per_voxel,
                               _build.stream(index))
    _build.check(err, "vfe_fused")
    global launches
    launches += 1
    return out


def kernel_info() -> dict:
    """`_build.kernel_info` of the fused kernel."""
    return _build.kernel_info(_build.load("vfe_fused", _ARGTYPES),
                              "vfe_fused_info")
