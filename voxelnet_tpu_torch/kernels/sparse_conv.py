"""Sparse 3x3x3 convolution of the voxel table (middle block 1 under
`data.middle_backend='sparse1'`): the per-offset products summed into the
output grid, and its gradient.

Counterpart of the XLA scatter-adds of
`voxelnet_tpu/models/sparse_conv.py::sparse_conv3x3` (:92-112) and of the
gather that JAX's autodiff makes of them; the JAX package has no Pallas
kernel here. The product `vals` (B, K, 27, Cout), offset-major with
o = (kd * 3 + ky) * 3 + kx, comes from a torch matmul before this
(models/sparse_conv.py).

`occupancy_map` (the lookup the output-stationary sum needs; JAX scatters
instead) launches `csrc/sparse_conv.cu`'s occupancy kernel for CUDA tensors
and runs `occupancy_map_plain` for CPU tensors; both take the voxelizers'
order of the table's live rows (strictly ascending cell ids) and refuse
another. `sparse_conv` launches its output-stationary kernel for CUDA
tensors and runs `sparse_conv_plain`, JAX's algorithm (an f32 zero
buffer, 27 `index_add_` in offset order, + bias, a cast), for CPU tensors;
the kernel is bit-equal to it, and both take an optional ReLU after the
cast (`relu=True`). `sparse_conv_grad`
launches the gather kernel or runs `sparse_conv_grad_plain`. There is no
fallback from one to the other. `sparse_conv_autograd` puts them together
with the bias gradient.
"""

from __future__ import annotations

import ctypes

import torch

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.kernels import _build

# (kd, ky, kx) in the order of the offset axis of `vals`
OFFSETS = tuple((kd, ky, kx) for kd in range(3) for ky in range(3)
                for kx in range(3))

# kernel launches since the last reset (chip_smoke.py reads them): the
# forward, the gradient's gather and the occupancy map
launches = 0
grad_launches = 0
occupancy_launches = 0

_THREADS = 256   # csrc/sparse_conv.cu kThreads: 16-byte chunks of a row
_TILE = (8, 32)  # its kTileY x kTileX output sites a tile
_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = [_P] * 5 + [_I] * 12 + [_P]
_ARGTYPES = {"sparse_conv_fwd_launch": _FWD,
             "sparse_conv_fwd_f32_launch": _FWD,
             "sparse_conv_fwd_info": [_P, _I],
             "sparse_conv_grad_launch": [_P] * 4 + [_I] * 9 + [_P],
             "occupancy_map_launch": [_P] * 3 + [_I] * 5 + [_P]}
_FWD_LAUNCHERS = {torch.bfloat16: "sparse_conv_fwd_launch",
                  torch.float32: "sparse_conv_fwd_f32_launch"}


def depth_out(depth: int, stride_d: int, pad_d: int) -> int:
    return (depth + 2 * pad_d - 3) // stride_d + 1


def occupancy_map_plain(coords: torch.Tensor, counts: torch.Tensor,
                        grid_dzyx: tuple[int, int, int]) -> torch.Tensor:
    """(B, K, 3) zyx coords + (B, K) counts -> (B, D, H, W) int32: the row k
    of the voxel at each site, -1 where the site is empty. Padding rows
    (count 0) carry arbitrary coords and write only a spare cell past the
    grid, which is cut off. Raises ValueError on a live row outside the
    grid, then on a frame out of the voxelizers' order that the kernel
    needs: live rows first, at cell ids (z * H + y) * W + x that ascend
    strictly (a duplicate, a swap or a live row after a padding row
    raises)."""
    B, K = counts.shape
    D, H, W = grid_dzyx
    n = D * H * W
    c = coords.long()
    live = counts > 0
    outside = ((c < 0) | (c >= c.new_tensor(grid_dzyx))).any(-1)
    if tracing.wait(tracing.current, (outside & live).any()):
        raise ValueError(f"occupancy_map: a live voxel lies outside the grid "
                         f"{tuple(grid_dzyx)}")
    lin = (c[..., 0] * H + c[..., 1]) * W + c[..., 2]
    # the largest live id before each row: a live id must exceed it
    before = torch.where(live, lin, -1).cummax(1).values
    before = torch.cat([before.new_full((B, 1), -1), before[:, :-1]], 1)
    if (tracing.wait(tracing.current, (live & (lin <= before)).any())
            or tracing.wait(tracing.current,
                            (live[:, 1:] & ~live[:, :-1]).any())):
        raise ValueError("occupancy_map: the live voxels of a frame must "
                         "lead its padding rows, at strictly ascending cell "
                         "ids (z * H + y) * W + x")
    base = torch.arange(B, device=counts.device)[:, None] * n
    target = torch.where(live, base + lin, B * n)
    occ = torch.full((B * n + 1,), -1, dtype=torch.int32,
                     device=counts.device)
    rows = torch.arange(K, dtype=torch.int32, device=counts.device)
    occ.index_put_((target.reshape(-1),), rows.expand(B, K).reshape(-1))
    return occ[: B * n].view(B, D, H, W)


# the occupancy kernel's launcher, looked up once
_occupancy_launch = None


def _bind_occupancy():
    global _occupancy_launch
    _occupancy_launch = _build.load("sparse_conv",
                                    _ARGTYPES).occupancy_map_launch
    return _occupancy_launch


def occupancy_map(coords: torch.Tensor, counts: torch.Tensor,
                  grid_dzyx: tuple[int, int, int]) -> torch.Tensor:
    """`occupancy_map_plain`'s map; for CUDA tensors (int32 coords and
    counts) one kernel launch that writes every cell of the (B, D, H, W)
    map once. It takes the voxelizers' order: per frame the live rows'
    cell ids ascend strictly and padding rows trail. A live row outside
    the grid or out of that order (a live row after a padding row too)
    traps the kernel, which the next synchronisation raises as a CUDA
    error (the plain version raises ValueError on the same tables)."""
    if _build.on_cpu(coords):
        return occupancy_map_plain(coords, counts, grid_dzyx)
    index = _build.require_cuda("occupancy_map", coords, counts)
    B, K = counts.shape
    D, H, W = grid_dzyx
    _build.require_shapes("occupancy_map",
                          ("coords", coords, torch.int32, (B, K, 3)),
                          ("counts", counts, torch.int32, (B, K)))
    if not (0 < B < 65536 and K > 0 and 0 < D * H * W < 2 ** 31):
        raise ValueError(f"occupancy_map: need 1 <= B < 65536, K >= 1 and "
                         f"a grid of 1 to 2**31 - 1 cells (B={B}, K={K}, "
                         f"grid={grid_dzyx})")
    occ = counts.new_empty((B, D, H, W))
    err = (_occupancy_launch or _bind_occupancy())(
        coords.data_ptr(), counts.data_ptr(), occ.data_ptr(), B, K, D, H, W,
        _build.stream(index))
    _build.check(err, "occupancy_map")
    global occupancy_launches
    occupancy_launches += 1
    return occ


def tap_sites(coords: torch.Tensor, counts: torch.Tensor, stride_d: int,
              pad_d: int, out_dhw: tuple[int, int, int],
              x0: int = 0) -> torch.Tensor:
    """(B, K, 27) int64: the site b * n + (oz * H + oy) * wloc + ox of the
    (B, Do, H, wloc) output (n = Do * H * wloc) that row k reaches through
    offset o, or B * n, one past the last site, where the tap misses
    (depth-stride parity, bounds, the x window) or k is padding
    (`sparse_conv.py:95-105`)."""
    do, h, wloc = out_dhw
    B = counts.shape[0]
    n = do * h * wloc
    z, y, x = coords.long().unbind(-1)
    base = torch.arange(B, device=counts.device)[:, None] * n
    live = counts > 0
    sites = []
    for kd, ky, kx in OFFSETS:
        num = z + pad_d - kd
        oz = torch.div(num, stride_d, rounding_mode="floor")
        oy = y + 1 - ky
        ox = x + 1 - kx - x0
        ok = (live & (num % stride_d == 0) & (oz >= 0) & (oz < do)
              & (oy >= 0) & (oy < h) & (ox >= 0) & (ox < wloc))
        sites.append(torch.where(ok, base + (oz * h + oy) * wloc + ox,
                                 B * n))
    return torch.stack(sites, dim=2)


def _window(w_window, width):
    return (0, width) if w_window is None else tuple(w_window)


def sparse_conv_plain(vals: torch.Tensor, coords: torch.Tensor,
                      counts: torch.Tensor, bias: torch.Tensor,
                      grid_dzyx: tuple[int, int, int], stride_d: int,
                      pad_d: int, w_window=None,
                      relu: bool = False) -> torch.Tensor:
    """Plain torch version, JAX's algorithm: a zero buffer in the bias's
    type, per offset in order one `index_add_` of the rows at their
    `tap_sites` (a spare row past the sites takes the misses), + bias,
    cast to vals' type; then a ReLU where `relu`."""
    D, H, W = grid_dzyx
    B, K, _, cout = vals.shape
    x0, wloc = _window(w_window, W)
    do = depth_out(D, stride_d, pad_d)
    n = do * H * wloc
    sites = tap_sites(coords, counts, stride_d, pad_d, (do, H, wloc), x0)
    out = torch.zeros((B * n + 1, cout), dtype=bias.dtype, device=vals.device)
    for o in range(27):
        out.index_add_(0, sites[:, :, o].reshape(-1),
                       vals[:, :, o].reshape(-1, cout).to(bias.dtype))
    out = (out[: B * n] + bias).view(B, do, H, wloc, cout).to(vals.dtype)
    return torch.relu(out) if relu else out


def sparse_conv(vals: torch.Tensor, coords: torch.Tensor,
                counts: torch.Tensor, occ: torch.Tensor, bias: torch.Tensor,
                stride_d: int, pad_d: int, w_window=None,
                relu: bool = False) -> torch.Tensor:
    """vals (B, K, 27, Cout), coords (B, K, 3) / counts (B, K) int32, occ
    their `occupancy_map` (B, D, H, W), bias (Cout,) -> the conv's output
    (B, Do, H, wloc, Cout) in vals' type, output columns [x0, x0 + wloc)
    under w_window=(x0, wloc), ReLU'd after the cast where `relu`. The
    kernel reads occ and takes bf16 or f32 vals with an f32 bias and Cout a
    multiple of 8 (bf16) / 4 (f32) whose 16-byte chunks divide 256."""
    if _build.on_cpu(vals):
        return sparse_conv_plain(vals, coords, counts, bias,
                                 tuple(occ.shape[1:]), stride_d, pad_d,
                                 w_window, relu)
    index = _build.require_cuda("sparse_conv", vals, coords, counts, occ,
                                bias)
    if vals.dtype not in _FWD_LAUNCHERS:
        raise ValueError(f"sparse_conv: vals must be torch.bfloat16 or "
                         f"torch.float32, got {vals.dtype}")
    B, K, _, cout = vals.shape
    D, H, W = occ.shape[1:]
    x0, wloc = _window(w_window, W)
    do = depth_out(D, stride_d, pad_d)
    _build.require_shapes("sparse_conv",
                          ("vals", vals, vals.dtype, (B, K, 27, cout)),
                          ("coords", coords, torch.int32, (B, K, 3)),
                          ("counts", counts, torch.int32, (B, K)),
                          ("occ", occ, torch.int32, (B, D, H, W)),
                          ("bias", bias, torch.float32, (cout,)))
    chunks = cout * vals.element_size() // 16
    tiles = B * do * -(-H // _TILE[0]) * -(-wloc // _TILE[1])
    if (cout * vals.element_size() % 16 or _THREADS % chunks or K < 1
            or do < 1 or wloc < 1 or not 0 < tiles < 2 ** 31):
        raise ValueError(
            f"sparse_conv: need Cout's 16-byte chunks to divide {_THREADS}, "
            f"K >= 1, Do >= 1, wloc >= 1 and fewer than 2**31 tiles of "
            f"{_TILE[0]}x{_TILE[1]} sites (B={B}, K={K}, Cout={cout}, "
            f"grid={(D, H, W)}, Do={do}, wloc={wloc})")
    out = torch.empty((B, do, H, wloc, cout), dtype=vals.dtype,
                      device=vals.device)
    # the kernel's tile counter, zeroed by its launcher
    counter = torch.empty((1,), dtype=torch.int32, device=vals.device)
    lib = _build.load("sparse_conv", _ARGTYPES)
    err = getattr(lib, _FWD_LAUNCHERS[vals.dtype])(
        vals.data_ptr(), occ.data_ptr(), bias.data_ptr(), out.data_ptr(),
        counter.data_ptr(), B, K, D, H, W, do, stride_d, pad_d, x0, wloc,
        cout, int(relu), _build.stream(index))
    _build.check(err, "sparse_conv")
    global launches
    launches += 1
    return out


def kernel_info(dtype: torch.dtype = torch.bfloat16) -> dict:
    """`_build.kernel_info` of the forward kernel for bf16 or f32 vals."""
    return _build.kernel_info(_build.load("sparse_conv", _ARGTYPES),
                              "sparse_conv_fwd_info",
                              int(dtype == torch.float32))


def sparse_conv_grad_plain(dout: torch.Tensor, coords: torch.Tensor,
                           counts: torch.Tensor, stride_d: int, pad_d: int,
                           x0: int = 0) -> torch.Tensor:
    """Plain torch version of the gradient: the rows of dout, with a zero
    row appended, at the `tap_sites`."""
    B, do, H, wloc, cout = dout.shape
    sites = tap_sites(coords, counts, stride_d, pad_d, (do, H, wloc), x0)
    flat = torch.cat([dout.reshape(-1, cout), dout.new_zeros((1, cout))])
    return flat.index_select(0, sites.reshape(-1)).view(B, -1, 27, cout)


def sparse_conv_grad(dout: torch.Tensor, coords: torch.Tensor,
                     counts: torch.Tensor, stride_d: int, pad_d: int,
                     x0: int = 0) -> torch.Tensor:
    """d(sparse_conv)/d(vals): dout (B, Do, H, wloc, Cout) -> dvals
    (B, K, 27, Cout) in dout's type: dvals[b, k, o] is dout at the site
    that row k reaches through offset o, 0 where it misses or k is
    padding. The kernel takes rows of a multiple of 16 bytes."""
    if _build.on_cpu(dout):
        return sparse_conv_grad_plain(dout, coords, counts, stride_d, pad_d,
                                      x0)
    index = _build.require_cuda("sparse_conv_grad", dout, coords, counts)
    B, do, H, wloc, cout = dout.shape
    K = counts.shape[1]
    _build.require_shapes("sparse_conv_grad",
                          ("coords", coords, torch.int32, (B, K, 3)),
                          ("counts", counts, torch.int32, (B, K)))
    row_bytes = cout * dout.element_size()
    if row_bytes % 16 or K < 1:
        raise ValueError(
            f"sparse_conv_grad: need rows of a multiple of 16 bytes and "
            f"K >= 1 (K={K}, Cout={cout}, {dout.dtype})")
    dvals = torch.empty((B, K, 27, cout), dtype=dout.dtype,
                        device=dout.device)
    lib = _build.load("sparse_conv", _ARGTYPES)
    err = lib.sparse_conv_grad_launch(
        dout.data_ptr(), coords.data_ptr(), counts.data_ptr(),
        dvals.data_ptr(), B, K, do, H, wloc, stride_d, pad_d, x0,
        row_bytes // 16, _build.stream(index))
    _build.check(err, "sparse_conv_grad")
    global grad_launches
    grad_launches += 1
    return dvals


class _SparseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, coords, counts, occ, bias, stride_d, pad_d,
                w_window, relu):
        out = sparse_conv(vals, coords, counts, occ, bias, stride_d, pad_d,
                          w_window, relu)
        ctx.save_for_backward(coords, counts, out if relu else None)
        ctx.geometry = (stride_d, pad_d, _window(w_window, 0)[0])
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        coords, counts, out = ctx.saved_tensors
        if out is not None:
            # the ReLU's gradient, as torch's: dout where out > 0, else 0
            dout = torch.where(out > 0, dout, 0)
        dout = dout.contiguous()
        dvals = sparse_conv_grad(dout, coords, counts, *ctx.geometry)
        dbias = dout.sum((0, 1, 2, 3), dtype=ctx.bias_dtype)
        return dvals, None, None, None, dbias, None, None, None, None


def sparse_conv_autograd(vals, coords, counts, occ, bias, stride_d: int,
                         pad_d: int, w_window=None,
                         relu: bool = False) -> torch.Tensor:
    """`sparse_conv` with gradients with respect to vals (the gather) and
    bias (the output gradient summed over batch and sites, in the bias's
    type), through the ReLU where `relu`."""
    return _SparseConv.apply(vals, coords, counts, occ, bias, stride_d,
                             pad_d, w_window, relu)
