"""The port's CUDA kernels against their plain torch versions, the
inference path and the train step on the card against the CPU, train.remat
on the card, and the trainer's batch uploads. Every test
needs an NVIDIA GPU and skips without one. The card's machine has no JAX,
which tests/conftest.py imports, so run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, assert_bf16_close,  # noqa: F401
                                cuda_device, merged)

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.kernels import (dense_build, run_copy, sparse_conv,
                                        vfe_fused)
from voxelnet_tpu_torch.models.init import randomize_bn_
from voxelnet_tpu_torch.models.voxelnet import build_model, make_inference_fn
from voxelnet_tpu_torch.ops import voxelize

pytestmark = pytest.mark.cuda


def _model(cfg, seed=0):
    model = build_model(cfg, seed=seed)
    return randomize_bn_(model, torch.Generator().manual_seed(seed + 1))


def _points(cfg, seed):
    rng = np.random.default_rng(seed)
    obj = cfg.object
    n = cfg.data.max_points
    pts = np.zeros((2, n, 4), np.float32)
    pts[..., :3] = rng.uniform([obj.x_min, obj.y_min, obj.z_min],
                               [obj.x_max, obj.y_max, obj.z_max], (2, n, 3))
    pts[..., 3] = rng.uniform(0, 1, (2, n))
    # one voxel at T points in the lowest depth slice, which the voxel cap
    # keeps
    pts[1, :60, :3] = np.asarray([6.1, 0.1, -2.9]) + 0.01 * np.arange(
        60)[:, None] / 60
    return pts, np.asarray([n, n - 500], np.int32)


def test_vfe_kernel_matches_plain(cuda_device):
    cfg = get_config("Car", **TINY)
    fln = _model(cfg).to(cuda_device).feature_net
    spec = voxelize.VoxelGridSpec.from_object_config(cfg.object)
    pts, num = _points(cfg, 0)
    prep = voxelize.prepare(torch.from_numpy(pts).to(cuda_device),
                            torch.from_numpy(num).to(cuda_device), spec,
                            cfg.data.max_voxels)
    args = (prep.sorted_planar, prep.run_start, prep.num_voxels, prep.counts,
            *vfe_fused.fold_layer(fln.vfe1.fcn, fln.vfe1.bn, 8),
            *vfe_fused.fold_layer(fln.vfe2.fcn, fln.vfe2.bn, 32))
    before = vfe_fused.launches
    with torch.no_grad():
        got = vfe_fused.vfe_fused(*args, cfg.object.points_per_voxel)
        want = vfe_fused.vfe_fused_plain(*args, cfg.object.points_per_voxel)
    torch.cuda.synchronize()
    assert vfe_fused.launches == before + 1
    assert int(prep.counts.max()) > 32
    assert_bf16_close(got.cpu(), want.float().cpu().numpy())


def _runs(seed, K, T, nv, lengths):
    """Inputs of vfe_fused for frames with nv[b] occupied voxels whose runs
    of `lengths(rng, K)` points follow one another in the stream (runs
    longer than T are cut to T stored points), points scattered around one
    centre per voxel."""
    rng = np.random.default_rng(seed)
    B = len(nv)
    lens = [np.where(np.arange(K) < nv[b], lengths(rng, K), 0)
            for b in range(B)]
    N = int(max(ln.sum() for ln in lens)) + 7
    planar = np.zeros((B, 4, N), np.float32)
    run_start = np.full((B, K), N, np.int32)
    counts = np.zeros((B, K), np.int32)
    for b in range(B):
        starts = np.concatenate([[0], np.cumsum(lens[b])[:-1]])
        run_start[b, :nv[b]] = starts[:nv[b]]
        counts[b] = np.minimum(lens[b], T)
        owner = np.repeat(np.arange(K), lens[b])
        centre = rng.uniform([0, -40, -3], [70, 40, 1], (K, 3))
        planar[b, :3, :owner.size] = (centre[owner] + rng.normal(
            0, 0.1, (owner.size, 3))).T
        planar[b, 3, :owner.size] = rng.uniform(0, 1, owner.size)
    return (planar, run_start, np.asarray(nv, np.int32), counts)


@pytest.mark.parametrize("K,T,nv,lengths", [
    # num_voxels not a multiple of the 32-voxel tile, nor K
    (200, 35, (133, 200), lambda rng, K: rng.integers(1, 45, K)),
    # a frame with no voxel beside a partly filled one
    (70, 35, (0, 57), lambda rng, K: rng.integers(1, 45, K)),
    # every voxel of every tile holds exactly T points: chunks of 7 voxels
    (96, 35, (96,), lambda rng, K: np.full(K, 38)),
    # crowded at T=100: chunks of two or three voxels
    (64, 100, (64, 40), lambda rng, K: rng.integers(60, 160, K)),
    # the largest T: chunks of 2 voxels
    (40, 127, (40,), lambda rng, K: np.full(K, 127)),
], ids=["ragged", "empty-frame", "full-tiles", "crowded-T100", "T127"])
def test_vfe_kernel_tile_edges(cuda_device, K, T, nv, lengths):
    """The kernel against its plain version under chip_smoke.py's gate
    (>= 99.9% bit-equal, the rest within 2**-7), one launch."""
    fln = _model(get_config("Car", **TINY)).to(cuda_device).feature_net
    w2, a2 = vfe_fused.fold_layer(fln.vfe2.fcn, fln.vfe2.bn, 32)
    # half the VFE2 channels with a negative BN scale: there the kernel
    # keeps the least dot product of a voxel, not the greatest
    a2[::2, 1] *= -1
    args = (*(torch.from_numpy(a).to(cuda_device)
              for a in _runs(K + T, K, T, nv, lengths)),
            *vfe_fused.fold_layer(fln.vfe1.fcn, fln.vfe1.bn, 8), w2, a2)
    before = vfe_fused.launches
    with torch.no_grad():
        got = vfe_fused.vfe_fused(*args, T)
        want = vfe_fused.vfe_fused_plain(*args, T)
    torch.cuda.synchronize()
    assert vfe_fused.launches == before + 1
    assert int((args[3] == T).sum()) > 0
    assert not got[0, nv[0]:].any() and not got[-1, nv[-1]:].any()
    assert_bf16_close(got.cpu(), want.float().cpu().numpy())


def test_dense_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(4)
    D, H, W = 10, 40, 36
    K, n = 512, 10 * 40 * 36
    ids = np.full((2, K), n, np.int32)
    ids[0, :500] = np.sort(rng.choice(n, 500, replace=False))
    ids[1, :3] = np.sort(rng.choice(n, 3, replace=False))
    feat = torch.from_numpy(rng.normal(0, 1, (2, K, 128)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    i = torch.from_numpy(ids).to(cuda_device)
    before = dense_build.launches
    got = dense_build.dense_build(feat, i, n)
    want = dense_build.dense_build_plain(feat, i, n)
    torch.cuda.synchronize()
    assert dense_build.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num,index", [(2, 0), (2, 1), (4, 2)])
def test_slab_grid_matches_plain_slice(cuda_device, dtype, num, index):
    """A W slab of the dense grid (models/scatter.py, spatial sharding):
    the in-slab rows compacted to the front, the kernel on the slab's ids,
    bit-equal to the slab's columns of dense_build_plain's whole grid;
    its gradient (through the compaction) bit-equal to the whole grid's
    row gather of a cotangent zero outside the slab."""
    from voxelnet_tpu_torch.models.scatter import scatter_to_dense_streamed
    from voxelnet_tpu_torch.parallel.spatial import slab

    rng = np.random.default_rng(6)
    D, H, W = 10, 40, 64
    K, n = 512, D * H * W
    coords = np.zeros((2, K, 3), np.int32)
    counts = np.zeros((2, K), np.int32)
    for b, live in ((0, 500), (1, 40)):
        cells = np.sort(rng.choice(n, live, replace=False))
        coords[b, :live] = np.stack([cells // (H * W), cells // W % H,
                                     cells % W], -1)
        counts[b, :live] = rng.integers(1, 35, live)
    feat = torch.from_numpy(rng.normal(0, 1, (2, K, 128)).astype(
        np.float32)).to(cuda_device, dtype).requires_grad_()
    c = torch.from_numpy(coords).to(cuda_device)
    k = torch.from_numpy(counts).to(cuda_device)
    x0, w = slab(W, num, index)
    before = dense_build.launches
    got = scatter_to_dense_streamed(feat, c, k, (D, H, W), (x0, w))
    cot = torch.from_numpy(rng.normal(0, 1, got.shape).astype(
        np.float32)).to(cuda_device, dtype)
    got.backward(cot)
    torch.cuda.synchronize()
    assert dense_build.launches == before + 1
    ids = torch.where(k > 0, (c[..., 0] * H + c[..., 1]) * W + c[..., 2],
                      n).to(torch.int32).cpu()
    whole = dense_build.dense_build_plain(feat.detach().cpu(), ids, n)
    assert torch.equal(got.detach().cpu(),
                       whole.view(2, D, H, W, 128)[:, :, :, x0:x0 + w])
    full_cot = torch.zeros((2, D, H, W, 128), dtype=dtype)
    full_cot[:, :, :, x0:x0 + w] = cot.cpu()
    assert torch.equal(feat.grad.cpu(), dense_build.dense_build_grad(
        full_cot.view(2, n, 128), ids, n))


def test_run_copy_kernel_matches_plain(cuda_device):
    """Bit-equal, with runs longer than T and empty voxels (run start N)."""
    cfg = get_config("Car", **TINY)
    spec = voxelize.VoxelGridSpec.from_object_config(cfg.object)
    pts, num = _points(cfg, 2)
    num[1] = 300
    prep = voxelize.prepare(torch.from_numpy(pts).to(cuda_device),
                            torch.from_numpy(num).to(cuda_device), spec,
                            cfg.data.max_voxels)
    T = cfg.object.points_per_voxel
    before = run_copy.launches
    got = run_copy.run_copy(prep.sorted_planar, prep.run_start, T)
    want = run_copy.run_copy_plain(prep.sorted_planar, prep.run_start, T)
    torch.cuda.synchronize()
    assert run_copy.launches == before + 1
    assert int(prep.counts.max()) == T and int(prep.num_voxels[1]) < 256
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_kernel_and_gradient_match_plain(cuda_device, dtype):
    rng = np.random.default_rng(5)
    K, n = 512, 10 * 40 * 36
    ids = np.full((2, K), n, np.int32)
    ids[0, :500] = np.sort(rng.choice(n, 500, replace=False))
    ids[1, :3] = np.sort(rng.choice(n, 3, replace=False))
    feat = torch.from_numpy(rng.normal(0, 1, (2, K, 128)).astype(
        np.float32)).to(cuda_device, dtype).requires_grad_()
    i = torch.from_numpy(ids).to(cuda_device)
    cot = torch.from_numpy(rng.normal(0, 1, (2, n, 128)).astype(
        np.float32)).to(cuda_device, dtype)
    before = dense_build.launches
    got = dense_build.dense_build_autograd(feat, i, n)
    got.backward(cot)
    torch.cuda.synchronize()
    assert dense_build.launches == before + 1
    want = dense_build.dense_build_plain(feat.detach().cpu(), i.cpu(), n)
    assert torch.equal(got.detach().cpu(), want)
    want_grad = dense_build.dense_build_grad(cot.cpu(), i.cpu(), n)
    assert torch.equal(feat.grad.cpu(), want_grad)
    assert not feat.grad[1, 3:].any()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    i8 = torch.zeros(1, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        dense_build.dense_build(torch.zeros(1, 8, 128, dtype=torch.float64,
                                            device=cuda_device), i8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        dense_build.dense_build(
            torch.zeros(1, 8, 128, dtype=torch.bfloat16, device=cuda_device),
            torch.zeros(1, 8, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="contiguous"):
        dense_build.dense_build(
            torch.zeros(1, 128, 8, device=cuda_device).transpose(1, 2), i8,
            64)
    planar = torch.zeros(1, 4, 64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        run_copy.run_copy(planar.double(), i8, 35)
    with pytest.raises(ValueError, match="CUDA"):
        run_copy.run_copy(planar, i8.cpu(), 35)
    with pytest.raises(ValueError, match="contiguous"):
        run_copy.run_copy(torch.zeros(1, 64, 4, device=cuda_device
                                      ).transpose(1, 2), i8, 35)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    f32 = dict(device=cuda_device)
    with pytest.raises(ValueError, match="points_per_voxel"):
        vfe_fused.vfe_fused(
            torch.zeros(1, 4, 64, **f32), torch.zeros(1, 8, **i32),
            torch.zeros(1, **i32), torch.zeros(1, 8, **i32),
            torch.zeros(16, 8, **f32), torch.zeros(16, 3, **f32),
            torch.zeros(64, 32, **f32), torch.zeros(64, 3, **f32), 128)


def _sparse_table(rng, grid, K):
    """coords/counts (3, K, ...) int32: frames 0 and 1 hold voxels at
    sorted random sites, frame 2 none; padding rows carry garbage coords."""
    D, H, W = grid
    coords = rng.integers(-4, max(grid) + 4, (3, K, 3)).astype(np.int32)
    counts = np.zeros((3, K), np.int32)
    for b, n in ((0, K - 12), (1, K // 4)):
        lin = np.sort(rng.choice(D * H * W, n, replace=False))
        coords[b, :n] = np.stack([lin // (H * W), (lin // W) % H, lin % W],
                                 axis=1)
        counts[b, :n] = 1
    return coords, counts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stride_d,pad_d", [(2, 1), (1, 0)])
def test_sparse_conv_kernels_match_plain(cuda_device, dtype, stride_d,
                                         pad_d):
    """Both sparse-conv kernels bit-equal to their plain versions, on the
    whole W and on a window of it; one launch each."""
    rng = np.random.default_rng(stride_d)
    grid, K, C = (10, 40, 36), 512, 64
    coords, counts = _sparse_table(rng, grid, K)
    c = torch.from_numpy(coords).to(cuda_device)
    n = torch.from_numpy(counts).to(cuda_device)
    occ = sparse_conv.occupancy_map(c, n, grid)
    assert torch.equal(occ.cpu(), sparse_conv.occupancy_map(
        c.cpu(), n.cpu(), grid))
    vals = torch.from_numpy(rng.normal(0, 1, (3, K, 27, C)).astype(
        np.float32)).to(cuda_device, dtype)
    bias = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(
        cuda_device)
    before = (sparse_conv.launches, sparse_conv.grad_launches)
    got = sparse_conv.sparse_conv(vals, c, n, occ, bias, stride_d, pad_d)
    win = sparse_conv.sparse_conv(vals, c, n, occ, bias, stride_d, pad_d,
                                  (7, 20))
    fused = sparse_conv.sparse_conv(vals, c, n, occ, bias, stride_d, pad_d,
                                    relu=True)
    dout = torch.from_numpy(rng.normal(0, 1, tuple(got.shape)).astype(
        np.float32)).to(cuda_device, dtype)
    dvals = sparse_conv.sparse_conv_grad(dout, c, n, stride_d, pad_d)
    dwin = sparse_conv.sparse_conv_grad(dout[:, :, :, 7:27].contiguous(), c,
                                        n, stride_d, pad_d, 7)
    torch.cuda.synchronize()
    assert (sparse_conv.launches, sparse_conv.grad_launches) == (
        before[0] + 3, before[1] + 2)
    args = (c.cpu(), n.cpu())
    assert torch.equal(got.cpu(), sparse_conv.sparse_conv_plain(
        vals.cpu(), *args, bias.cpu(), grid, stride_d, pad_d))
    assert torch.equal(win.cpu(), got[:, :, :, 7:27].cpu())
    assert torch.equal(fused, torch.relu(got))
    assert torch.equal(dvals.cpu(), sparse_conv.sparse_conv_grad_plain(
        dout.cpu(), *args, stride_d, pad_d))
    assert torch.equal(dwin.cpu(), sparse_conv.sparse_conv_grad_plain(
        dout[:, :, :, 7:27].cpu(), *args, stride_d, pad_d, 7))
    assert (got[2] == bias.to(dtype)).all() and dvals[1, K // 4:].eq(0).all()


# (grid, K, x windows) at the forward's tile edges (8 rows x 32 sites):
# rows not a multiple of 8, widths and windows below and not a multiple of
# 32, windows at unaligned x0, and a grid every site of which a voxel
# reaches (frames 0 and 1 full), so no site takes the bias-only path
TILE_EDGES = {
    "ragged": ((6, 13, 45), 300, (None, (5, 23), (30, 15))),
    "narrow": ((5, 8, 20), 200, (None, (3, 11), (19, 1))),
    "full": ((3, 3, 5), 45, (None, (1, 3))),
}


@pytest.mark.parametrize("case", sorted(TILE_EDGES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stride_d,pad_d", [(2, 1), (1, 0)])
def test_sparse_conv_tile_edges_match_plain(cuda_device, dtype, stride_d,
                                            pad_d, case):
    """The forward kernel bit-equal to its plain version at its tile edges,
    with the ReLU off and on; the all-padding frame 2 is the bias (ReLU'd)
    everywhere."""
    grid, K, windows = TILE_EDGES[case]
    rng = np.random.default_rng(len(case) + stride_d)
    D, H, W = grid
    coords, counts = _sparse_table(rng, grid, K)
    if case == "full":
        lin = np.arange(K)
        for b in (0, 1):
            coords[b] = np.stack([lin // (H * W), lin // W % H, lin % W], 1)
            counts[b] = 1
    c = torch.from_numpy(coords).to(cuda_device)
    n = torch.from_numpy(counts).to(cuda_device)
    occ = sparse_conv.occupancy_map(c, n, grid)
    vals = torch.from_numpy(rng.normal(0, 1, (3, K, 27, 64)).astype(
        np.float32)).to(cuda_device, dtype)
    bias = torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32)).to(
        cuda_device)
    for window in windows:
        for relu in (False, True):
            got = sparse_conv.sparse_conv(vals, c, n, occ, bias, stride_d,
                                          pad_d, window, relu)
            want = sparse_conv.sparse_conv_plain(
                vals.cpu(), c.cpu(), n.cpu(), bias.cpu(), grid, stride_d,
                pad_d, window, relu)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (window, relu)
            empty = bias.to(dtype)
            assert (got[2] == (torch.relu(empty) if relu else empty)).all()


def test_occupancy_kernel_matches_plain(cuda_device):
    """The occupancy kernel bit-equal to occupancy_map_plain, padding rows
    carrying garbage coords in and out of the grid, frame 2 all padding;
    grids of one block and of several, with cells a multiple of 4 (16-byte
    stores) and not; then two frames with every cell live. One launch a
    call, and the map is the call's whole storage: B * D * H * W int32."""
    rng = np.random.default_rng(5)
    cases = [(grid, *_sparse_table(rng, grid, K)) for grid, K in (
        ((10, 40, 36), 512), ((7, 33, 37), 3000), ((3, 3, 5), 45),
        ((2, 3, 4), 24))]
    for grid in ((3, 3, 5), (4, 40, 36)):
        D, H, W = grid
        lin = np.arange(D * H * W)
        coords = np.stack([lin // (H * W), lin // W % H, lin % W], 1)
        cases.append((grid, np.stack([coords] * 2).astype(np.int32),
                      np.ones((2, len(lin)), np.int32)))
    for grid, coords, counts in cases:
        c = torch.from_numpy(coords).to(cuda_device)
        n = torch.from_numpy(counts).to(cuda_device)
        before = sparse_conv.occupancy_launches
        got = sparse_conv.occupancy_map(c, n, grid)
        torch.cuda.synchronize()
        assert sparse_conv.occupancy_launches == before + 1
        assert got.shape == (len(counts), *grid) and got.dtype == torch.int32
        assert got.is_contiguous() and got.storage_offset() == 0
        assert got.untyped_storage().nbytes() == got.numel() * 4
        assert torch.equal(got.cpu(), sparse_conv.occupancy_map_plain(
            c.cpu(), n.cpu(), grid)), grid


# a live voxel at y = H of a (4, 5, 6) grid, whose flat index lands inside
# the grid, the other rows padding; the call's synchronisation must raise
# a RuntimeError (exit 3)
_OUTSIDE_THE_GRID = """
import torch
from voxelnet_tpu_torch.kernels import sparse_conv
c = torch.zeros(1, 8, 3, dtype=torch.int32, device="cuda")
c[0, 0, 1] = 5
n = torch.zeros(1, 8, dtype=torch.int32, device="cuda")
n[0, 0] = 1
try:
    sparse_conv.occupancy_map(c, n, (4, 5, 6))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised", type(e).__name__, e)
    raise SystemExit(3)
"""

# rows 0-3 of a (4, 5, 6) grid live at cells 0, 7, 30 and 31, then padding,
# with one fault: rows 1 and 2 swapped, row 2 at row 1's cell, or row 0
# padding before live rows; the call's synchronisation must raise (exit 3)
_OUT_OF_ORDER = """
import sys
import torch
from voxelnet_tpu_torch.kernels import sparse_conv
lin = torch.tensor([0, 7, 30, 31, 0, 0, 0, 0])
c = torch.stack([lin // 30, lin // 6 % 5, lin % 6], 1)[None]
c = c.to("cuda", torch.int32).contiguous()
n = torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0]], dtype=torch.int32,
                 device="cuda")
fault = sys.argv[1]
if fault == "swap":
    c[0, [1, 2]] = c[0, [2, 1]]
elif fault == "duplicate":
    c[0, 2] = c[0, 1]
else:
    n[0, 0] = 0
try:
    sparse_conv.occupancy_map(c, n, (4, 5, 6))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised", type(e).__name__, e)
    raise SystemExit(3)
"""


def _run_alone(script: str, *args: str) -> subprocess.CompletedProcess:
    """Run a trap script in a process of its own from the repo root: a
    trap leaves the process's CUDA context unusable."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-c", script, *args], cwd=root,
                          capture_output=True, text=True, timeout=300)


def test_occupancy_kernel_traps_on_live_voxels_outside_the_grid(
        cuda_device):
    """The kernel's side of occupancy_map_plain's ValueError: the trap
    leaves the process's CUDA context unusable, so it runs in a process of
    its own."""
    proc = _run_alone(_OUTSIDE_THE_GRID)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "raised" in proc.stdout


@pytest.mark.parametrize("fault", ["swap", "duplicate", "padding_first"])
def test_occupancy_kernel_traps_on_live_voxels_out_of_order(cuda_device,
                                                            fault):
    """Live rows out of strictly ascending cell order, or a live row after
    a padding row (which the kernel's search cannot place), trap the
    kernel, as the plain version raises on them."""
    proc = _run_alone(_OUT_OF_ORDER, fault)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "raised" in proc.stdout


def test_sparse_conv_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    i32 = dict(dtype=torch.int32, device=cuda_device)
    # 8 live voxels at cells 0-7 of a (4, 5, 6) grid
    lin = torch.arange(8, **i32)
    c = torch.stack([lin * 0, lin // 6, lin % 6], 1)[None].contiguous()
    n = torch.ones(1, 8, **i32)
    occ = sparse_conv.occupancy_map(c, n, (4, 5, 6))
    vals = torch.zeros(1, 8, 27, 64, device=cuda_device)
    bias = torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        sparse_conv.sparse_conv(vals.double(), c, n, occ, bias, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_conv.sparse_conv(vals, c, n.cpu(), occ, bias, 2, 1)
    with pytest.raises(ValueError, match="bias must be torch.float32"):
        sparse_conv.sparse_conv(vals, c, n, occ, bias.bfloat16(), 2, 1)
    with pytest.raises(ValueError, match="16-byte chunks"):
        sparse_conv.sparse_conv(vals[..., :6].contiguous(), c, n, occ,
                                bias[:6], 2, 1)
    with pytest.raises(ValueError, match="16-byte chunks"):
        # 3 chunks of 16 bytes a site, which do not divide 256
        sparse_conv.sparse_conv(vals[..., :24].bfloat16(), c, n, occ,
                                bias[:24], 2, 1)
    with pytest.raises(ValueError, match="coords must be torch.int32"):
        sparse_conv.sparse_conv_grad(torch.zeros(1, 2, 5, 6, 64,
                                                 device=cuda_device),
                                     c.long(), n, 2, 1)
    with pytest.raises(ValueError, match="coords must be torch.int32"):
        sparse_conv.occupancy_map(c.long(), n, (4, 5, 6))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_conv.occupancy_map(c, n.cpu(), (4, 5, 6))


def test_sparse1_inference_on_card_matches_cpu(cuda_device):
    """middle_backend='sparse1' at the tiny grid in f32: the card's
    detections against the CPU's (f32 convs and products in another
    summation order), and the path launched sparse_conv, not dense_build."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("Car", **merged(TINY, rpn={"score_thres": 0.0},
                                     data={"middle_backend": "sparse1"}))
    model = _model(cfg, seed=3)
    pts, num = _points(cfg, 1)
    want = make_inference_fn(cfg, "cpu")(model, pts, num)
    before = (sparse_conv.launches, dense_build.launches)
    got = make_inference_fn(cfg, cuda_device)(model.to(cuda_device), pts,
                                              num)
    torch.cuda.synchronize()
    assert sparse_conv.launches > before[0]
    assert dense_build.launches == before[1]
    assert torch.equal(got.valid.sum(1).cpu(), want.valid.sum(1))
    for b in range(2):
        gs = got.scores[b][got.valid[b]].cpu()
        ws = want.scores[b][want.valid[b]]
        torch.testing.assert_close(gs.sort(descending=True).values,
                                   ws.sort(descending=True).values,
                                   rtol=0, atol=1e-4)


def test_inference_on_card_matches_cpu(cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("Car", **TINY, rpn={"score_thres": 0.0})
    model = _model(cfg, seed=3)
    pts, num = _points(cfg, 1)
    want = make_inference_fn(cfg, "cpu")(model, pts, num)
    got = make_inference_fn(cfg, cuda_device)(model.to(cuda_device), pts,
                                              num)
    torch.cuda.synchronize()
    assert torch.equal(got.valid.sum(1).cpu(), want.valid.sum(1))
    for b in range(2):
        gs = got.scores[b][got.valid[b]].cpu()
        ws = want.scores[b][want.valid[b]]
        # f32 convs in another summation order
        torch.testing.assert_close(gs.sort(descending=True).values,
                                   ws.sort(descending=True).values,
                                   rtol=0, atol=1e-4)


def test_train_step_on_card_matches_cpu(cuda_device):
    """One f32 train step at the tiny grid from the same weights and
    batch: loss within 1e-4 relative; grad norm within 2e-2 relative (f32
    convs sum in another order on the card, and a ReLU that flips at its
    boundary moves a gradient); the step went through both kernels."""
    from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                        make_train_step)

    cfg = get_config("Car", **TINY)
    batch = _train_batch(cfg)
    metrics = {}
    for device in ("cpu", cuda_device):
        state = create_train_state(cfg, _model(cfg, seed=4), device=device)
        before = (run_copy.launches, dense_build.launches)
        _, m = make_train_step(cfg, device=device)(state, batch)
        metrics[str(device)] = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    assert run_copy.launches == before[0] + 1
    assert dense_build.launches == before[1] + 1
    got, want = metrics[str(cuda_device)], metrics["cpu"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=2e-2)
    assert got["voxels_clipped"] == want["voxels_clipped"]


def _train_batch(cfg):
    pts, num = _points(cfg, 3)
    gt = np.zeros((2, cfg.data.max_gt_boxes, 7), np.float32)
    gt[:, 0] = [6.25, 0.18, -1.0, 1.56, 1.6, 3.9, 0.05]
    mask = np.zeros(gt.shape[:2], bool)
    mask[:, 0] = True
    return {"points": pts, "num_points": num, "gt_boxes": gt,
            "gt_mask": mask}


def test_remat_on_card_matches_no_remat(cuda_device):
    """train.remat seams/full on the card: the same loss and BN running
    stats as 'none' from the same weights (the recompute runs on the
    backward's device thread and must leave the running stats alone);
    grad norm within 1e-3 (cuDNN's backward may pick other algorithms)."""
    from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                        make_train_step)

    batch = _train_batch(get_config("Car", **TINY))
    got = {}
    for remat in ("none", "seams", "full"):
        cfg = get_config("Car", **merged(TINY, train={"remat": remat}))
        state = create_train_state(cfg, _model(cfg, seed=4),
                                   device=cuda_device)
        _, m = make_train_step(cfg, device=cuda_device)(state, batch)
        stats = {k: v.cpu() for k, v in state.model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        got[remat] = ({k: float(v) for k, v in m.items()}, stats)
    want_m, want_s = got["none"]
    for remat in ("seams", "full"):
        m, s = got[remat]
        assert m["loss"] == pytest.approx(want_m["loss"], rel=1e-6), remat
        assert m["grad_norm"] == pytest.approx(want_m["grad_norm"],
                                               rel=1e-3), remat
        for k, v in want_s.items():
            torch.testing.assert_close(s[k], v, rtol=1e-6, atol=1e-7,
                                       msg=f"{remat} {k}")


def test_trainer_stages_batches_on_the_card(cuda_device, tmp_path):
    """The trainer's uploads (pinned copies on its side stream, the step's
    stream waiting on them) give back the host batch, through the staging
    thread as well."""
    from torch_port_helpers import write_mini_kitti

    from voxelnet_tpu_torch.data.dataset import make_batch_iterator
    from voxelnet_tpu_torch.training.trainer import Stager, Trainer

    data = write_mini_kitti(str(tmp_path / "kitti"))
    cfg = get_config("Car", **TINY)
    with Trainer(cfg, data + "/training", data + "/validation",
                 exp_dir=str(tmp_path / "exp"), device=cuda_device) as tr:
        batches = list(make_batch_iterator(tr.train_ds, 2, seed=1))
        stager = Stager(iter(batches * 3), tr._host_to_device, depth=2)
        staged = [(b, tr._on_step_stream(s)) for b, s in stager]
        staged.append((batches[0], tr._device_batch(batches[0])))
        torch.cuda.synchronize()
        for host, dev in staged:
            arrays = {k: v for k, v in host.items()
                      if isinstance(v, np.ndarray)}
            assert dev.keys() == arrays.keys()
            for k, v in arrays.items():
                assert dev[k].device.type == "cuda"
                np.testing.assert_array_equal(dev[k].cpu().numpy(), v)
