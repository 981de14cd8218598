"""The FLOP and byte counts behind `mfu` and the rooflines."""

import json
import os

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from benchmarks.harness import counts, frames
from benchmarks.reference import net as ref
from benchmarks.tests import tiny


def config(name):
    with open(os.path.join(tiny.REPO, "benchmarks", "configs",
                           f"{name}.json")) as f:
        return json.load(f)["config"]


@pytest.mark.parametrize("name,dense_gflop", [("car", 266.010624),
                                              ("pedestrian", 203.48928)])
def test_dense_flops_from_shapes(name, dense_gflop):
    """Blocks 2-3 and the RPN a frame, by hand: Car's blocks 2-3 are
    2 * 3*400*352 * 64*64*27 and 2 * 2*400*352 * 64*64*27, its RPN 110.3
    GFLOP; Pedestrian's map is 200 x 240 and its RPN's block 1 has stride
    1, so its RPN runs at 200 x 240: block 1 5 * 2*48000 * 128*128*9
    (70.78 GFLOP), block 2 6 * 2*12000 * 128*128*9 (21.23), block 3
    2*3000*9 * (128*256 + 5 * 256*256) (19.46), the transposed
    convolutions 2*48000 * 128*256*9 + 2*12000 * 128*256*4 + 2*3000 *
    256*256*16 (37.75) and the heads 2*48000 * 768*16 (1.18): 150.4."""
    cfg = config(name)
    D, H, W = ref.grid_dzyx(cfg["object"])
    blocks = 2.0 * (3 + 2) * H * W * 64 * 64 * 27
    assert counts.dense_flops(cfg) / 1e9 == pytest.approx(dense_gflop,
                                                          rel=1e-9)
    rpn = counts.dense_flops(cfg) - blocks
    assert rpn / 1e9 == pytest.approx({"car": 110.3, "pedestrian": 150.4}
                                      [name], rel=2e-3)


def occupancy_taps(coords, counts_, cfg):
    """The (output site, tap) pairs that read an occupied voxel, counted
    densely: a 3x3x3 conv of ones over the occupancy grid, summed."""
    D, H, W = ref.grid_dzyx(cfg["object"])
    _, stride, pad = ref.MIDDLE[0]
    occ = torch.zeros((1, 1, D, H, W), dtype=torch.float64)
    live = counts_ > 0
    c = torch.from_numpy(coords[live]).long()
    occ[0, 0, c[:, 0], c[:, 1], c[:, 2]] = 1.0
    out = F.conv3d(occ, torch.ones((1, 1, 3, 3, 3), dtype=torch.float64),
                   stride=(stride, 1, 1), padding=(pad, 1, 1))
    return int(out.sum())


@pytest.mark.parametrize("name", ["car", "pedestrian"])
def test_block1_taps_equal_a_dense_count(name):
    cfg = config(name)
    sweeps = frames.load_sweeps(os.path.join(tiny.REPO, tiny.FRAMES))
    mix = {"batch": 1, "pool_batches": 1, "rotation_deg": 45.0, "flip": 0.5,
           "drop": 0.05}
    pts, num = frames.batch_pool(sweeps, cfg, mix,
                                 np.random.default_rng(0))[0]
    _, coords, cnt = ref.voxelize(pts, num, cfg)
    taps = counts.block1_taps(coords[0], cnt[0], cfg)
    assert taps == occupancy_taps(coords[0], cnt[0], cfg)
    voxels = int((cnt[0] > 0).sum())
    # 9 in-plane taps, and 1 or 2 of the 3 in depth by the depth's parity
    assert 9 * 1.3 * voxels < taps < 9 * 1.7 * voxels
    # about 2.9 GFLOP (Car) or 2.6 (Pedestrian) of block 1 a frame
    assert 2.0 < 2 * 128 * 64 * taps / 1e9 < 3.5


def test_the_count_is_the_same_for_conv3d_and_sparse1():
    """The count reads the batch's voxels, not the middle's lowering."""
    base = config("car")
    sweeps = frames.load_sweeps(os.path.join(tiny.REPO, tiny.FRAMES))
    mix = {"batch": 2, "pool_batches": 1, "rotation_deg": 45.0, "flip": 0.5,
           "drop": 0.05}
    pts, num = frames.batch_pool(sweeps, base, mix,
                                 np.random.default_rng(1))[0]
    got = []
    for middle in ("conv3d", "sparse1"):
        cfg = json.loads(json.dumps(base))
        cfg["data"]["middle_backend"] = middle
        stored, taps, _ = counts.batch_stats(pts, num, cfg)
        got.append(counts.forward_flops(cfg, stored, taps, 2))
    assert got[0] == got[1]
    # about 270 GFLOP a Car frame; a dense block 1 would add 311 more
    assert 265e9 < got[0] / 2 < 275e9


def test_kernel_bounds_count_each_byte_once():
    from voxelnet_tpu_torch.config import get_config
    from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, prepare

    cfg = tiny.tiny_config()["config"]
    config = get_config("Car").from_dict(cfg)
    sweeps = frames.load_sweeps(os.path.join(tiny.REPO, tiny.FRAMES))
    mix = {"batch": 2, "pool_batches": 1, "rotation_deg": 45.0, "flip": 0.5,
           "drop": 0.05}
    pts, num = frames.batch_pool(sweeps, cfg, mix,
                                 np.random.default_rng(2))[0]
    p = prepare(torch.from_numpy(pts), torch.from_numpy(num),
                VoxelGridSpec.from_object_config(config.object),
                cfg["data"]["max_voxels"])

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    B, K = p.run_start.shape
    T = cfg["object"]["points_per_voxel"]
    D, H, W = ref.grid_dzyx(cfg["object"])
    grid_elem = 4      # the tiny configuration computes in float32
    stored = int(p.counts.sum())
    got = counts.kernel_bounds(cfg, B, stored)
    weights = (16 * 8 + 16 * 3 + 64 * 32 + 64 * 3) * 4
    vfe = nbytes(p.sorted_planar, p.run_start, p.num_voxels, p.counts)
    assert got["vfe_fused"] == pytest.approx(max(
        (vfe + weights + B * K * 128 * 2) / counts.HBM_BYTES_PER_S,
        2 * counts.VFE_MACS_PER_POINT * stored / 989e12))
    assert got["dense_build"] == pytest.approx(
        (B * K * 128 * grid_elem + nbytes(p.run_start)
         + B * D * H * W * 128 * grid_elem) / counts.HBM_BYTES_PER_S)
    assert got["run_copy"] == pytest.approx(
        (nbytes(p.sorted_planar, p.run_start) + B * K * T * 16)
        / counts.HBM_BYTES_PER_S)
