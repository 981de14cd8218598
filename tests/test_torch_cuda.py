"""The port's CUDA kernels against their plain torch versions, and the
inference path and the train step on the card against the CPU. Every test
needs an NVIDIA GPU and skips without one. The card's machine has no JAX,
which tests/conftest.py imports, so run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import TINY, assert_bf16_close, cuda_device  # noqa: F401

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.kernels import dense_build, run_copy, vfe_fused
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
    # one voxel over 32 points (the kernel's two-slot path) in the lowest
    # depth slice, which the voxel cap keeps
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
            torch.zeros(64, 32, **f32), torch.zeros(64, 3, **f32), 65)


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
    pts, num = _points(cfg, 3)
    gt = np.zeros((2, cfg.data.max_gt_boxes, 7), np.float32)
    gt[:, 0] = [6.25, 0.18, -1.0, 1.56, 1.6, 3.9, 0.05]
    mask = np.zeros(gt.shape[:2], bool)
    mask[:, 0] = True
    batch = {"points": pts, "num_points": num, "gt_boxes": gt,
             "gt_mask": mask}
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
