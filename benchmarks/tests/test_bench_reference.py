"""The plain reference against the program's CPU path, at a tiny grid in
float32: voxels, maps, anchors, decoding, IoU, NMS, targets and one
training step."""

import math

import numpy as np
import pytest
import torch

from benchmarks.harness import core, frames, weights
from benchmarks.reference import detect
from benchmarks.reference import net as ref
from benchmarks.reference import train as ref_train
from benchmarks.tests import tiny


@pytest.fixture(scope="module", params=[2, 1], ids=["stride2", "stride1"])
def setup(request):
    """The tiny cell's configuration with the RPN's block 1 at stride 2
    (Car's) and at stride 1 with anchors at the full map (Pedestrian's)."""
    spec = tiny.tiny_config()
    cfg = spec["config"]
    cfg["rpn"]["block1_stride"] = request.param
    cfg["object"]["feature_ratio"] = request.param
    mix = {"batch": 2, "pool_batches": 1, "rotation_deg": 45.0, "flip": 0.5,
           "drop": 0.05}
    sweeps = frames.load_sweeps(f"{tiny.REPO}/{tiny.FRAMES}")
    pts, num = frames.batch_pool(sweeps, cfg, mix,
                                 np.random.default_rng(3))[0]
    params = weights.make_params(cfg, 5, "cpu")
    weights.calibrate(cfg, params, pts, num, 5, {"candidates": 8}, "cpu")
    return spec, cfg, pts, num, params


def model(cfg, params):
    from voxelnet_tpu_torch.models.voxelnet import VoxelNet

    m = VoxelNet(core.port_config(cfg))
    m.load_state_dict(params)
    return m


def test_voxels_equal_the_programs(setup):
    from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, voxelize_np

    _, cfg, pts, num, _ = setup
    spec = VoxelGridSpec.from_object_config(
        core.port_config(cfg).object)
    feats, coords, counts = ref.voxelize(pts, num, cfg)
    for b in range(len(pts)):
        want = voxelize_np(pts[b, : num[b]], spec, cfg["data"]["max_voxels"])
        np.testing.assert_array_equal(coords[b], want.coords)
        np.testing.assert_array_equal(counts[b], want.counts)
        np.testing.assert_allclose(feats[b], want.features, atol=1e-6)


def test_eval_maps_equal_the_programs_f32_path(setup):
    _, cfg, pts, num, params = setup
    m = model(cfg, params).eval()
    feats, coords, counts = ref.voxelize(pts, num, cfg)
    with torch.no_grad():
        want = m(*(torch.from_numpy(a) for a in (feats, coords, counts)))
    got = ref.maps(cfg, params, pts, num, "cpu")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_anchors_and_decode_equal_the_programs(setup):
    from voxelnet_tpu_torch.ops.anchors import anchors_flat
    from voxelnet_tpu_torch.ops.box_coding import decode_deltas

    _, cfg, _, _, _ = setup
    obj = core.port_config(cfg).object
    anc = detect.anchors(cfg)
    torch.testing.assert_close(anc, torch.from_numpy(anchors_flat(obj)))
    deltas = 0.3 * torch.randn(3, len(anc), 7,
                               generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(detect.decode(deltas, anc, cfg),
                               decode_deltas(deltas, anc, obj.anchor_h))
    boxes = detect.decode(deltas, anc, cfg)
    torch.testing.assert_close(ref_train.encode(boxes, anc, cfg), deltas,
                               rtol=1e-4, atol=1e-5)


def test_rotated_iou_equals_the_programs():
    from voxelnet_tpu_torch.ops.iou import rotated_iou

    g = torch.Generator().manual_seed(1)

    def boxes(n):
        return torch.cat([6 * torch.rand(n, 2, generator=g),
                          1 + 3 * torch.rand(n, 2, generator=g),
                          2 * math.pi * torch.rand(n, 1, generator=g)], 1)

    a, b = boxes(40), boxes(30)
    want = rotated_iou(a, b).double()
    got = detect.rotated_iou(a, b)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    torch.testing.assert_close(torch.diag(detect.rotated_iou(a, a)),
                               torch.ones(40, dtype=torch.float64))


@pytest.mark.parametrize("mode", ["rotated", "standup"])
def test_nms_equals_the_programs(setup, mode):
    from voxelnet_tpu_torch.ops.nms import nms_bev

    _, cfg, _, _, _ = setup
    cfg = dict(cfg, rpn=dict(cfg["rpn"], nms_mode=mode, nms_thres=0.1,
                             score_thres=0.5))
    anc = detect.anchors(cfg)
    g = torch.Generator().manual_seed(2)
    deltas = 0.3 * torch.randn(len(anc), 7, generator=g)
    scores = torch.rand(len(anc), generator=g)
    boxes = detect.decode(deltas, anc, cfg)
    rpn = cfg["rpn"]
    want = nms_bev(boxes[None], scores[None], score_thresh=rpn["score_thres"],
                   iou_thresh=rpn["nms_thres"], pre_topk=rpn["nms_pre_topk"],
                   post_topk=rpn["nms_post_topk"], mode=mode)
    kb, ks, _ = detect.nms(boxes, scores, cfg)
    n = int(want.valid.sum())
    assert n == len(ks) > 1
    torch.testing.assert_close(kb, want.boxes[0, :n])
    torch.testing.assert_close(ks, want.scores[0, :n])


def test_targets_equal_the_programs(setup):
    from voxelnet_tpu_torch.ops import targets as port_targets

    spec, cfg, _, _, _ = setup
    obj = core.port_config(cfg).object
    gt, mask = frames.gt_boxes(cfg, {"per_frame": 3.0,
                                     "mean_hwl": spec["labels"]["mean_hwl"]},
                               4, np.random.default_rng(4))
    anc = detect.anchors(cfg)
    standup = torch.from_numpy(port_targets.anchor_standup_np(obj))
    want = port_targets.assign_targets(
        torch.from_numpy(gt), torch.from_numpy(mask), anc, standup,
        pos_iou=obj.rpn_pos_iou, neg_iou=obj.rpn_neg_iou,
        anchor_h=obj.anchor_h)
    got = ref_train.targets(torch.from_numpy(gt), torch.from_numpy(mask),
                            anc, cfg)
    assert float(want.pos_mask.sum()) > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_one_training_step_equals_the_programs(setup):
    from voxelnet_tpu_torch.training.optim import make_optimizer
    from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                        make_train_step)

    spec, cfg, pts, num, _ = setup
    params = weights.make_params(cfg, 6, "cpu")
    gt, mask = frames.gt_boxes(cfg, spec["labels"], len(pts),
                               np.random.default_rng(5))
    config = core.port_config(cfg)
    m = model(cfg, {k: v.clone() for k, v in params.items()})
    opt = make_optimizer(config, 100)
    state = create_train_state(config, m, device="cpu", optimizer=opt)
    step = make_train_step(config, "cpu", optimizer=opt)
    _, metrics = step(state, {"points": pts, "num_points": num,
                              "gt_boxes": gt, "gt_mask": mask})
    terms = ref_train.step(cfg, params, pts, num, gt, mask,
                           opt.schedule(0), "cpu")
    for name, value in terms.items():
        assert value == pytest.approx(float(metrics[name]), rel=1e-5), name
    after = m.state_dict()
    for n in ref_train.param_names(cfg):
        torch.testing.assert_close(params[n], after[n].detach(), rtol=1e-4,
                                   atol=1e-6)
    # the batch-norms' running statistics, which the step moves
    stats = [n for n in after if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 25
    for n in stats:
        torch.testing.assert_close(params[n], after[n], rtol=1e-4, atol=1e-6)
