"""The port's reference-named API (voxelnet_tpu_torch/reference_api.py),
mirroring tests/test_reference_api.py, each function held to the JAX
package's `reference_api` on the same inputs, on the CPU
(`device="cpu"`). Tolerances: integer and mask outputs exact; the anchors
and voxel buffers bit-equal; decoded boxes within 2e-5 (abs) of JAX's,
the smooth L1 within 1e-7, the regression targets within 1e-5 (f32
arithmetic in another order); NMS detections compared by score and box,
not by slot (top-k ties)."""

import numpy as np
import pytest
import torch
from torch_port_helpers import TINY, configs, jax_variables
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu import reference_api as jax_ref
from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch import reference_api as ref

LABELS = [[
    "Car 0.00 0 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 "
    "-0.65 1.71 46.70 -1.59\n",
], [
    "Car 0.00 0 1.21 387.01 170.40 450.90 214.00 1.52 1.61 3.92 -2.45 "
    "1.69 18.21 1.12\n",
    "Pedestrian 0.00 0 0.33 700.00 160.00 720.00 230.00 1.70 0.60 0.80 "
    "1.40 1.70 5.10 0.20\n",
    "Car 0.00 0 -0.3 100.00 150.00 200.00 220.00 1.50 1.60 4.00 6.90 "
    "1.80 30.50 -0.31\n",
]]


@pytest.mark.parametrize("class_name", ["Car", "Pedestrian", "Cyclist"])
def test_cfg_defaults(class_name):
    cfg = ref.get_cfg_defaults(class_name)
    assert cfg.to_dict() == jax_ref.get_cfg_defaults(class_name).to_dict()
    assert ref.get_cfg_defaults().object.grid_size == (10, 400, 352)


def test_pcl_to_voxels_buffers(monkeypatch):
    """The reference's buffer names, shapes and dtypes; with the shuffle's
    Generator seeded alike, JAX's buffers bit for bit."""
    rng = np.random.default_rng(0)
    pcl = np.concatenate([
        rng.uniform([0, -40, -3], [70.4, 40, 1], (3000, 3)),
        rng.uniform(0, 1, (3000, 1))], axis=1).astype(np.float32)
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(7 if seed is None
                                                      else seed))
    want = jax_ref.pcl_to_voxels(pcl, "Car")
    vox = ref.pcl_to_voxels(pcl, "Car")
    K = vox["coordinate_buffer"].shape[0]
    assert vox["feature_buffer"].shape == (K, 35, 7)
    assert vox["number_buffer"].dtype == np.int64
    assert vox["number_buffer"].sum() <= 3000
    for key, w in want.items():
        assert vox[key].dtype == w.dtype, key
        np.testing.assert_array_equal(vox[key], w, err_msg=key)
    again = ref.pcl_to_voxels(pcl, "Car", rng=default_rng(7))
    np.testing.assert_array_equal(again["coordinate_buffer"],
                                  want["coordinate_buffer"])


def test_generate_anchors_and_decode():
    anchors = ref.generate_anchors("Car")
    assert anchors.shape == (200, 176, 2, 7)
    np.testing.assert_array_equal(anchors, jax_ref.generate_anchors("Car"))
    deltas = np.zeros((1, 200, 176, 14), np.float32)
    boxes = ref.deltas_to_boxes_3d(deltas, anchors, device="cpu")
    assert boxes.shape == (1, 70400, 7)
    np.testing.assert_allclose(boxes[0], anchors.reshape(-1, 7), atol=1e-5)
    deltas = np.random.default_rng(1).normal(
        0, 0.3, (2, 200, 176, 14)).astype(np.float32)
    np.testing.assert_allclose(
        ref.deltas_to_boxes_3d(deltas, anchors, device="cpu"),
        jax_ref.deltas_to_boxes_3d(deltas, anchors), rtol=0, atol=2e-5)


def _by_score(boxes, scores):
    order = np.lexsort((boxes[:, 0], -scores))
    return boxes[order], scores[order]


def test_nms_and_smooth_l1():
    boxes = np.array([[10, 0, -1, 1.5, 1.6, 3.9, 0.0],
                      [10.1, 0, -1, 1.5, 1.6, 3.9, 0.0],
                      [30, 5, -1, 1.5, 1.6, 3.9, 0.0]], np.float32)
    kept, scores = ref.nms(boxes, np.array([0.9, 0.8, 0.7], np.float32),
                           device="cpu")
    assert len(kept) == 2
    out = ref.smooth_L1_loss(np.array([1.0]), np.array([0.0]), device="cpu")
    assert out[0] == pytest.approx(1.0 - 0.5 / 9.0, abs=1e-6)

    rng = np.random.default_rng(2)
    n = 300
    boxes = np.concatenate([
        rng.uniform([0, -20, -2], [40, 20, -1], (n, 3)),
        rng.uniform([1.4, 1.5, 3.5], [1.7, 1.8, 4.5], (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    for mode in ("rotated", "standup"):
        got = _by_score(*ref.nms(boxes, scores, overlap=0.1, top_k=50,
                                 score_thresh=0.2, mode=mode, device="cpu"))
        want = _by_score(*jax_ref.nms(boxes, scores, overlap=0.1, top_k=50,
                                      score_thresh=0.2, mode=mode))
        assert len(got[0]) == len(want[0]) > 10
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    d, t = rng.normal(0, 0.5, (2, 64, 14)).astype(np.float32)
    np.testing.assert_allclose(ref.smooth_L1_loss(d, t, device="cpu"),
                               jax_ref.smooth_L1_loss(d, t), rtol=0,
                               atol=1e-7)


def test_generate_targets_reference_signature():
    anchors = ref.generate_anchors("Car")
    pos, neg, tgt = ref.generate_targets(LABELS[:1], (200, 176), anchors,
                                         device="cpu")
    assert pos.shape == (1, 200, 176, 2)
    assert neg.shape == (1, 200, 176, 2)
    assert tgt.shape == (1, 200, 176, 14)
    assert pos.sum() >= 1
    assert neg.sum() > 60000
    got = ref.generate_targets(LABELS, (200, 176), anchors, device="cpu")
    want = jax_ref.generate_targets(LABELS, (200, 176), anchors)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    assert got[0][1].sum() >= 2                 # the second frame's cars


def test_model_names_and_inference():
    """RPN3D is the port's VoxelNet: JAX variables load into it; the
    reference-named build_model / init_params / make_inference_fn give the
    port's own model and detections."""
    from voxelnet_tpu_torch.models.voxelnet import build_model
    from voxelnet_tpu_torch.models.voxelnet import make_inference_fn

    jcfg, cfg = configs(overrides=dict(TINY, rpn={"score_thres": 0.0}))
    model = ref.build_model(cfg, seed=3, device="cpu")
    assert isinstance(model, ref.RPN3D)
    model.load_state_dict(convert.from_jax_variables(jax_variables(jcfg)))
    params = ref.init_params(cfg, seed=3)
    own = build_model(cfg, seed=3).state_dict()
    assert params.keys() == own.keys()
    assert all(torch.equal(params[k], own[k]) for k in own)
    rng = np.random.default_rng(4)
    points = np.zeros((2, cfg.data.max_points, 4), np.float32)
    points[:, :1500] = np.concatenate([
        rng.uniform([0, -6.4, -3], [12.8, 6.4, 1], (2, 1500, 3)),
        rng.uniform(0, 1, (2, 1500, 1))], -1)
    num = np.full((2,), 1500, np.int32)
    got = ref.make_inference_fn(cfg, device="cpu")(
        model, torch.from_numpy(points), torch.from_numpy(num))
    want = make_inference_fn(cfg, "cpu")(model, torch.from_numpy(points),
                                         torch.from_numpy(num))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got.valid.sum()) > 0


def test_device_functions_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    anchors = ref.generate_anchors("Car")
    calls = [
        lambda: ref.deltas_to_boxes_3d(np.zeros((1, 200, 176, 14),
                                                np.float32), anchors),
        lambda: ref.nms(np.zeros((2, 7), np.float32),
                        np.zeros(2, np.float32)),
        lambda: ref.smooth_L1_loss(np.zeros(2), np.zeros(2)),
        lambda: ref.generate_targets(LABELS[:1], (200, 176), anchors),
        lambda: ref.build_model(ref.get_cfg_defaults()),
        lambda: ref.make_inference_fn(ref.get_cfg_defaults()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
