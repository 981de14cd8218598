"""The port's post-processing (ops/iou.py, ops/nms.py, ops/box_coding.py)
against the JAX ops on the same inputs."""

import jax
import numpy as np
import pytest
import torch

from voxelnet_tpu.ops import box_coding as jax_box
from voxelnet_tpu.ops import iou as jax_iou
from voxelnet_tpu.ops import nms as jax_nms
from voxelnet_tpu_torch.ops import box_coding, iou, nms
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)


def _bev_boxes(rng, n, spread=6.0):
    """(n, 5) BEV boxes (x, y, w, l, r), clustered so many overlap, plus
    exact duplicates and a shared-edge pair."""
    b = np.stack([rng.uniform(0, spread, n), rng.uniform(0, spread, n),
                  rng.uniform(0.5, 2.0, n), rng.uniform(1.0, 4.5, n),
                  rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    b[1] = b[0]
    b[3] = b[2]
    b[3, 0] += b[2, 3]                 # touching along l when r = 0
    b[2, 4] = b[3, 4] = 0.0
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_rotated_iou_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _bev_boxes(rng, 48), _bev_boxes(rng, 40)
    want = np.asarray(jax.jit(jax_iou.rotated_iou)(a, b))
    got = iou.rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # batched leading dims give the same matrices
    batched = iou.rotated_iou(torch.from_numpy(np.stack([a, a])),
                              torch.from_numpy(np.stack([b, b]))).numpy()
    np.testing.assert_array_equal(batched[1], got)
    assert (want > 0.05).mean() > 0.02          # the boxes do overlap


def test_standup_iou_and_corners_match_jax():
    rng = np.random.default_rng(2)
    a, b = _bev_boxes(rng, 32), _bev_boxes(rng, 24)
    ca = iou.bev_corners(torch.from_numpy(a))
    np.testing.assert_allclose(ca.numpy(),
                               np.asarray(jax.jit(jax_iou.bev_corners)(a)),
                               rtol=0, atol=1e-5)
    sa = iou.corners_to_standup(ca)
    sb = iou.corners_to_standup(iou.bev_corners(torch.from_numpy(b)))
    standup = jax.jit(lambda x: jax_iou.corners_to_standup(
        jax_iou.bev_corners(x)))
    jax_standup_iou = jax.jit(jax_iou.standup_iou, static_argnums=2)
    for plus_one in (False, True):
        np.testing.assert_allclose(
            iou.standup_iou(sa, sb, plus_one).numpy(),
            np.asarray(jax_standup_iou(standup(a), standup(b), plus_one)),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("thresh", [0.01, 0.1, 0.5])
def test_greedy_suppress_matches_jax(thresh):
    rng = np.random.default_rng(int(thresh * 100))
    k = 64
    boxes = _bev_boxes(rng, k, spread=4.0)
    mat = np.array(jax.jit(jax_iou.rotated_iou)(boxes, boxes))
    valid = rng.random(k) < 0.9
    want = np.asarray(jax.jit(jax_nms._greedy_suppress, static_argnums=2)(
        mat, valid, thresh))
    got = nms.greedy_suppress(torch.from_numpy(mat), torch.from_numpy(valid),
                              thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize("yaw_mode", ["delta", "sin"])
def test_decode_deltas_matches_jax(yaw_mode):
    rng = np.random.default_rng(3)
    anchors = np.concatenate([rng.uniform(-5, 5, (96, 3)),
                              rng.uniform(0.5, 4, (96, 3)),
                              rng.uniform(-1.6, 1.6, (96, 1))], 1).astype(
        np.float32)
    deltas = rng.normal(0, 0.8, (2, 96, 7)).astype(np.float32)
    want = np.asarray(jax_box.decode_deltas(deltas, anchors, 1.56, yaw_mode))
    got = box_coding.decode_deltas(torch.from_numpy(deltas),
                                   torch.from_numpy(anchors), 1.56, yaw_mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["rotated", "standup"])
def test_nms_bev_matches_jax(mode):
    rng = np.random.default_rng(5)
    B, A = 2, 300
    boxes = np.zeros((B, A, 7), np.float32)
    for b in range(B):
        bev = _bev_boxes(rng, A, spread=10.0)
        boxes[b, :, [0, 1, 4, 5, 6]] = bev.T
        boxes[b, :, 2] = rng.uniform(-2, 0, A)
        boxes[b, :, 3] = rng.uniform(1, 2, A)
    # distinct scores, so top-k order is unambiguous
    scores = rng.permutation(B * A).reshape(B, A).astype(np.float32) / (B * A)
    kw = dict(score_thresh=0.3, iou_thresh=0.1, pre_topk=128, post_topk=20,
              mode=mode)
    want = jax.jit(jax.vmap(lambda bx, sc: jax_nms.nms_bev(
        bx, sc, platform="cpu", **kw)))(boxes, scores)
    got = nms.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    assert got.valid.sum() > 0


@pytest.mark.parametrize("mode", ["rotated", "standup"])
def test_nms_bev_breaks_ties_as_jax(mode):
    """Scores on 6 levels, so most tie exactly, also across the pre_topk
    cut: the port keeps the lower anchor index first, as lax.top_k does,
    and so keeps JAX's boxes in JAX's slots."""
    rng = np.random.default_rng(6)
    B, A = 2, 300
    boxes = np.zeros((B, A, 7), np.float32)
    for b in range(B):
        boxes[b, :, [0, 1, 4, 5, 6]] = _bev_boxes(rng, A, spread=10.0).T
        boxes[b, :, 2] = rng.uniform(-2, 0, A)
        boxes[b, :, 3] = rng.uniform(1, 2, A)
    scores = (rng.integers(0, 6, (B, A)) / 6 + 0.1).astype(np.float32)
    kw = dict(score_thresh=0.3, iou_thresh=0.1, pre_topk=128, post_topk=20,
              mode=mode)
    want = jax.jit(jax.vmap(lambda bx, sc: jax_nms.nms_bev(
        bx, sc, platform="cpu", **kw)))(boxes, scores)
    got = nms.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    differ = (got.boxes.numpy() != np.asarray(want.boxes)).any(-1)
    assert not differ.any(), f"{int(differ.sum())} of {differ.size} slots differ"
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert got.valid.sum() >= 20
