"""The comparison has to fail: the control (the plain reference in the
program's place, computed in float8, the precision below the
configuration's bfloat16) and each fault a cell can have, planted under
a whole run of a tiny cell on the CPU (the look for a card skipped),
give correct == false."""

import pytest
import torch

from benchmarks.harness import core
from benchmarks.reference import detect
from benchmarks.reference import net as ref

SEED = 2 ** 31 + 21


def patch_inference(monkeypatch, wrap):
    import voxelnet_tpu_torch.models.voxelnet as port

    make = port.make_inference_fn

    def patched(config, device="cuda"):
        return wrap(make(config, device), config)

    monkeypatch.setattr(port, "make_inference_fn", patched)


def run(root, cell):
    return core.run(root, cell, SEED, 0.5, False, "cpu")


def test_sound_runs_are_correct(tiny_root):
    assert run(tiny_root, "tiny-infer")["correct"]
    assert run(tiny_root, "tiny-train")["correct"]


def test_control_fails(tiny_root, monkeypatch):
    """The reference's maps in float8, its decode and its NMS."""
    from voxelnet_tpu_torch.models.voxelnet import Detections

    cell = core.load_cell(tiny_root, "tiny-infer", SEED, "cpu")
    cfg = cell.cfg

    def wrap(fn, config):
        def control(model, points, num_points, marks=None):
            params = {k: v.detach() for k, v in model.state_dict().items()}
            cls, reg = ref.maps(cfg, params, points.numpy(),
                                num_points.numpy(), "cpu", quant=ref.fp8)
            B = cls.shape[0]
            anc = detect.anchors(cfg)
            scores = torch.sigmoid(cls.reshape(B, -1))
            boxes = detect.decode(reg.reshape(B, -1, 7), anc, cfg)
            post = cfg["rpn"]["nms_post_topk"]
            out = (torch.zeros(B, post, 7), torch.zeros(B, post),
                   torch.zeros(B, post, dtype=torch.bool))
            for b in range(B):
                kb, ks, _ = detect.nms(boxes[b], scores[b], cfg)
                out[0][b, :len(ks)], out[1][b, :len(ks)] = kb, ks
                out[2][b, :len(ks)] = True
            return Detections(*out)
        return control

    patch_inference(monkeypatch, wrap)
    r = run(tiny_root, "tiny-infer")
    assert not r["correct"], r["checks"]


def stale(fn, config):
    last = []

    def f(model, points, num_points, marks=None):
        det = fn(model, points, num_points, marks)
        last.append(det)
        return last[-2] if len(last) > 1 else det
    return f


def half_batch(fn, config):
    def f(model, points, num_points, marks=None):
        det = fn(model, points, num_points, marks)
        valid = det.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return det._replace(valid=valid)
    return f


def altered(fn, config):
    """One detection's length doubled where the program produces it."""
    def f(model, points, num_points, marks=None):
        det = fn(model, points, num_points, marks)
        boxes = det.boxes.clone()
        b, k = torch.nonzero(det.valid)[0]
        boxes[b, k, 5] *= 2.0
        return det._replace(boxes=boxes)
    return f


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
def test_inference_faults_fail(tiny_root, monkeypatch, fault):
    patch_inference(monkeypatch, fault)
    r = run(tiny_root, "tiny-infer")
    assert not r["correct"], r["checks"]


def test_decoding_fault_fails(tiny_root, monkeypatch):
    """The program's centre offsets scaled by the anchor's length and not
    by its bird's-eye diagonal (7% short for the tiny cell's Car
    anchor)."""
    import voxelnet_tpu_torch.ops.box_coding as coding

    decode = coding.decode_deltas

    def by_length(deltas, anchors, anchor_h, yaw_mode="delta"):
        boxes = decode(deltas, anchors, anchor_h, yaw_mode)
        a = anchors.to(boxes.dtype)
        scale = (a[:, 5] / torch.sqrt(a[:, 4] ** 2 + a[:, 5] ** 2))[:, None]
        xy = a[:, :2] + (boxes[..., :2] - a[:, :2]) * scale
        return torch.cat([xy, boxes[..., 2:]], -1)

    monkeypatch.setattr(coding, "decode_deltas", by_length)
    r = run(tiny_root, "tiny-infer")
    assert not r["correct"], r["checks"]


def patch_step(monkeypatch, wrap):
    import voxelnet_tpu_torch.training.train_step as port

    make = port.make_train_step

    def patched(config, device="cuda", steps_per_epoch=1, *, optimizer=None):
        return wrap(make(config, device, steps_per_epoch,
                         optimizer=optimizer))

    monkeypatch.setattr(port, "make_train_step", patched)


def unchanged(step):
    """A step that returns its state as it found it."""
    def f(state, batch, marks=None):
        keep = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, metrics = step(state, batch, marks)
        state.model.load_state_dict(keep)
        return state, metrics
    return f


def half_of_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def f(state, batch, marks=None):
        half = {k: v[: len(v) // 2] for k, v in batch.items()}
        state, metrics = step(state, half, marks)
        for k in ("loss", "cls_pos_loss", "cls_neg_loss", "reg_loss"):
            metrics[k] = metrics[k] * 2
        return state, metrics
    return f


def test_training_control_fails(tiny_root, monkeypatch):
    """The reference's training step in float8 in the program's place."""
    from benchmarks.reference import train as ref_train
    import voxelnet_tpu_torch.training.train_step as port

    cfg = core.load_cell(tiny_root, "tiny-train", SEED, "cpu").cfg

    def patched(config, device="cuda", steps_per_epoch=1, *, optimizer=None):
        lr = optimizer.schedule(0)

        def control(state, batch, marks=None):
            params = {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()}
            terms = ref_train.step(
                cfg, params, batch["points"].numpy(),
                batch["num_points"].numpy(), batch["gt_boxes"],
                batch["gt_mask"], lr, "cpu", quant=ref.fp8)
            state.model.load_state_dict(params)
            return state, {k: torch.tensor(v) for k, v in terms.items()}
        return control

    monkeypatch.setattr(port, "make_train_step", patched)
    r = run(tiny_root, "tiny-train")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_of_batch])
def test_training_faults_fail(tiny_root, monkeypatch, fault):
    patch_step(monkeypatch, fault)
    r = run(tiny_root, "tiny-train")
    assert not r["correct"], r["checks"]


def test_a_late_answer_is_not_a_wrong_one(tiny_root, monkeypatch):
    """Latency is the window's to count; a slow call is still judged by
    what it says."""
    import time

    def slow(fn, config):
        def f(model, points, num_points, marks=None):
            time.sleep(0.05)
            return fn(model, points, num_points, marks)
        return f

    patch_inference(monkeypatch, slow)
    assert run(tiny_root, "tiny-infer")["correct"]
