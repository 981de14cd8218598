"""The synthetic learning run of the port: synthetic KITTI frames -> train
-> predict -> AP. The port's counterpart of
`scripts/train_synthetic_smoke.py`, with its flags, defaults, config
overrides and frames.

Frames are class-sized boxes with points on their surfaces over ground
clutter, drawn from `default_rng(0)` in the script's order, so a run sees
the script's frames. The detector trains at full width through the port's
`make_train_step` with momentum SGD (`chain(clip_by_global_norm,
sgd(lr, momentum=0.9))`, an optional 10x LR drop at `--lr-drop-at` of the
steps), then detects on held-out frames through `make_inference_fn` and
scores KITTI AP (IoU 0.5 and 0.7, BEV and 3D, moderate) with
`training/evaluate.py`. A rising AP checks the whole stack: voxelizer,
VFE, convs, targets, loss, optimizer, decode, NMS, label I/O and eval.

    python -m voxelnet_tpu_torch.tools.synthetic_smoke [--steps 400]
        [--frames 128] [--class-name Pedestrian] [--dump-labels DIR]
        [--device cuda] [--init-seed 0 | --init-weights NPZ]

Each held-out frame is scored as `cli.eval` scores its label files: the
predictions and the ground truth are emitted as KITTI label lines (lidar
boxes through the config's mean calibration), and the ground truth's
difficulty comes from the projected 2D box of its line (the devkit's
moderate bucket drops boxes under 25 px). `--dump-labels DIR` writes those
lines under DIR/preds/data and DIR/gt and scores them through the port's
`cli.eval`, which must give the same AP. The JAX script's in-process AP
counts every ground-truth box as moderate instead; its `cli/eval` rows
(BASELINE.md) are the comparable ones.

Beyond the script: `--device` (default cuda) and `--init-seed`, which
seeds only the port's weight initialisation (the frames stay the
script's); `--init-weights NPZ` starts from the JAX variables in a
`convert.save_npz` file instead (the JAX script's own initial state, for a
like-for-like run), refused when its decode knobs or its shapes do not fit
the run's config; `--save-checkpoint DIR` writes the port's checkpoint,
which `cli.predict --checkpoint DIR` reads; `--cfg FILE` merges a YAML
override file (utils/yaml_subset.py) over the script's overrides, for
small runs.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.training.optim import (ClippedSGD,
                                               piecewise_constant_schedule)

MOMENTUM = 0.9

# per-class scene parameters: box-size ranges (KITTI-typical), spawn
# region inside the class grid, z-BOTTOM near the class anchor_z,
# surface-point budget, min separation
_SCENES = {
    "Car": dict(x=(8, 62), y=(-32, 32), zb=(-1.9, -1.5),
                h=(1.4, 1.7), w=(1.5, 1.8), l=(3.5, 4.5),
                pts=400, sep=(6.0, 4.0),
                ground=((0, 70.4), (-40, 40), -1.9)),
    "Pedestrian": dict(x=(4, 44), y=(-16, 16), zb=(-1.55, -1.38),
                       h=(1.6, 1.85), w=(0.5, 0.7), l=(0.7, 0.9),
                       pts=150, sep=(2.0, 2.0),
                       ground=((0, 48.0), (-20, 20), -1.5)),
    "Cyclist": dict(x=(4, 44), y=(-16, 16), zb=(-1.55, -1.38),
                    h=(1.6, 1.85), w=(0.5, 0.7), l=(1.6, 1.9),
                    pts=180, sep=(3.0, 2.0),
                    ground=((0, 48.0), (-20, 20), -1.5)),
}


def synth_frame(rng: np.random.Generator, max_boxes=5, class_name="Car",
                yaw_limit=np.pi / 2):
    """One synthetic frame: (points (N, 4), gt lidar boxes (G, 7)).

    yaw_limit: box yaws are uniform in (-yaw_limit, yaw_limit). The full
    +-pi/2 band exercises the known pi-ambiguity of the reference's raw
    yaw-delta regression (a rectangle at r and r - pi is the same shape,
    so near-boundary boxes carry bimodal targets and the regressor
    averages ~90 deg off); convergence runs use a narrower band to
    measure the detector inside the encoding's competence envelope.
    """
    sc = _SCENES[class_name]
    n_boxes = rng.integers(1, max_boxes + 1)
    boxes = []
    for _ in range(n_boxes):
        for _attempt in range(20):
            x = rng.uniform(*sc["x"])
            y = rng.uniform(*sc["y"])
            z = rng.uniform(*sc["zb"])
            h = rng.uniform(*sc["h"])
            w = rng.uniform(*sc["w"])
            l = rng.uniform(*sc["l"])
            r = rng.uniform(-yaw_limit, yaw_limit)
            if all((abs(x - b[0]) > sc["sep"][0])
                   or (abs(y - b[1]) > sc["sep"][1]) for b in boxes):
                boxes.append([x, y, z, h, w, l, r])
                break
    boxes = np.asarray(boxes, np.float32)

    pts = []
    # ground clutter
    (gxr, gyr, gz0) = sc["ground"]
    n_ground = 6000
    gx = rng.uniform(*gxr, n_ground)
    gy = rng.uniform(*gyr, n_ground)
    gz = rng.normal(gz0, 0.05, n_ground)
    pts.append(np.stack([gx, gy, gz, rng.uniform(0, 1, n_ground)], 1))
    # box surface points
    for b in boxes:
        m = sc["pts"]
        face = rng.integers(0, 5, m)
        u = rng.uniform(-0.5, 0.5, m)
        v = rng.uniform(-0.5, 0.5, m)
        lx = np.where(face == 0, -0.5, np.where(face == 1, 0.5, u))
        ly = np.where(face == 2, -0.5, np.where(face == 3, 0.5, v))
        lz = np.where(face == 4, 1.0, rng.uniform(0, 1, m))
        lx = lx * b[5]
        ly = ly * b[4]
        lz = lz * b[3]
        c, s = np.cos(b[6]), np.sin(b[6])
        wx = c * lx - s * ly + b[0]
        wy = s * lx + c * ly + b[1]
        wz = lz + b[2]
        pts.append(np.stack([wx, wy, wz, rng.uniform(0.3, 1, m)], 1))
    return np.concatenate(pts).astype(np.float32), boxes


def make_config(class_name: str = "Car", score_thres: float = 0.5,
                yaw_encoding: str = "delta", cfg_file: str | None = None):
    """The script's config: the class preset with 16384 points, 8192
    voxel slots and 8 GT slots a frame, then `cfg_file`'s overrides."""
    cfg = get_config(
        class_name,
        data={"max_points": 16384, "max_voxels": 8192, "max_gt_boxes": 8},
        rpn={"score_thres": score_thres},
        train={"yaw_encoding": yaw_encoding},
    )
    return cfg.merge_from_file(cfg_file) if cfg_file else cfg


class Batch(NamedTuple):
    points: np.ndarray      # (B, max_points, 4) f32
    num_points: np.ndarray  # (B,) i32
    gt_boxes: np.ndarray    # (B, max_gt_boxes, 7) f32
    gt_mask: np.ndarray     # (B, max_gt_boxes) bool
    raw_gts: list           # each frame's (G, 7) boxes, uncapped


class Frames:
    """The script's frame stream: one Generator (default_rng(0)), drawn by
    `batch(n)` in the script's order."""

    def __init__(self, config, class_name: str = "Car",
                 yaw_limit: float = np.pi / 2):
        self.config = config
        self.class_name = class_name
        self.yaw_limit = yaw_limit
        self.rng = np.random.default_rng(0)

    def batch(self, n: int) -> Batch:
        data = self.config.data
        pts = np.zeros((n, data.max_points, 4), np.float32)
        nums = np.zeros((n,), np.int32)
        gts = np.zeros((n, data.max_gt_boxes, 7), np.float32)
        masks = np.zeros((n, data.max_gt_boxes), bool)
        raw_gts = []
        for i in range(n):
            p, b = synth_frame(self.rng, class_name=self.class_name,
                               yaw_limit=self.yaw_limit)
            p = p[self.rng.permutation(len(p))]
            m = min(len(p), data.max_points)
            pts[i, :m] = p[:m]
            nums[i] = m
            g = min(len(b), data.max_gt_boxes)
            gts[i, :g] = b[:g]
            masks[i, :g] = True
            raw_gts.append(b)
        return Batch(pts, nums, gts, masks, raw_gts)


def make_optimizer(config, lr: float, steps: int,
                   lr_drop_at: float | None = None) -> ClippedSGD:
    """`chain(clip_by_global_norm(train.gradient_clip), sgd(lr,
    momentum=0.9))`, the LR dropping 10x at int(steps * lr_drop_at)."""
    drops = ({int(steps * lr_drop_at): 0.1} if lr_drop_at is not None
             else None)
    return ClippedSGD(config, momentum=MOMENTUM,
                      schedule=piecewise_constant_schedule(lr, drops))


class TrainResult(NamedTuple):
    state: object        # training/train_step.TrainState
    log: list            # (step, loss, cls_loss, reg_loss, seconds)
    seconds: float       # the step loop, device work included


def load_init_weights(config, path: str):
    """The model of a `convert.save_npz` file of JAX variables. Refused
    when the decode knobs it was saved with are not `config`'s, or when a
    tensor's name or shape does not fit the model of `config`; a file
    without knobs loads with `convert.load_npz`'s warning."""
    from voxelnet_tpu_torch import convert
    from voxelnet_tpu_torch.models.voxelnet import build_model

    variables = convert.load_npz(path, config)
    want = json.loads(json.dumps(convert.decode_knobs(config.to_dict())))
    if variables["meta"] is not None and variables["meta"] != want:
        diff = sorted(k for k in want if variables["meta"].get(k) != want[k])
        raise ValueError(f"{path} was saved for another config: its decode "
                         f"knobs differ from the run's in {diff}")
    model = build_model(config)
    try:
        model.load_state_dict(convert.from_jax_variables(variables))
    except RuntimeError as e:
        raise ValueError(f"{path} does not fit the run's model: {e}") from e
    return model


def train(config, frames: Frames, optimizer: ClippedSGD, *, steps: int,
          num_frames: int = 128, batch: int = 4, fresh_frames: bool = False,
          device="cuda", init_seed: int = 0, init_weights: str | None = None,
          log_every: int = 50, echo=print) -> TrainResult:
    """`steps` train steps from a random init (`init_seed`), or from the
    weights of `init_weights` (a .npz, see load_init_weights): over the
    num_frames // batch batches drawn first and uploaded once, cycled, or
    over a fresh batch every step. Every `log_every` steps the losses are
    read back, logged and echoed."""
    from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                        make_train_step)

    device = torch.device(device)
    model = (load_init_weights(config, init_weights) if init_weights
             else None)
    state = create_train_state(config, model, seed=init_seed, device=device,
                               optimizer=optimizer)
    step = make_train_step(config, device, optimizer=optimizer)

    def upload(b: Batch) -> dict:
        return {k: torch.as_tensor(getattr(b, k), device=device) for k in
                ("points", "num_points", "gt_boxes", "gt_mask")}

    fixed = ([] if fresh_frames else
             [upload(frames.batch(batch)) for _ in range(num_frames // batch)])
    log = []
    t0 = time.perf_counter()
    for it in range(steps):
        b = upload(frames.batch(batch)) if fresh_frames else \
            fixed[it % len(fixed)]
        state, metrics = step(state, b)
        if (it + 1) % log_every == 0:
            loss, cls, reg = torch.stack(
                [metrics[k].detach().to(torch.float64) for k in
                 ("loss", "cls_loss", "reg_loss")]).tolist()
            log.append((it + 1, loss, cls, reg, time.perf_counter() - t0))
            echo(f"step {it + 1}: loss {loss:.4f} cls {cls:.4f} "
                 f"reg {reg:.4f} ({log[-1][-1]:.0f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return TrainResult(state, log, time.perf_counter() - t0)


class EvalFrame(NamedTuple):
    pred_lines: list[str]   # KITTI label lines with scores
    gt_lines: list[str]
    num_det: int
    num_gt: int


def evaluate(config, model, frames: Frames, *, eval_frames: int = 24,
             batch: int = 4, device="cuda") -> list[EvalFrame]:
    """Detect on eval_frames // batch fresh batches through
    make_inference_fn, and emit each frame's detections and ground truth
    as KITTI label lines."""
    from voxelnet_tpu_torch.models.voxelnet import make_inference_fn
    from voxelnet_tpu_torch.utils import kitti

    infer = make_inference_fn(config, device)
    name = frames.class_name
    out = []
    for _ in range(eval_frames // batch):
        b = frames.batch(batch)
        det = infer(model, b.points, b.num_points)
        boxes, scores, valid = (t.cpu().numpy() for t in det)
        for i in range(batch):
            pb, ps = boxes[i][valid[i]], scores[i][valid[i]]
            gb = b.raw_gts[i]
            out.append(EvalFrame(
                kitti.boxes_to_label_lines(pb, [name] * len(pb), scores=ps,
                                           coordinate="lidar"),
                kitti.boxes_to_label_lines(gb, [name] * len(gb),
                                           coordinate="lidar"),
                len(pb), len(gb)))
    return out


def score(eval_frames: list[EvalFrame], class_name: str) -> dict:
    """{'AP@<iou> <mode>': moderate AP} for IoU 0.5 and 0.7, BEV and 3D,
    of the frames' label lines, as `cli.eval` scores them."""
    from voxelnet_tpu_torch.cli.eval import frame_from_lines
    from voxelnet_tpu_torch.training.evaluate import evaluate_ap

    frames = [frame_from_lines(f.pred_lines, f.gt_lines, class_name)
              for f in eval_frames]
    return {f"AP@{iou} {mode}": evaluate_ap(
        frames, iou_thresh=iou, mode=mode,
        difficulties=("moderate",))["moderate"]
        for iou in (0.5, 0.7) for mode in ("bev", "3d")}


def dump_labels(eval_frames: list[EvalFrame], out_dir: str):
    """Write the frames' label lines as DIR/preds/data/NNNNNN.txt and
    DIR/gt/NNNNNN.txt -> (preds dir, gt dir)."""
    preds_dir = os.path.join(out_dir, "preds", "data")
    gt_dir = os.path.join(out_dir, "gt")
    os.makedirs(preds_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for i, f in enumerate(eval_frames):
        for d, lines in ((preds_dir, f.pred_lines), (gt_dir, f.gt_lines)):
            with open(os.path.join(d, f"{i:06d}.txt"), "w") as fh:
                fh.write("".join(lines))
    return preds_dir, gt_dir


def score_dumps(preds_dir: str, gt_dir: str, class_name: str,
                echo=print) -> dict:
    """{'AP@<iou> <mode>': moderate AP} of the dumped files through the
    port's cli.eval (its JSON, echoed)."""
    from voxelnet_tpu_torch.cli import eval as eval_cli

    out = {}
    for iou in (0.5, 0.7):
        for mode in ("bev", "3d"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                eval_cli.main(["--preds", preds_dir, "--gt", gt_dir,
                               "--class-name", class_name, "--iou", str(iou),
                               "--mode", mode])
            result = json.loads(buf.getvalue())
            echo(json.dumps(result))
            out[f"AP@{iou} {mode}"] = result["AP_moderate"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--eval-frames", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--lr-drop-at", type=float, default=None,
                    help="fraction of --steps at which the LR drops 10x; "
                         "default no drop")
    ap.add_argument("--score-thres", type=float, default=0.5,
                    help="inference score gate of the held-out eval "
                         "(rpn.score_thres)")
    ap.add_argument("--yaw-encoding", default="delta",
                    choices=("delta", "sin"), help="train.yaw_encoding")
    ap.add_argument("--yaw-limit", type=float, default=np.pi / 2,
                    help="scene yaw band (see synth_frame)")
    ap.add_argument("--fresh-frames", action="store_true",
                    help="a fresh batch every step instead of cycling "
                         "--frames fixed frames")
    ap.add_argument("--save-checkpoint", type=str, default=None,
                    help="write the port's checkpoint here (read by "
                         "cli.predict --checkpoint)")
    ap.add_argument("--save-frame", type=str, default=None,
                    help="write one eval frame's points as a KITTI .bin")
    ap.add_argument("--class-name", default="Car",
                    choices=("Car", "Pedestrian", "Cyclist"))
    ap.add_argument("--dump-labels", type=str, default=None,
                    help="write the held-out predictions and GT as KITTI "
                         "label files under this dir and score them "
                         "through cli.eval")
    ap.add_argument("--device", default="cuda",
                    help="cuda, cuda:N or cpu")
    init = ap.add_mutually_exclusive_group()
    init.add_argument("--init-seed", type=int, default=0,
                      help="seed of the weight initialisation only")
    init.add_argument("--init-weights", type=str, default=None,
                      help="start from the JAX variables of this .npz "
                           "(convert.save_npz, with the run's decode "
                           "knobs) instead of a random init")
    ap.add_argument("--cfg", type=str, default=None,
                    help="YAML override file merged over the run's config")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device")
    if args.device.startswith("cuda"):
        name = torch.cuda.get_device_name(torch.device(args.device))
        print(f"device: {name}", flush=True)
    cfg = make_config(args.class_name, args.score_thres, args.yaw_encoding,
                      args.cfg)
    frames = Frames(cfg, args.class_name, args.yaw_limit)
    optimizer = make_optimizer(cfg, args.lr, args.steps, args.lr_drop_at)
    run = train(cfg, frames, optimizer, steps=args.steps,
                num_frames=args.frames, batch=args.batch,
                fresh_frames=args.fresh_frames, device=args.device,
                init_seed=args.init_seed, init_weights=args.init_weights)
    print(f"trained {args.steps} steps in {run.seconds:.1f}s "
          f"({args.steps / run.seconds:.3f} steps/s)", flush=True)

    if args.save_checkpoint:
        from voxelnet_tpu_torch.training.checkpoint import CheckpointManager

        CheckpointManager(args.save_checkpoint, config=cfg).save(
            run.state.step, run.state)
        print(f"checkpoint saved to {args.save_checkpoint}", flush=True)
    if args.save_frame:
        p, _ = synth_frame(np.random.default_rng(123),
                           class_name=args.class_name)
        p.astype(np.float32).tofile(args.save_frame)
        print(f"frame saved to {args.save_frame}", flush=True)

    held_out = evaluate(cfg, run.state.model, frames,
                        eval_frames=args.eval_frames, batch=args.batch,
                        device=args.device)
    ap_in = score(held_out, args.class_name)
    for iou in (0.5, 0.7):
        print(f"AP@{iou} BEV: {ap_in[f'AP@{iou} bev']:.3f}  "
              f"3D: {ap_in[f'AP@{iou} 3d']:.3f}", flush=True)
    losses = [row[1] for row in run.log]
    print(f"detections: {sum(f.num_det for f in held_out)}, "
          f"gt: {sum(f.num_gt for f in held_out)}, loss first->last: "
          + (f"{losses[0]:.3f} -> {losses[-1]:.3f}" if losses else "none"),
          flush=True)
    result = {"steps": args.steps, "seconds": run.seconds,
              "steps_per_s": args.steps / run.seconds, "log": run.log,
              "ap": ap_in}
    if args.dump_labels:
        preds_dir, gt_dir = dump_labels(held_out, args.dump_labels)
        print(f"-- cli.eval over {args.dump_labels}:", flush=True)
        result["ap_cli"] = score_dumps(preds_dir, gt_dir, args.class_name)
    return result


if __name__ == "__main__":
    main()
