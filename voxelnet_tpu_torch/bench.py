"""Benchmark of the port: KITTI frames/sec on one card, stage by stage.

    python -m voxelnet_tpu_torch.bench        # Car inference, B=8
    python -m voxelnet_tpu_torch.bench --stage middle --middle-backend sparse1
    python -m voxelnet_tpu_torch.bench --stage train --host-voxelize
    python -m voxelnet_tpu_torch.bench --stage infer --batch 1 --repeats 5

The port's counterpart of the JAX package's `bench.py`, with its stages,
flags, frames, timing and output. Each stage adds one layer of the
detector, on the card (`--device cuda`, the default; `--device cpu` runs
the kernels' plain versions, for rehearsals at a small config):

  vfe     - sort + run analysis (ops/voxelize.prepare) and the fused voxel
            table + VFE kernel (`vfe_fused`), the BN folded as inference
            folds it; with compat.bn_over_padding the run-copy table and
            the table VFE instead
  dense   - + the dense grid (`dense_build`)
  middle  - + the Conv3D middle stack on the inference copy of the model
            (BN folded, weights cast); under middle_backend='sparse1'
            block 1 from the voxel table instead (the occupancy map and
            `sparse_conv`), with no dense grid
  infer   - make_inference_fn, the whole graph to rotated-BEV NMS (its
            host syncs included)
  train   - one make_train_step step (run-copy table, targets, forward,
            loss, backward, clip + SGD), one GT box a frame;
            --host-targets feeds TargetPrecomputer maps, --host-voxelize
            voxel tables built on the host (voxelize_np) before timing
  targets - target assignment and its maps alone, 8 GT boxes a frame

Every lowering flag goes into the config, or to the stage function, where
the JAX bench puts it, and the config goes through `resolve_plan` (the
train stage's with train=True), which maps each lowering to the port's one
path or refuses it; the metric label names the path that ran, e.g.
`middle[conv3d]` for `--middle-backend wpack`. `--host-voxelize` also sets
train.host_voxelize, so that the resolver refuses it with `--vfe-backend
planar` as it refuses that config.

Timing: one warm-up call, then `--repeats` chains of ITERS calls by wall
clock, each call fed the previous one's zero-valued result (`salt`), with
one host read at the end of a chain and no sync between calls. Prints ONE
JSON line:

  {"metric": ..., "value": fps, "unit": "frames/sec/chip", "vs_baseline":
   x, "repeats": n, "spread": max - min, "runs": [...], "card": ...}

`vs_baseline` (inference only) is against the reference's torch-CPU
figure recorded in BASELINE.md; `card` is the card's name and power limit
as nvidia-smi gives them ("cpu" under --device cpu).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from voxelnet_tpu_torch.config import (VoxelNetConfig, get_config,
                                       resolve_plan)
from voxelnet_tpu_torch.kernels.sparse_conv import occupancy_map
from voxelnet_tpu_torch.models.scatter import scatter_to_dense_streamed
from voxelnet_tpu_torch.models.voxelnet import (build_model,
                                                make_inference_fn,
                                                prepare_for_inference)
from voxelnet_tpu_torch.ops import targets as targets_ops
from voxelnet_tpu_torch.ops.anchors import anchors_flat
from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec, in_grid_mask,
                                             prepare, voxelize_np,
                                             voxelize_table)
from voxelnet_tpu_torch.tools.card import card_line
from voxelnet_tpu_torch.training.optim import make_optimizer
from voxelnet_tpu_torch.training.train_step import (_device,
                                                    create_train_state,
                                                    make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_baseline_fps(path: str = os.path.join(REPO, "BASELINE.md")):
    """The reference's torch-CPU inference frames/s, from the
    `<!-- baseline_fps=... -->` line of BASELINE.md; None without one."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("<!-- baseline_fps="):
                    return float(
                        line.split("=")[1].split(" ")[0].rstrip("->\n "))
    except OSError:
        pass
    return None


BASELINE_FPS = read_baseline_fps()

# the reference checkout's raw drive, where VOXELNET_REFERENCE_DIR names
# the checkout; without it the vendored frames (data/sample.py)
_REFERENCE = os.environ.get("VOXELNET_REFERENCE_DIR")
DATA_GLOB = (os.path.join(_REFERENCE, "data", "2011_09_26", "*",
                          "velodyne_points", "data", "*.bin")
             if _REFERENCE else None)
BATCH = 8   # the port's recorded inference batch (PERF.md §2)
ITERS = 20
STAGE_NAMES = ("vfe", "dense", "middle", "infer", "train", "targets")
# one Car-sized box at 20 m ahead: the train stage's GT (slot 0), the
# targets stage's (slots 0-7)
GT_BOX = (20.0, 0.0, -1.0, 1.56, 1.6, 3.9, 0.3)


def load_frames(max_points: int, batch: int, spec=None):
    """Frames prepared exactly like the data pipeline: grid crop (when
    data.crop_to_grid; every in-grid point kept), shuffle, cap. batch * 4
    clouds: the files of DATA_GLOB, else the vendored frames tiled, else
    synthetic 110k-point clouds -> [(points (batch, max_points, 4) f32,
    num_points (batch,) i32)]."""
    files = sorted(glob.glob(DATA_GLOB)) if DATA_GLOB else []
    rng = np.random.default_rng(0)
    clouds = []
    if files:
        for f in files[: batch * 4]:
            clouds.append(np.fromfile(f, np.float32).reshape(-1, 4))
    else:
        from voxelnet_tpu_torch.data.sample import sample_frames

        base = sample_frames()
        if base:
            clouds = [base[i % len(base)] for i in range(batch * 4)]
        else:
            for _ in range(batch * 4):
                n = 110_000
                clouds.append(np.concatenate([
                    rng.uniform([0, -40, -3], [70.4, 40, 1], (n, 3)),
                    rng.uniform(0, 1, (n, 1))], axis=1).astype(np.float32))

    batches = []
    for start in range(0, len(clouds) - batch + 1, batch):
        pts = np.zeros((batch, max_points, 4), np.float32)
        nums = np.zeros((batch,), np.int32)
        for i, pcl in enumerate(clouds[start:start + batch]):
            if spec is not None:
                pcl = pcl[in_grid_mask(pcl, spec)]
            pcl = pcl[rng.permutation(len(pcl))]
            n = min(len(pcl), max_points)
            pts[i, :n] = pcl[:n]
            nums[i] = n
        batches.append((pts, nums))
    return batches


class Stage(NamedTuple):
    """fn(*inputs): the stage's result (the vfe stage's voxelwise
    features, the dense grid, the BEV map, Detections, the train step's
    metrics, the target maps; the infer and train stages take a `marks`
    list after the inputs, which records their spans);
    chained(*inputs, salt) -> 0-d tensor: the same work on the first
    input plus salt, its result summed times 0;
    prep(points, num_points): one host batch -> the host arrays that fn
    and chained take."""

    fn: Callable
    chained: Callable
    label: str
    prep: Callable


def _points_only(points, num_points):
    return points, num_points


def stage_label(stage: str, config: VoxelNetConfig,
                host_targets: bool = False,
                host_voxelize: bool = False) -> str:
    """The JAX bench's metric label of `stage`, with the port's path in
    place of the lowering that the flags asked for."""
    cls = config.object.name
    middle = resolve_plan(config, train=stage == "train").middle
    vfe = ("run_copy+table VFE" if config.compat.bn_over_padding
           else "vfe_fused")
    grid = ("occupancy_map+sparse_conv" if middle == "sparse1"
            else "dense_build")
    if stage == "vfe":
        return f"KITTI frames/sec/chip ({cls}, voxelize+VFE [{vfe}])"
    if stage == "dense":
        return (f"KITTI frames/sec/chip ({cls}, voxelize+VFE+dense grid "
                f"[{vfe}, dense_build])")
    if stage == "middle":
        return (f"KITTI frames/sec/chip ({cls}, voxelize+VFE+dense+"
                f"middle[{middle}] [{vfe}, {grid}])")
    if stage == "infer":
        return (f"KITTI frames/sec/chip ({cls}, inference, full graph incl. "
                f"voxelize+rotated-NMS [{vfe}, {grid}, middle[{middle}]])")
    if stage == "train":
        if host_voxelize:
            kind = ("host voxels+targets" if host_targets
                    else "host voxels, on-device targets")
        else:
            kind = ("host-precomputed targets" if host_targets
                    else "on-device targets")
        voxelizer = "host" if host_voxelize else "run_copy"
        return (f"KITTI frames/sec/chip ({cls}, training step, {kind}+grads+"
                f"SGD [voxelizer[{voxelizer}], middle[{middle}], "
                f"remat[{config.train.remat}]])")
    if stage == "targets":
        return (f"KITTI frames/sec/chip ({cls}, on-device target "
                "assignment only)")
    raise SystemExit(f"unknown stage {stage!r}")


def make_stage_fn(stage: str, config: VoxelNetConfig,
                  host_targets: bool = False, vfe_backend: str = "xla",
                  host_voxelize: bool = False, dense_build: str = "scatter",
                  *, device="cuda", batch: int = BATCH,
                  model=None) -> Stage:
    """The Stage of `stage` on `device`, for batches of `batch` frames.

    `model`: the VoxelNet to run (default build_model(config, seed=0));
    the train stage trains it in place. `vfe_backend` ('xla', 'fused' or
    'planar') and `dense_build` ('scatter' or 'pallas') are the JAX
    bench's stage arguments: every value runs the port's one VFE and grid
    (resolve_plan), so they select nothing here. Raises where the config's
    lowering is refused, or for 'cuda' without a card."""
    device = _device(device)
    plan = resolve_plan(config, train=stage == "train")
    label = stage_label(stage, config, host_targets, host_voxelize)
    model = build_model(config, seed=0) if model is None else model
    dtype = getattr(torch, plan.dtype)
    obj = config.object
    spec = VoxelGridSpec.from_object_config(obj)
    max_voxels = config.data.max_voxels

    if stage == "infer":
        infer = make_inference_fn(config, device)
        model = model.to(device)

        def fn(points, num_points, marks=None):
            return infer(model, points, num_points, marks)

        def chained(points, num_points, salt):
            return infer(model, points + salt, num_points).scores.sum() * 0.0

        return Stage(fn, chained, label, _points_only)

    if stage in ("vfe", "dense", "middle"):
        net = prepare_for_inference(model.to(device), plan.fold_bn, dtype,
                                    plan.middle)
        grid = tuple(obj.grid_size)

        @torch.inference_mode()
        def fn(points, num_points):
            if config.compat.bn_over_padding:
                vox = voxelize_table(points, num_points, spec, max_voxels)
                vw = net.feature_net.table(vox.features, vox.counts, dtype)
                coords, counts = vox.coords, vox.counts
            else:
                prep = prepare(points, num_points, spec, max_voxels)
                vw = net.feature_net(prep)
                coords, counts = prep.coords, prep.counts
            if stage == "vfe":
                return vw
            if plan.middle == "sparse1" and stage == "middle":
                # block 1 reads the voxel table; no dense grid is built
                occ = occupancy_map(coords, counts, grid)
                return net.middle.from_table(vw.to(dtype), coords, counts,
                                             occ)
            dense = scatter_to_dense_streamed(vw, coords, counts, grid)
            if stage == "dense":
                return dense
            return net.middle(dense.to(dtype))

        @torch.inference_mode()
        def chained(points, num_points, salt):
            return fn(points + salt, num_points).sum().float() * 0.0

        return Stage(fn, chained, label, _points_only)

    if stage == "train":
        optimizer = make_optimizer(config, steps_per_epoch=100)
        state = create_train_state(config, model, device=device,
                                   optimizer=optimizer)
        step = make_train_step(config, device, optimizer=optimizer)
        gt = np.zeros((batch, config.data.max_gt_boxes, 7), np.float32)
        gt[:, 0] = GT_BOX
        gt_mask = np.zeros((batch, config.data.max_gt_boxes), bool)
        gt_mask[:, 0] = True
        extra = {"gt_boxes": torch.as_tensor(gt, device=device),
                 "gt_mask": torch.as_tensor(gt_mask, device=device)}
        if host_targets:
            maps = targets_ops.TargetPrecomputer(config)(
                {"gt_boxes": gt, "gt_mask": gt_mask})
            for k in ("target_pos", "target_neg", "target_reg"):
                extra[k] = torch.as_tensor(maps[k], device=device)

        if host_voxelize:
            def prep(pts, nums):
                feats, crds, cnts = [], [], []
                for b in range(len(pts)):
                    vox = voxelize_np(pts[b, : nums[b]], spec,
                                      max_voxels=max_voxels)
                    feats.append(vox.features)
                    crds.append(vox.coords)
                    cnts.append(vox.counts)
                return (np.stack(feats), np.stack(crds),
                        np.stack(cnts).astype(np.int32))

            def fn(features, coords, counts, marks=None):
                return step(state, {"voxel_features": features,
                                    "voxel_coords": coords,
                                    "voxel_counts": counts, **extra},
                            marks)[1]
        else:
            prep = _points_only

            def fn(points, num_points, marks=None):
                return step(state, {"points": points,
                                    "num_points": num_points, **extra},
                            marks)[1]

        def chained(first, *rest_and_salt):
            *rest, salt = rest_and_salt
            return fn(first + salt, *rest)["loss"] * 0.0

        return Stage(fn, chained, label, prep)

    if stage == "targets":
        gt = np.zeros((batch, config.data.max_gt_boxes, 7), np.float32)
        gt[:, :8] = GT_BOX
        gt_mask = np.zeros((batch, config.data.max_gt_boxes), bool)
        gt_mask[:, :8] = True
        gt = torch.as_tensor(gt, device=device)
        gt_mask = torch.as_tensor(gt_mask, device=device)
        anchors = torch.from_numpy(anchors_flat(obj)).to(device)
        standup = torch.from_numpy(targets_ops.anchor_standup_np(
            obj, buggy=config.compat.buggy_anchor_standup)).to(device)

        @torch.inference_mode()
        def maps(gt_boxes):
            return targets_ops.targets_to_maps(targets_ops.assign_targets(
                gt_boxes, gt_mask, anchors, standup, pos_iou=obj.rpn_pos_iou,
                neg_iou=obj.rpn_neg_iou, anchor_h=obj.anchor_h,
                iou_plus_one=config.compat.iou_plus_one,
                yaw_mode=config.train.yaw_encoding),
                (obj.feature_height, obj.feature_width))

        def fn(points, num_points):
            """The stage's GT boxes' maps (pos, neg, reg); the frames are
            not read."""
            return maps(gt)

        @torch.inference_mode()
        def chained(points, num_points, salt):
            pos, _, reg = maps(gt + salt * 0.0)
            return (pos.sum() + reg.sum()) * 0.0 + salt * 0.0

        return Stage(fn, chained, label, _points_only)

    raise SystemExit(f"unknown stage {stage!r}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="infer", choices=STAGE_NAMES)
    ap.add_argument("--middle-backend", default=None,
                    choices=("auto", "conv3d", "folded2d", "tap2d",
                             "sparse1", "sparsebwd", "wpack", "wpack2"),
                    help="override data.middle_backend: 'sparse1' computes "
                         "block 1 from the voxel table; every other value "
                         "runs the Conv3D middle (resolve_plan)")
    ap.add_argument("--voxelizer-backend", default=None,
                    choices=("auto", "xla", "gather", "pallas", "planar"),
                    help="override data.voxelizer_backend (train stage); "
                         "every value runs the run-copy table kernel")
    ap.add_argument("--class-name", default="Car",
                    choices=("Car", "Pedestrian", "Cyclist"))
    ap.add_argument("--host-targets", action="store_true",
                    help="train stage: feed host-precomputed target maps "
                         "(the trainer's path)")
    ap.add_argument("--host-voxelize", action="store_true",
                    help="train stage: feed host-voxelized tables "
                         "(train.host_voxelize); the run-copy table drops "
                         "out of the step")
    ap.add_argument("--vfe-backend", default="xla",
                    choices=("xla", "fused", "planar"),
                    help="vfe/dense/middle stages: every value runs the "
                         "fused VFE kernel; train stage: 'planar' sets "
                         "data.train_vfe_backend, which runs the run-copy "
                         "table")
    ap.add_argument("--dense-build", default="scatter",
                    choices=("scatter", "pallas"),
                    help="dense/middle stages: every value runs the "
                         "dense_build kernel")
    ap.add_argument("--remat", default=None,
                    choices=("none", "seams", "full"),
                    help="train stage: override train.remat")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"frames a batch (default {BATCH})")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repetitions; value = mean, spread = "
                         "max-min across runs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default), or the CPU, where the kernels' "
                         "plain versions run")
    args = ap.parse_args(argv)
    if args.batch is not None and args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    return args


def stage_config(args: argparse.Namespace) -> VoxelNetConfig:
    """The config of a run: the class preset with the flags' lowering
    values where the JAX bench puts them, checked by resolve_plan."""
    data_over = {}
    if args.middle_backend is not None:
        data_over["middle_backend"] = args.middle_backend
    if args.voxelizer_backend is not None:
        data_over["voxelizer_backend"] = args.voxelizer_backend
    if args.stage == "train" and args.vfe_backend == "planar":
        data_over["train_vfe_backend"] = "planar"
    overrides = {"data": data_over} if data_over else {}
    train_over = {}
    if args.remat is not None:
        train_over["remat"] = args.remat
    if args.stage == "train" and args.host_voxelize:
        train_over["host_voxelize"] = True
    if train_over:
        overrides["train"] = train_over
    config = get_config(args.class_name, **overrides)
    resolve_plan(config, train=args.stage == "train")
    return config


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = _device(args.device)
    batch = BATCH if args.batch is None else args.batch
    config = stage_config(args)
    stage = make_stage_fn(args.stage, config, args.host_targets,
                          args.vfe_backend, args.host_voxelize,
                          args.dense_build, device=device, batch=batch)
    card = card_line() if device.type == "cuda" else "cpu"

    crop_spec = (VoxelGridSpec.from_object_config(config.object)
                 if config.data.crop_to_grid else None)
    batches = load_frames(config.data.max_points, batch, spec=crop_spec)
    dev_batches = [tuple(torch.as_tensor(a, device=device)
                         for a in stage.prep(p, n)) for p, n in batches]

    def zero():
        return torch.zeros((), device=device)

    # a zero-valued salt chains every call on the one before, so the
    # device runs them in turn and ONE host read closes the chain
    salt = stage.chained(*dev_batches[0], zero())
    float(salt)  # warm-up: first launches, the inference BN fold

    fps_runs = []
    for _ in range(max(1, args.repeats)):
        salt = zero()
        t0 = time.perf_counter()
        for i in range(ITERS):
            salt = stage.chained(*dev_batches[i % len(dev_batches)], salt)
        float(salt)  # forces the whole chain
        elapsed = time.perf_counter() - t0
        fps_runs.append(batch * ITERS / elapsed)

    fps = float(np.mean(fps_runs))
    result = {
        "metric": stage.label,
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "vs_baseline": (round(fps / BASELINE_FPS, 2)
                        if BASELINE_FPS and args.stage == "infer" else None),
        "repeats": len(fps_runs),
        "spread": round(float(np.max(fps_runs) - np.min(fps_runs)), 2),
        "runs": [round(v, 2) for v in fps_runs],
        "card": card,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
