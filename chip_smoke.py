"""Drive the PyTorch port's Car inference path, train step, trainer, data
parallelism, learning run, viz, data tools, sparse1, spatial W-sharding,
bench, profile tool and root entry points on one NVIDIA GPU, and hold its
Car detections against the JAX package's.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the four CUDA sources of voxelnet_tpu_torch/csrc/ with nvcc,
     one process each, started together;
  3. each kernel against its plain torch version at Car shapes (B=2,
     vendored frames): the fused VFE (>= 99.9% of elements bit-equal, the
     rest within 2**-7 relative), the dense-grid build in bf16 and f32 and
     its gradient (bit-equal), the run-copy voxel table (bit-equal, also on
     a crowded frame); the time of each, of its plain version and, for
     the run-copy, of one torch.gather call, as the median over 5 windows
     of one CUDA-event pair around 50 back-to-back calls, beside the
     device time of the kernels those calls launch (torch.profiler); the
     fused VFE also at the inference B=8 batch, and the dense grid's
     backward gather alone;
  4. the inference main path through cli.predict on the 3 vendored frames
     at full Car width (grid 10x400x352, max_points 65536, max_voxels
     16384, bf16, random init from a seed with random BN statistics), at
     score_thres 0.96 and 0.0; kernel launch counts read around that run;
     then the same path at a tiny grid in f32 on the card against the CPU;
     then per-stage and end-to-end CUDA-event times at B=1 and B=8, and a
     torch.profiler kernel table of one call at each, whose parsed op
     total must equal the profiler's own device total within PARSER_REL;
  5. the train path: make_train_step at full Car width (bf16, B=2, 64 GT
     slots) through several steps on one batch of vendored frames with
     seeded synthetic Car boxes; every metric finite and the loss falling;
     launch counts of the run-copy and dense-grid kernels read around
     those steps; one step at the tiny f32 grid on the card against the
     CPU; CUDA-event step times with the stage split and peak memory at
     B=2 and B=8, and a profiler kernel table of one step at B=8;
  6. the trainer at full Car width: a mini KITTI tree in a temporary
     directory (the vendored frames written several times, label files of
     5 seeded synthetic Car boxes per frame, no calib); cli.train for 2
     epochs (Car preset, B=2), then --resume to 3 epochs in the same exp
     dir, cli.eval over the last epoch's label dumps and cli.predict
     --checkpoint on one frame; checks the exp dir layout, the resumed
     epoch and step count, finite metrics, valid JSON and the launch
     counts; then one epoch at B=8 over 72 frames through a Trainer:
     frames/s by wall clock, the median host gap between steps, the
     checkpoint save and val-dump times, and the device's idle share over
     a torch.profiler window of a second epoch;
  7. data parallel, workers of this script (`--dp-worker`) in a process
     group: (a) two ranks on cuda:0 over gloo (NCCL refuses two ranks on
     one card) at full Car width, bf16, global B=4 (2 a rank), 3 steps of
     make_train_step: step 1's loss and pre-clip grad norm against one
     process at B=4 on the card, every metric finite, the ranks'
     parameters bit-identical after step 3, the run-copy and dense-grid
     launch counts of each rank, the all-reduces of a step and their
     bytes, the gloo all-reduce's time; (b) the same step at the tiny f32
     grid against one process; (c) `torch.distributed.run --nproc_per_node
     2 -m voxelnet_tpu_torch.cli.train --dist-backend gloo --device cuda:0`
     for one epoch on phase 6's KITTI tree: the exp dir, one checkpoint,
     label dumps of every val frame, cli.eval over them; (d) where torch
     sees two cards or more, NCCL over two cards at Car B=8 a card: step
     time and frames/s a card beside phase 5's one-card step (otherwise it
     says it did not run);
  8. the slice of the optimizer choice, the host voxelizer and the ghost
     VFE: (a) the synthetic learning run through
     voxelnet_tpu_torch/tools/synthetic_smoke.py's functions: Car, momentum
     SGD, 300 steps at B=4 over 32 fixed frames, then 24 held-out frames
     through make_inference_fn: every logged loss finite, the last below
     half the first, cli.eval over the label dumps equal to the in-process
     AP, run_copy launched every step and vfe_fused and dense_build at
     eval; steps/s and AP@0.5/0.7, BEV and 3D; (b) the native host
     voxelizer, built with the host C++ compiler (printed), bit-equal to
     voxelize_np on the 3 vendored frames at the full Car grid, both
     voxelizers' host frames/s, and one Trainer epoch with
     train.host_voxelize on phase 6's tree: metrics finite, run_copy not
     launched; (c) compat.bn_over_padding inference, Car B=2: run_copy and
     dense_build launched, vfe_fused not, and the tiny f32 grid on the card
     against the CPU;
  9. the slice of the viz, the data tools and the reference-named API:
     (a) reference_api at full Car width: pcl_to_voxels on a vendored
     frame equal to voxelize_np, RPN3D + make_inference_fn on the 3 frames
     at score_thres 0.0 (detections; vfe_fused and dense_build launched),
     and generate_targets (masks
     exact, targets within 1e-5), deltas_to_boxes_3d (1e-4 m), nms (100
     detections equal by score and box) and smooth_L1_loss (1e-6) on the
     card against their CPU run; (b) one Trainer epoch, Car B=2, on phase
     6's tree with 375x1242 camera PNGs (written by utils/image_io.py) and
     KITTI calib files added, num_vis_dump=2, train.augment with
     compat.raster_collision: the two triplets exist and decode, metrics
     finite, run_copy and dense_build launched, cv2 never imported; the
     host ms a frame of the augmentation with the raster check and with
     the exact IoU; (c) data.raw_to_kitti on a synthetic raw drive, then
     cli.train for one epoch on its output: finite metrics, a checkpoint,
     a label dump of every val frame, run_copy and dense_build launched;
 10. the slice of `data.middle_backend='sparse1'` (block 1 from the voxel
     table): (a) the occupancy kernel and both sparse-conv kernels
     against their plain versions at Car B=2 and at B=8, the batch of
     inference and of the train step (8 vendored frames, cycled), fed
     by the fused VFE: the map bit-equal, the forward bit-equal in bf16
     and f32, on the whole W and a W window (equal to a slice of the full
     output), with its ReLU epilogue off and on (and the fused ReLU equal
     to the ReLU of the unfused output), the gradient bit-equal; the
     forward kernel's registers, shared memory and resident blocks; their
     times, plain times (the sums over 5 calls a window), bounds and share
     of the bound, with cuDNN's Conv3d of the dense grid at the same batch
     (and the dense_build time beside it at B=2) as the forward's one-call
     yardstick, one index_select as the gradient's, a fill and one
     index_put_ (held equal to the map) as the occupancy map's, and the
     product's time; the occupancy map's host us a call beside its
     yardstick's (a host clock over back-to-back calls, no sync), and its
     device ops a call (torch.profiler): one kernel, no memset; every
     profiler time from a profile that kept each op of its calls (each
     port kernel's events equal to its launches); (b) Car inference
     with sparse1 through cli.predict and make_inference_fn: detections
     against phase 4's conv3d run by score and box, vfe_fused,
     occupancy_map and sparse_conv launched and dense_build not (block
     1's ReLU in sparse_conv's store: no pass of its own), per-stage
     times and a profiler table at B=1 and B=8, the tiny f32 grid on the
     card against the CPU; (c) the train step with
     sparse1 at Car B=8: the loss falls, run_copy, the occupancy kernel
     and both sparse kernels launched and dense_build not, step time,
     stage split and peak memory, one tiny f32 step on the card
     against the CPU; cli.train for one epoch (the Trainer) and two gloo
     ranks on cuda:0 with sparse1, their launches;
 11. the slice of spatial W-sharding (`system.num_model_shards > 1`),
     workers of this script in a process group on cuda:0 over gloo:
     (a) a 1 x 2 mesh, Car inference at full width, bf16, B=8 (phase 4's
     model and frames, score_thres 0), conv3d and sparse1:
     make_inference_fn's detections matched to one process's by score and
     box (as phase 10), the eval forward's gathered cls and reg maps
     against one process's within MAP_GATES' bf16 shares of their
     spread, each rank's launches (vfe_fused with dense_build, or with
     occupancy_map and sparse_conv), the all-reduces of a call by group
     and the median call time; (b) a 2 x 2 mesh, the Car bf16 train step
     at global B=4 (conv3d 3 steps, sparse1 2): step 1's loss and pre-clip
     grad norm against one process, the four ranks bit-identical after
     the last, launches per rank, all-reduces of a step by group; (c) the
     tiny f32 grid: the 2 x 2 step and the 1 x 2 eval maps against one
     process on the card at f32 tolerances; (d) `torchrun --nproc_per_node
     2 -m voxelnet_tpu_torch.cli.train` with `system.num_model_shards: 2`
     for one epoch on phase 6's tree: one checkpoint, one label file a val
     frame, cli.eval over them; (e) where torch sees two cards or more,
     (a) over NCCL (and (b) on four), else it says it did not run; (f)
     uneven W slabs, as (a): Car conv3d on 1 x 3 (120/120/112 columns)
     and Pedestrian sparse1 on 1 x 4 (64/64/56/56), inference B=8, and
     (c)'s tiny f32 step on 1 x 3 (24/24/16);
 12. the bench ladder: voxelnet_tpu_torch.bench.main in this process at
     full Car width, B=8, 3 timed chains of its ITERS calls, for each
     stage with conv3d (vfe, dense, middle, infer, train, targets), for
     middle, infer and train with sparse1, train with --host-voxelize and
     inference at B=1: each JSON line (printed) parses and has a positive
     value, the launch counts read around each run show the stage's
     kernels and no other (vfe: vfe_fused; dense, middle, inference:
     with dense_build; sparse1: occupancy_map and sparse_conv instead,
     its train step with run_copy and the gradient; train: run_copy and
     dense_build; --host-voxelize: dense_build alone; targets: none), and
     the inference B=8 value lies within a factor of 2 of phase 4's;
 13. the port's root tools: (a) voxelnet_tpu_torch.tools.profile_step.main
     in this process, Car B=8, 3 traced iterations, for inference (conv3d
     and sparse1) and the train step: each table lists the path's port
     kernels at the launches a call of phase 12's gates (vfe_fused and
     dense_build; vfe_fused, occupancy_map and sparse_conv; run_copy and
     dense_build), named by their csrc/ source, and no other, the launch
     counts agree, the busy time is at most the op total and the host
     wall and lies within PROFILE_BUSY_REL of print_profile's busy time
     for the same graph in phase 4, 10 (b) or 5; the top 10 rows
     printed; (b) graft_entry.entry() on the card: its cls and reg maps
     against the same forward on the CPU within MAP_GATES' bf16 shares,
     vfe_fused and dense_build launched; (c) graft_entry.dryrun_multichip(4)
     and dryrun_multihost(2) with every rank on cuda:0 over gloo, each
     rank's launches;
 14. the port's detections against the JAX package's: make_model's Car
     weights (their sha256 and the staged points' checked against the
     fixture's meta.json) through make_inference_fn at full width on the
     3 vendored frames, score_thres 0, for conv3d and sparse1 in bf16 and
     f32; each run dumped as KITTI label files and compared box by box
     with the JAX package's dumps of the same setting
     (tests/fixtures/jax_car_dumps, written by tests/torch_jax_dumps.py)
     by tools/ab_compare_dumps.py at BEV IoU 0.7: each JSON line held to
     AB_GATES, one launch of each kernel of the path; then the NMS's
     candidate pick (torch.topk and the stable sort nms_bev runs) timed at
     B=8.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Exits non-zero without printing it when
torch sees no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from voxelnet_tpu_torch.cli import eval as eval_cli
from voxelnet_tpu_torch.cli import predict
from voxelnet_tpu_torch.cli import train as train_cli
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.data import augment as augment_lib
from voxelnet_tpu_torch.data.sample import sample_frames
from voxelnet_tpu_torch.kernels import (KERNELS, REPLACES, SOURCES, _build,
                                        dense_build, launch_counts,
                                        reset_launches, run_copy,
                                        source_path, sparse_conv, vfe_fused)
from voxelnet_tpu_torch.models.init import randomize_bn_
from voxelnet_tpu_torch.models.sparse_conv import weight_matrix
from voxelnet_tpu_torch.models.voxelnet import (STAGES, build_model,
                                                make_inference_fn,
                                                make_maps_fn, w_window)
from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec, prepare,
                                             resolve_host_voxelizer,
                                             voxelize_np, voxelize_table)
from voxelnet_tpu_torch.parallel import distributed
from voxelnet_tpu_torch.parallel.mesh import ProcessMesh
from voxelnet_tpu_torch.training.train_step import (TRAIN_STAGES,
                                                    create_train_state,
                                                    make_train_step)
from voxelnet_tpu_torch.tools import profile_step, synthetic_smoke
from voxelnet_tpu_torch.tools.ab_compare_dumps import compare, write_dumps
from voxelnet_tpu_torch.tools.card import (card_line, cuda_ms, device_ms,
                                           device_ops, host_us)
from voxelnet_tpu_torch.training.trainer import Trainer
from voxelnet_tpu_torch.utils import image_io, kitti

SEED = 0
TINY = {"object": {"x_max": 12.8, "y_min": -6.4, "y_max": 6.4},
        "data": {"max_points": 2048, "max_voxels": 256, "max_gt_boxes": 8},
        "train": {"compute_dtype": "float32"}, "rpn": {"score_thres": 0.0}}
SPARSE1 = {"data": {"middle_backend": "sparse1"}}
# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth, and the peak
# operation rate by the type of the operands (bf16 on the tensor cores, f32
# outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# MACs per stored point of the VFE stack: 7->16 and 32->64
VFE_FLOP_PER_POINT = 2 * (7 * 16 + 32 * 64)
TRAIN_STEPS = 8
# phase 6: mini KITTI split sizes (frames), and the B=8 timing epoch's
TRAINER_FILES = {"training": 6, "validation": 4}
TIMING_FILES = 72
# phase 7: steps of the data-parallel runs, and the timed ones of (d)
DP_STEPS = 3
DP_TIMED_STEPS = 5
DP_TIMEOUT_S = 600
# phase 8: the learning run's steps, batch, fixed and held-out frames and
# its log interval; repetitions of the host voxelizers' timing
LEARN_STEPS = 300
LEARN_BATCH = 4
LEARN_FRAMES = 32
LEARN_EVAL_FRAMES = 24
LEARN_LOG_EVERY = 10
HOST_VOX_REPS = 5
# the port's Car model: its f32 parameters, the gradient all-reduce's size
CAR_PARAMS = 6_809_392
# the PR whose design each kernel runs
DESIGN_PR = {"vfe_fused": 3, "dense_build": 1, "run_copy": 2,
             "sparse_conv": 9, "sparse_conv_grad": 8, "occupancy_map": 15}
# timed shapes beside each kernel's Car B=2 one: the fused VFE at the
# inference B=8 batch; the dense grid in f32 (train) and its backward (a
# torch gather, no kernel of the port); sparse_conv in f32, with its ReLU
# epilogue and at the inference B=8 batch (bf16 and f32), then the torch
# step of its path (the product) and the dense grid that its yardstick
# reads; the gradient and the occupancy map at B=8
EXTRA_SHAPES = {"vfe_fused": ("vfe_fused_b8",),
                "dense_build": ("dense_build_f32", "dense_build_grad"),
                "sparse_conv": ("sparse_conv_f32", "sparse_conv_relu",
                                "sparse_conv_b8", "sparse_conv_b8_f32",
                                "sparse_conv_product", "sparse_conv_grid"),
                "sparse_conv_grad": ("sparse_conv_grad_b8",),
                "occupancy_map": ("occupancy_map_b8",)}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def timed(fn, reps: int = 50) -> dict:
    """{"ms": cuda_ms(fn), "device_ms": device_ms(fn)} over the same
    number of back-to-back calls."""
    return {"ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, reps)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float = 0.0,
          dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """Least time in ms for the work on an H100 SXM, and what bounds it:
    the bytes over HBM bandwidth or the operations, on operands of
    `dtype`, over the peak rate for that type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_model(config, device):
    model = build_model(config, seed=SEED)
    randomize_bn_(model, torch.Generator().manual_seed(SEED + 1))
    return model.to(device).eval()


def compare_vfe(got, want) -> float:
    g, w = got.float(), want.float()
    equal = g == w
    frac = float(equal.float().mean())
    rel = ((g - w).abs() / w.abs().clamp_min(1e-30))[~equal]
    worst = float(rel.max()) if rel.numel() else 0.0
    print(f"  vfe_fused: {frac:.6f} of {g.numel()} elements bit-equal, "
          f"worst other {worst:.3e} relative")
    check(frac >= 0.999, f"vfe_fused: only {frac} of elements bit-equal")
    check(worst <= 2.0 ** -7, f"vfe_fused: relative error {worst} > 2**-7")
    return float((g - w).abs().max())


def crowded_frame(config, n_cells: int, device) -> torch.Tensor:
    """(1, max_points, 4) points spread evenly over `n_cells` random voxels
    of the grid: max_points / n_cells points each."""
    n_pts = config.data.max_points
    g = np.random.default_rng(SEED + 2)
    obj = config.object
    size = np.asarray([obj.x_voxel_size, obj.y_voxel_size, obj.z_voxel_size])
    lo = np.asarray([obj.x_min, obj.y_min, obj.z_min])
    cells = g.integers(0, [obj.width, obj.height, obj.depth], (n_cells, 3))
    centres = lo + (cells + 0.5) * size
    crowd = np.zeros((1, n_pts, 4), np.float32)
    crowd[0, :, :3] = (centres[np.arange(n_pts) % n_cells]
                       + g.uniform(-0.25, 0.25, (n_pts, 3)) * size)
    crowd[0, :, 3] = g.uniform(0, 1, n_pts)
    return torch.from_numpy(crowd).to(device)


def phase_kernels(config, model, frames, device, card):
    """Each kernel against its plain version at Car shapes, B=2."""
    print("[3] kernels against their plain versions (Car, B=2)")
    rng = np.random.default_rng(SEED)
    points, num = predict.stage_points(frames[:2], config, rng)
    spec = VoxelGridSpec.from_object_config(config.object)
    K, T = config.data.max_voxels, config.object.points_per_voxel
    prep = prepare(torch.from_numpy(points).to(device),
                   torch.from_numpy(num).to(device), spec, K)
    fln = model.feature_net
    w = (*vfe_fused.fold_layer(fln.vfe1.fcn, fln.vfe1.bn, 8),
         *vfe_fused.fold_layer(fln.vfe2.fcn, fln.vfe2.bn, 32))
    args = (prep.sorted_planar, prep.run_start, prep.num_voxels, prep.counts,
            *w)
    with torch.inference_mode():
        got = vfe_fused.vfe_fused(*args, T)
        want = vfe_fused.vfe_fused_plain(*args, T)
        torch.cuda.synchronize()
        print(f"  occupied voxels {prep.num_voxels.tolist()} "
              f"(raw {prep.num_voxels_raw.tolist()}), stored points "
              f"{prep.counts.sum(1).tolist()}, voxels at T={T} points: "
              f"{int((prep.counts == T).sum())}")
        vfe_err = compare_vfe(got, want)

        # crowded frames: the Car T=35 one, and one at T=100; tiles of
        # many chunks
        cp = prepare(crowded_frame(config, 1800, device), torch.tensor(
            [config.data.max_points], device=device), spec, K)
        cargs = (cp.sorted_planar, cp.run_start, cp.num_voxels, cp.counts, *w)
        full = int((cp.counts == T).sum())
        print(f"  crowded frame, T={T}: {full} voxels at T points")
        check(full > 100, "crowded case too sparse")
        vfe_err = max(vfe_err, compare_vfe(vfe_fused.vfe_fused(*cargs, T),
                                           vfe_fused.vfe_fused_plain(
                                               *cargs, T)))
        T100 = 100
        c100 = prepare(crowded_frame(config, 600, device), torch.tensor(
            [config.data.max_points], device=device),
            spec._replace(max_points_per_voxel=T100), K)
        over = int((c100.counts > 64).sum())
        print(f"  crowded frame, T={T100}: {over} voxels over 64 points, "
              f"{int((c100.counts == T100).sum())} at T points")
        check(over > 100, "crowded T=100 case too sparse")
        # and half the VFE2 channels with a negative BN scale (trained
        # models have some), where the kernel keeps the least dot product
        flip = torch.ones_like(w[3])
        flip[::2, 1] = -1
        c100args = (c100.sorted_planar, c100.run_start, c100.num_voxels,
                    c100.counts, *w[:3], w[3] * flip)
        vfe_err = max(vfe_err, compare_vfe(
            vfe_fused.vfe_fused(*c100args, T100),
            vfe_fused.vfe_fused_plain(*c100args, T100)))
        del c100, c100args

        D, H, W = config.object.grid_size
        n = D * H * W
        c = prep.coords
        ids = torch.where(prep.counts > 0, (c[..., 0] * H + c[..., 1]) * W
                          + c[..., 2], n).to(torch.int32)
        dense_err = 0.0
        for feat in (got, got.float()):
            dgot = dense_build.dense_build(feat, ids, n)
            dwant = dense_build.dense_build_plain(feat, ids, n)
            torch.cuda.synchronize()
            dense_err = max(dense_err, float(
                (dgot.float() - dwant.float()).abs().max()))
            check(torch.equal(dgot, dwant),
                  f"dense_build {feat.dtype} differs from plain")
            print(f"  dense_build {feat.dtype}: bit-equal over "
                  f"{dgot.numel()} elements")
            del dgot, dwant

    # the gradient: autograd's backward against an index_select gather of
    # the same cotangent rows (clones: inference tensors take no autograd)
    g = torch.Generator(device=device).manual_seed(SEED)
    cot = torch.randn((2, n, 128), generator=g, device=device).to(
        torch.bfloat16)
    x = got.clone().requires_grad_()
    ids = ids.clone()
    dense_build.dense_build_autograd(x, ids, n).backward(cot)
    base = (torch.arange(2, device=device)[:, None] * n
            + torch.clamp(ids, max=n - 1)).reshape(-1)
    want_grad = cot.reshape(-1, 128).index_select(0, base).view(
        x.shape) * (ids < n)[..., None].to(cot.dtype)
    torch.cuda.synchronize()
    check(torch.equal(x.grad, want_grad), "dense gradient differs from plain")
    print(f"  dense_build gradient: bit-equal over {x.grad.numel()} elements")
    del x

    with torch.inference_mode():
        copy_err = 0.0
        for name, p in (("vendored", prep), ("crowded", cp)):
            rgot = run_copy.run_copy(p.sorted_planar, p.run_start, T)
            rwant = run_copy.run_copy_plain(p.sorted_planar, p.run_start, T)
            torch.cuda.synchronize()
            copy_err = max(copy_err, float((rgot - rwant).abs().max()))
            check(torch.equal(rgot, rwant), f"run_copy differs ({name})")
            print(f"  run_copy ({name}): bit-equal over {rgot.numel()} "
                  "elements")

        # the inference B=8 batch: the vendored frames cycled
        p8, n8 = predict.stage_points([frames[i % 3] for i in range(8)],
                                      config, rng)
        prep8 = prepare(torch.from_numpy(p8).to(device),
                        torch.from_numpy(n8).to(device), spec, K)
        args8 = (prep8.sorted_planar, prep8.run_start, prep8.num_voxels,
                 prep8.counts, *w)

        padded = torch.nn.functional.pad(prep.sorted_planar, (0, T))
        index = run_copy.gather_index(prep.run_start, T).contiguous()
        f32 = got.float()
        # the dense grid's one torch call: index_copy_ of the rows into a
        # new zero grid (with a spare row for padding), the plain
        # version's core with the row targets computed once
        nb, nc = got.shape[0], got.shape[2]
        target = torch.where(
            ids < n, torch.arange(nb, device=device)[:, None] * n
            + ids.long(), nb * n).reshape(-1)
        rows = got.reshape(-1, nc)
        # name -> (kernel, plain version, one torch call or None)
        times = {
            "vfe_fused": (timed(lambda: vfe_fused.vfe_fused(*args, T)),
                          timed(lambda: vfe_fused.vfe_fused_plain(*args, T)),
                          None),
            "vfe_fused_b8": (
                timed(lambda: vfe_fused.vfe_fused(*args8, T)),
                timed(lambda: vfe_fused.vfe_fused_plain(*args8, T)), None),
            "dense_build": (timed(lambda: dense_build.dense_build(
                got, ids, n)), timed(lambda: dense_build.dense_build_plain(
                    got, ids, n)),
                timed(lambda: got.new_zeros((nb * n + 1, nc)).index_copy_(
                    0, target, rows))),
            "dense_build_f32": (timed(lambda: dense_build.dense_build(
                f32, ids, n)), timed(lambda: dense_build.dense_build_plain(
                    f32, ids, n)), None),
            # the dense grid's backward is itself a torch gather
            "dense_build_grad": (timed(lambda: dense_build.dense_build_grad(
                cot, ids, n)), None, None),
            "run_copy": (
                timed(lambda: run_copy.run_copy(prep.sorted_planar,
                                                prep.run_start, T)),
                timed(lambda: run_copy.run_copy_plain(
                    prep.sorted_planar, prep.run_start, T)),
                timed(lambda: torch.gather(padded, 2, index))),
        }
    for name, parts in times.items():
        print(f"  {name}: " + ", ".join(
            f"{what} {t['ms']} ms (device {t['device_ms']} ms)"
            for what, t in zip(("kernel", "plain", "one torch call"), parts)
            if t is not None)
              + f" [{card}]")

    B, K = 2, prep.run_start.shape[1]
    weights = nbytes(*w)

    def vfe_bound(p, batch):
        # the VFE's products take bf16 operands and accumulate in f32, as
        # the TPU kernel's MXU dots do: the tensor cores' bf16 rate
        return bound(
            nbytes(p.sorted_planar, p.run_start, p.num_voxels, p.counts)
            + weights + batch * K * 128 * 2,
            VFE_FLOP_PER_POINT * float(p.counts.sum()), torch.bfloat16)

    bounds = {
        "vfe_fused": vfe_bound(prep, B),
        "vfe_fused_b8": vfe_bound(prep8, 8),
        "dense_build": bound(nbytes(got, ids) + B * n * 128 * 2),
        "dense_build_f32": bound(nbytes(f32, ids) + B * n * 128 * 4),
        # the occupied rows read and all rows written, and the ids
        "dense_build_grad": bound(
            int((ids < n).sum()) * 128 * 2 + nbytes(got, ids)),
        "run_copy": bound(nbytes(prep.sorted_planar, prep.run_start)
                          + B * K * T * 16),
    }
    for name, (ms, by) in bounds.items():
        print(f"  {name}: bound {ms} ms ({by}) at these inputs")
    errs = {"vfe_fused": vfe_err, "dense_build": dense_err,
            "run_copy": copy_err}
    return times, errs, bounds


def check_detections(det, config, batch):
    post = config.rpn.nms_post_topk
    check(det.boxes.shape == (batch, post, 7), f"boxes {det.boxes.shape}")
    check(det.scores.shape == (batch, post), f"scores {det.scores.shape}")
    check(bool(torch.isfinite(det.boxes).all()), "non-finite boxes")
    check(bool(torch.isfinite(det.scores).all()), "non-finite scores")
    counts = det.valid.sum(1)
    check(bool((counts <= post).all()), "more detections than post_topk")
    return counts.tolist()


def check_launched(what: str, launches: dict, ran=(), idle=()) -> None:
    """Each kernel of `ran` launched, none of `idle`."""
    check(all(launches[k] > 0 for k in ran)
          and not any(launches[k] for k in idle),
          f"{what}: launches {launches}, expected {list(ran)} launched and "
          f"{list(idle)} not")


def phase_main_path(model, frames, device):
    """cli.predict's path on the 3 vendored frames at full Car width ->
    (launches, the detections at score_thres 0)."""
    print("[4] main path: cli.predict on 3 vendored frames, Car, bf16")
    reset_launches()
    results, dets = {}, {}
    for thres in (0.96, 0.0):
        config = get_config("Car", rpn={"score_thres": thres})
        infer = make_inference_fn(config, device)
        dets[thres] = predict.predict(infer, model, frames, config,
                                      np.random.default_rng(SEED))
        torch.cuda.synchronize()
        results[thres] = check_detections(dets[thres], config, len(frames))
    launches = launch_counts()
    print(f"  valid detections per frame: score_thres 0.96 -> "
          f"{results[0.96]}, 0.0 -> {results[0.0]}; launches {launches}")
    check_launched("inference path", launches, ("vfe_fused", "dense_build"),
                   ("sparse_conv", "sparse_conv_grad", "occupancy_map"))
    check(sum(results[0.0]) > 0, "no detections at score_thres 0.0")
    return launches, dets[0.0]


def merged(base: dict, extra: dict) -> dict:
    """base's groups updated with extra's (one level deep)."""
    out = {k: dict(v) for k, v in base.items()}
    for group, values in extra.items():
        out.setdefault(group, {}).update(values)
    return out


def phase_small_reference(device, compat=None, overrides=None):
    """The same path at a tiny grid in f32: card against CPU (with the
    `compat` and other config overrides)."""
    config = get_config("Car", **merged(TINY, dict(overrides or {},
                                                   compat=compat or {})))
    points, num = predict.stage_points(sample_frames()[:2], config,
                                       np.random.default_rng(SEED))
    check(int(num.min()) > 1000, f"tiny grid: only {num} points in the grid")
    model = make_model(config, "cpu")
    want = make_inference_fn(config, "cpu")(model, points, num)
    got = make_inference_fn(config, device)(model.to(device), points, num)
    got = type(got)(*(t.cpu() for t in got))
    counts = check_detections(got, config, 2)
    check(counts == want.valid.sum(1).tolist(),
          f"valid counts {counts} vs CPU {want.valid.sum(1).tolist()}")
    err = 0.0
    for b in range(2):
        gs = got.scores[b][got.valid[b]]
        ws = want.scores[b][want.valid[b]]
        go, wo = gs.argsort(descending=True), ws.argsort(descending=True)
        err = max(err, float((gs[go] - ws[wo]).abs().max()))
        berr = float((got.boxes[b][got.valid[b]][go]
                      - want.boxes[b][want.valid[b]][wo]).abs().max())
        check(berr <= 1e-2, f"tiny grid: box error {berr} vs CPU")
    # f32 convs in another summation order, VFE outputs 1 bf16 ulp apart
    check(err <= 1e-3, f"tiny grid: score error {err} vs CPU")
    print(f"  tiny grid f32, card vs CPU: valid {counts}, max score "
          f"error {err}")


def phase_timing(model, frames, device, card, overrides=None):
    """Per-stage and end-to-end CUDA-event times of make_inference_fn at
    B=1 and B=8 -> ({batch: frames/s}, by the median end-to-end time;
    {batch: print_profile's device busy ms of one call})."""
    config = get_config("Car", **(overrides or {}))
    fps, busy = {}, {}
    infer = make_inference_fn(config, device)
    rng = np.random.default_rng(SEED)
    for batch in (1, 8):
        clouds = [frames[i % len(frames)] for i in range(batch)]
        points, num = predict.stage_points(clouds, config, rng)
        points = torch.from_numpy(points).to(device)
        num = torch.from_numpy(num).to(device)
        for _ in range(3):
            infer(model, points, num)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        per_stage = {s: [] for s in ("total",) + STAGES}
        host = []
        for _ in range(8):
            marks = []
            t0 = time.perf_counter()
            infer(model, points, num, marks)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            for (_, a), (stage, b) in zip(marks, marks[1:]):
                per_stage[stage].append(a.elapsed_time(b))
            per_stage["total"].append(marks[0][1].elapsed_time(marks[-1][1]))
        med = {s: statistics.median(v) for s, v in per_stage.items()}
        fps[batch] = batch * 1e3 / med["total"]
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        print(f"  B={batch}: end-to-end {med['total']} ms CUDA events, "
              f"{statistics.median(host)} ms host, "
              f"{batch * 1e3 / med['total']} frames/s, peak {peak} GiB "
              f"[{card}]")
        print("    " + ", ".join(f"{s} {med[s]}" for s in STAGES) + " (ms)")
        busy[batch] = print_profile(lambda: infer(model, points, num))
    return fps, busy


# print_profile: the trace parser's op total against the profiler's own
# sum of the same profile's device times. Both read the same CUPTI
# records, so they differ by the rounding of the sums alone: on an H100
# 80GB HBM3 at 700 W six profiles (inference B=1 and 8, conv3d and
# sparse1, the train steps) agreed to 1e-14; 1e-6 fails a parser that
# drops or double-counts even one memset
PARSER_REL = 1e-6


def print_profile(call) -> float:
    """Kernel time by name for one call() (the profile tool's parser over
    its trace), and the device's busy share of the call's CUDA-event
    span -> the busy ms. The parser's op total must equal, within
    PARSER_REL, the profiler's own sum of the same profile's device
    times (key_averages), which another code path aggregates."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed_call():
        start.record()
        call()
        end.record()

    with tempfile.TemporaryDirectory() as tmp:
        _, path, prof = profile_step.trace_calls(timed_call, (), tmp, 1,
                                                 torch.device("cuda", 0))
        s = profile_step.parse_trace(path, 1)
    own = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    span = start.elapsed_time(end)
    print(f"    profile: kernels busy {s.busy_ms} ms (op total "
          f"{s.total_ms}; the profiler's own device total {own}) of {span} "
          f"ms (idle share {1 - s.busy_ms / span})")
    for r in s.rows[:20]:
        print(f"      {r.ms:9.4f} ms x{r.calls:<4g} {r.name[:150]}")
    check(abs(s.total_ms - own) <= PARSER_REL * own,
          f"the trace parser's device op total {s.total_ms} ms against the "
          f"profiler's own {own} ms")
    return s.busy_ms


def synthetic_gt(rng: np.random.Generator, config, batch: int,
                 per_frame: int = 5):
    """(gt_boxes (B, G, 7), gt_mask (B, G)): `per_frame` Car-sized boxes
    per frame inside the grid, the other slots masked."""
    obj = config.object
    G = config.data.max_gt_boxes
    gt = np.zeros((batch, G, 7), np.float32)
    gt[:, :per_frame, 0] = rng.uniform(obj.x_min + 0.1 * obj.x_max,
                                       0.9 * obj.x_max, (batch, per_frame))
    gt[:, :per_frame, 1] = rng.uniform(0.9 * obj.y_min, 0.9 * obj.y_max,
                                       (batch, per_frame))
    gt[:, :per_frame, 2] = obj.anchor_z
    gt[:, :per_frame, 3:6] = [obj.anchor_h, obj.anchor_w, obj.anchor_l]
    gt[:, :per_frame, 3:6] *= rng.uniform(0.9, 1.1, (batch, per_frame, 3))
    gt[:, :per_frame, 6] = rng.uniform(-math.pi / 2, math.pi / 2,
                                       (batch, per_frame))
    mask = np.zeros((batch, G), bool)
    mask[:, :per_frame] = True
    return gt, mask


def train_batch(config, frames, batch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    clouds = [frames[i % len(frames)] for i in range(batch)]
    points, num = predict.stage_points(clouds, config, rng)
    gt, mask = synthetic_gt(rng, config, batch)
    return {"points": points, "num_points": num, "gt_boxes": gt,
            "gt_mask": mask}


def finite_metrics(metrics) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in out.values()),
          f"non-finite train metrics {out}")
    return out


def phase_train(frames, device, card, seed, overrides=None, batch_size=2,
                ran=("run_copy", "dense_build"),
                idle=("sparse_conv", "sparse_conv_grad", "occupancy_map"),
                label="5"):
    """make_train_step at full Car width on one repeated batch."""
    print(f"[{label}] train path: make_train_step, Car, bf16, B={batch_size}, "
          f"{TRAIN_STEPS} steps on one batch, overrides {overrides or {}}")
    config = get_config("Car", **(overrides or {}))
    batch = train_batch(config, frames, batch_size, seed)
    state = create_train_state(config, build_model(config, seed=SEED),
                               device=device)
    step = make_train_step(config, device)
    reset_launches()
    losses = []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        m = finite_metrics(metrics)
        losses.append(m["loss"])
        print(f"  step {i}: " + ", ".join(f"{k} {v}" for k, v in m.items()))
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"  launches {launches}")
    check_launched("train path", launches, ran, idle)
    check(losses[-1] < 0.9 * losses[0],
          f"loss did not fall: first {losses[0]}, last {losses[-1]}")
    del state
    return launches


def phase_train_small_reference(frames, device, seed, overrides=None):
    """One f32 step at the tiny grid from the same weights and batch, on
    the card and on the CPU."""
    config = get_config("Car", **merged(TINY, overrides or {}))
    batch = train_batch(config, frames[:2], 2, seed)
    got = {}
    for dev in ("cpu", device):
        state = create_train_state(config, build_model(config, seed=SEED),
                                   device=dev)
        _, metrics = make_train_step(config, dev)(state, batch)
        got[str(dev)] = finite_metrics(metrics)
    card_m, cpu_m = got[str(device)], got["cpu"]
    loss_rel = abs(card_m["loss"] / cpu_m["loss"] - 1)
    norm_rel = abs(card_m["grad_norm"] / cpu_m["grad_norm"] - 1)
    print(f"  tiny grid f32 train step, card vs CPU: loss {card_m['loss']} "
          f"vs {cpu_m['loss']} (rel {loss_rel}), grad_norm "
          f"{card_m['grad_norm']} vs {cpu_m['grad_norm']} (rel {norm_rel})")
    check(loss_rel <= 1e-4, f"tiny train step: loss rel {loss_rel}")
    # f32 convs sum in another order on the card, and a ReLU that flips
    # at its boundary moves a gradient (measured 6.5e-6 on an H100)
    check(norm_rel <= 1e-3, f"tiny train step: grad_norm rel {norm_rel}")


def phase_train_timing(frames, device, card, seed, overrides=None,
                       batches=(2, 8)):
    """Step times at each of `batches` -> ({batch: step-alone frames/s},
    {8: print_profile's device busy ms of one step})."""
    config = get_config("Car", **(overrides or {}))
    fps, busy = {}, {}
    for batch_size in batches:
        batch = train_batch(config, frames, batch_size, seed)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        state = create_train_state(config, build_model(config, seed=SEED),
                                   device=device)
        step = make_train_step(config, device)
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        per_stage = {s: [] for s in ("total",) + TRAIN_STAGES}
        host = []
        for _ in range(8):
            marks = []
            t0 = time.perf_counter()
            step(state, batch, marks)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            for (_, a), (stage, b) in zip(marks, marks[1:]):
                per_stage[stage].append(a.elapsed_time(b))
            per_stage["total"].append(marks[0][1].elapsed_time(marks[-1][1]))
        med = {s: statistics.median(v) for s, v in per_stage.items()}
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        fps[batch_size] = batch_size * 1e3 / med["total"]
        print(f"  train B={batch_size}: step {med['total']} ms CUDA events, "
              f"{statistics.median(host)} ms host, "
              f"{batch_size * 1e3 / med['total']} frames/s, peak {peak} GiB "
              f"[{card}]")
        print("    " + ", ".join(f"{s} {med[s]}" for s in TRAIN_STAGES)
              + " (ms)")
        if batch_size == 8:
            busy[8] = print_profile(lambda: step(state, batch))
        del state, batch
    return fps, busy


def write_kitti_split(root: str, split: str, n: int, frames, config,
                      rng: np.random.Generator) -> None:
    """root/split/{velodyne,label_2}: frame i is vendored frame i % 3, its
    labels 5 synthetic Car boxes (camera-frame KITTI lines, mean calib)."""
    velo = os.path.join(root, split, "velodyne")
    labels = os.path.join(root, split, "label_2")
    os.makedirs(velo)
    os.makedirs(labels)
    for i in range(n):
        frames[i % len(frames)].tofile(os.path.join(velo, f"{i:06d}.bin"))
        gt, mask = synthetic_gt(rng, config, 1)
        boxes = gt[0][mask[0]]
        with open(os.path.join(labels, f"{i:06d}.txt"), "w") as f:
            f.writelines(kitti.boxes_to_label_lines(
                boxes, ["Car"] * len(boxes), coordinate="lidar"))


def run_cli(main, argv) -> str:
    """main(argv) in this process -> what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def phase_trainer(frames, device, seed, tmp) -> dict:
    """cli.train 2 epochs, --resume to 3, cli.eval, cli.predict
    --checkpoint, at full Car width (B=2) -> trainer launch counts."""
    print("[6] trainer: cli.train 2 epochs + --resume to 3, cli.eval, "
          "cli.predict --checkpoint; Car, bf16, B=2")
    config = get_config("Car")
    data = os.path.join(tmp, "kitti")
    rng = np.random.default_rng(seed)
    for split, n in TRAINER_FILES.items():
        write_kitti_split(data, split, n, frames, config, rng)
    exp = os.path.join(tmp, "exp")
    steps_per_epoch = TRAINER_FILES["training"] // config.train.batch_size
    cfgs = {}
    for epochs in (2, 3):
        cfgs[epochs] = os.path.join(tmp, f"epochs{epochs}.yaml")
        with open(cfgs[epochs], "w") as f:
            f.write(f"train: {{num_epochs: {epochs}}}  # Car preset else\n")
    common = ["--data-dir", data, "--exp-dir", exp, "--device", device.type,
              "--print-interval", "1", "--summary-interval", "1",
              "--summary-val-interval", "2"]
    reset_launches()
    t0 = time.perf_counter()
    first = run_cli(train_cli.main, common + ["--cfg", cfgs[2]])
    resumed = run_cli(train_cli.main, common + [
        "--cfg", cfgs[3], "--resume", os.path.join(exp, "checkpoints")])
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"  cli.train 2 epochs + resume 1: {time.perf_counter() - t0} s, "
          f"launches {launches}")
    logged = [[line for line in out.splitlines()
               if line.startswith(("Train ", "Epoch "))]
              for out in (first, resumed)]
    print("\n".join(f"    {line}" for line in sum(logged, [])))
    check(launches["run_copy"] > 0 and launches["dense_build"] > 0,
          f"a kernel was not launched by the trainer: {launches}")
    metrics = [float(v) for line in sum(logged, []) for v in re.findall(
        r"(?:loss|reg|cls|avg_val_loss) (\S+)", line)]
    check(len(metrics) == 3 * 3 * steps_per_epoch + 3
          and all(math.isfinite(v) for v in metrics),
          f"trainer metrics missing or not finite: {metrics}")
    check(logged[1][0].startswith("Train 1 @ epoch 3/3")
          and [x for x in logged[1] if x.startswith("Epoch")][0].startswith(
              "Epoch 3 "), f"the resumed run did not start at epoch 3: "
          f"{logged[1][:1]}")
    check(os.path.exists(os.path.join(exp, "config.yaml")), "no config.yaml")
    ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    check(ckpts == ["0", "1", "2"], f"checkpoints {ckpts}")
    saved = torch.load(os.path.join(exp, "checkpoints", "2", "state.pt"),
                       map_location="cpu", weights_only=True)
    check(saved["step"] == 3 * steps_per_epoch
          and saved["opt_count"] == 3 * steps_per_epoch,
          f"step count after resume: {saved['step']}, {saved['opt_count']}")
    val_tags = sorted(f[:-4] for f in os.listdir(
        os.path.join(data, "validation", "velodyne")))
    for epoch in (1, 2, 3):
        dumped = sorted(f[:-4] for f in os.listdir(
            os.path.join(exp, "preds", str(epoch), "data")))
        check(dumped == val_tags, f"preds/{epoch}: {dumped}")
    ap = json.loads(run_cli(eval_cli.main, [
        "--preds", os.path.join(exp, "preds", "3", "data"),
        "--gt", os.path.join(data, "validation", "label_2"),
        "--iou", "0.5", "--mode", "bev"]))
    check(ap["frames"] == len(val_tags), f"cli.eval frames {ap['frames']}")
    print(f"  cli.eval: {json.dumps(ap)}")

    reset_launches()
    out = run_cli(predict.main, [
        "--pcl", os.path.join(data, "validation", "velodyne",
                              val_tags[0] + ".bin"),
        "--checkpoint", os.path.join(exp, "checkpoints"),
        "--device", device.type])
    torch.cuda.synchronize()
    check(vfe_fused.launches > 0,
          f"cli.predict --checkpoint launched no vfe_fused: "
          f"{launch_counts()}")
    print(f"  cli.predict --checkpoint: {out.splitlines()[0]}; launches "
          f"{launch_counts()}")
    return launches


def phase_trainer_timing(frames, device, seed, tmp, card, step_fps):
    """One epoch at B=8 over TIMING_FILES frames through a Trainer, then a
    second one traced by its --profile-steps window."""
    config = get_config("Car", train={"batch_size": 8, "num_epochs": 2},
                        val={"batch_size": 2})
    data = os.path.join(tmp, "kitti8")
    rng = np.random.default_rng(seed + 1)
    write_kitti_split(data, "training", TIMING_FILES, frames, config, rng)
    write_kitti_split(data, "validation", TRAINER_FILES["validation"],
                      frames, config, rng)
    steps = TIMING_FILES // 8
    with Trainer(config, os.path.join(data, "training"),
                 os.path.join(data, "validation"),
                 exp_dir=os.path.join(tmp, "exp8"), device=device) as tr:
        with contextlib.redirect_stdout(io.StringIO()):
            tr.train(print_interval=1000, summary_interval=1000,
                     val_interval=1000,
                     profile_steps=(steps + 2, steps + 6))
        t = tr.timings
        trace = profile_step.parse_trace(os.path.join(tr.exp_dir, "logs"),
                                         1)
        busy, span, kernels = trace.busy_ms, trace.span_ms, trace.kernels
    check(t["epoch_steps"] == [steps, steps], f"steps {t['epoch_steps']}")
    fps = 8 * steps / t["epoch_s"][0]
    gaps = t["host_gap_s"][:steps - 1]
    print(f"  trainer B=8: {steps} steps, epoch {t['epoch_s'][0]} s, "
          f"{fps} frames/s through the trainer (wall clock, pipeline and "
          f"staging included) vs {step_fps[8]} frames/s step alone "
          f"(phase 5); first batch after {t['first_batch_s'][0] * 1e3} ms;"
          f" median host gap between steps "
          f"{statistics.median(gaps) * 1e3} ms (max {max(gaps) * 1e3} ms); "
          f"checkpoint save {t['checkpoint_s'][0] * 1e3} ms; val dump "
          f"{t['val_dump_s'][0] / t['val_dump_frames'][0] * 1e3} ms/frame "
          f"[{card}]")
    print(f"  trainer B=8, epoch 2, profiler over steps {steps + 2}-"
          f"{steps + 5}: device busy {busy} ms of {span} ms ({kernels} "
          f"kernels), idle share {1 - busy / span} [{card}]")
    print(f"  epoch 2: {t['epoch_s'][1]} s (profiler on); checkpoint "
          f"{t['checkpoint_s'][1] * 1e3} ms")


def dp_config(overrides: dict, world: int, model: int = 1,
              class_name: str = "Car"):
    """The `class_name` config of `overrides` on a mesh of `world`
    processes, `model` of them a model group (spatial W-sharding), the
    rest data shards."""
    return get_config(class_name, **dict(overrides, system={
        "num_data_shards": world // model, "num_model_shards": model}))


def local_rows(batch: dict, size: int, model: int, device) -> dict:
    """This rank's rows of a global batch of `size` rows: the block of its
    data index (rank // model), on `device`."""
    local = size // (distributed.world_size() // model)
    lo = distributed.rank() // model * local
    return {k: torch.as_tensor(v[lo:lo + local], device=device)
            for k, v in batch.items()}


def dp_run(run: dict, frames, device) -> dict:
    """One data-parallel (or, with run["model"] > 1, spatially sharded)
    train run of a worker: `steps` train steps on this rank's rows of a
    seeded global batch, then `timed` more under CUDA-event marks;
    metrics, launch counts, the all-reduces of one step (in all and by
    group), the ranks' agreement and times."""
    world, model = distributed.world_size(), run.get("model", 1)
    config = dp_config(run["overrides"], world, model)
    batch = local_rows(train_batch(config, frames, run["batch"],
                                   run["seed"]), run["batch"], model, device)
    state = create_train_state(config, build_model(config, seed=SEED),
                               device=device)
    distributed.broadcast_state_(state.model)
    step = make_train_step(config, device)
    reset_launches()
    distributed.reset_counts()
    metrics, per_step = [], None
    for i in range(run["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            per_step = {k: list(v) for k, v in
                        distributed.all_reduce_counts.items()}
    torch.cuda.synchronize()
    out = {"metrics": metrics, "launches": launch_counts(),
           "all_reduces_per_step": sum(c for c, _ in per_step.values()),
           "all_reduce_bytes_per_step": sum(n for _, n in per_step.values()),
           "all_reduces_by_group": per_step,
           "disagree": distributed.ranks_disagree(state.model)}
    if run["timed"]:
        totals, reduce_ms = [], []
        for _ in range(run["timed"]):
            marks = []
            step(state, batch, marks)
            torch.cuda.synchronize()
            totals.append(marks[0][1].elapsed_time(marks[-1][1]))
            at = dict(marks)
            reduce_ms.append(at["backward"].elapsed_time(at["all_reduce"]))
        grads = torch.zeros(sum(p.numel() for p in state.model.parameters()),
                            device=device)
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            distributed.all_reduce_([grads])
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out.update(step_ms=statistics.median(totals),
                   grad_all_reduce_in_step_ms=statistics.median(reduce_ms),
                   grad_all_reduce_ms=statistics.median(times[2:]),
                   grad_all_reduce_bytes=grads.numel() * 4)
    del state
    return out


def spatial_infer_run(run: dict, frames, device, job_path: str) -> dict:
    """One spatially sharded inference run of a worker (phase 11): phase
    4's model (the same seed; of run["class_name"], Car by default) on
    `batch` vendored frames (cycled), each
    rank of a model group on the same rows; make_inference_fn's
    detections, its launch counts and all-reduces by group for one call,
    and the median end-to-end and stage times of `timed` calls (CUDA
    events, as phase 4); the eval-mode forward's cls and reg maps
    (whole W). Rank 0 saves the detections and maps to
    <job>.<name>.pt."""
    world, model = distributed.world_size(), run["model"]
    config = dp_config(run["overrides"], world, model,
                       run.get("class_name", "Car"))
    net = make_model(config, device)
    infer = make_inference_fn(config, device)
    points, num = predict.stage_points(
        [frames[i % len(frames)] for i in range(run["batch"])], config,
        np.random.default_rng(SEED))
    rows = local_rows({"points": points, "num_points": num}, run["batch"],
                      model, device)
    infer(net, rows["points"], rows["num_points"])
    torch.cuda.synchronize()
    reset_launches()
    distributed.reset_counts()
    det = infer(net, rows["points"], rows["num_points"])
    torch.cuda.synchronize()
    out = {"launches": launch_counts(),
           "all_reduces_by_group": {k: list(v) for k, v in
                                    distributed.all_reduce_counts.items()}}
    per_stage = {s: [] for s in ("total",) + STAGES}
    for _ in range(run["timed"]):
        marks = []
        infer(net, rows["points"], rows["num_points"], marks)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(marks, marks[1:]):
            per_stage[stage].append(a.elapsed_time(b))
        per_stage["total"].append(marks[0][1].elapsed_time(marks[-1][1]))
    out["stage_ms"] = ({s: statistics.median(v) for s, v in
                        per_stage.items()} if run["timed"] else None)
    vox = voxelize_table(rows["points"], rows["num_points"],
                         VoxelGridSpec.from_object_config(config.object),
                         config.data.max_voxels)
    with torch.no_grad():
        cls, reg = net.eval()(vox.features, vox.coords, vox.counts)
    if distributed.rank() == 0:
        torch.save({"det": [t.cpu() for t in det], "cls": cls.cpu(),
                    "reg": reg.cpu()}, f"{job_path}.{run['name']}.pt")
    return out


def dp_worker(job_path: str, rank: int) -> None:
    """A rank of a phase 7 or phase 11 run: join the job's group, run its
    runs, write the results as JSON next to the job."""
    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = distributed.initialize(
        job["init"], job["world"], rank, backend=job["backend"],
        device=job["device"] or f"cuda:{rank}", timeout_s=DP_TIMEOUT_S)
    try:
        frames = sample_frames()
        out = {run["name"]: (
            spatial_infer_run(run, frames, device, job_path)
            if run.get("kind") == "infer" else dp_run(run, frames, device))
            for run in job["runs"]}
    finally:
        distributed.shutdown()
    with open(f"{job_path}.out{rank}", "w") as f:
        json.dump(out, f)


def run_dp_workers(tmp: str, name: str, backend: str, device: str | None,
                   runs: list[dict], world: int = 2) -> list[dict]:
    """`world` worker processes of this script on `runs` -> each rank's
    results; fatal if one fails or outlasts DP_TIMEOUT_S."""
    job = os.path.join(tmp, f"{name}.json")
    with open(job, "w") as f:
        json.dump({"init": "file://" + os.path.join(tmp, f"{name}.rdv"),
                   "world": world, "backend": backend, "device": device,
                   "runs": runs}, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", job,
         "--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{name}: rank {r} exited {p.returncode}:"
              f"\n{log[-3000:]}")
    outs = []
    for r in range(world):
        with open(f"{job}.out{r}") as f:
            outs.append(json.load(f))
    return outs


def one_process_step(overrides: dict, frames, device, batch: int,
                     seed: int) -> dict:
    config = dp_config(overrides, 1)
    state = create_train_state(config, build_model(config, seed=SEED),
                               device=device)
    _, m = make_train_step(config, device)(
        state, train_batch(config, frames, batch, seed))
    return finite_metrics(m)


def check_ranks_agree(name: str, outs: list[dict],
                      ran=("run_copy", "dense_build"), idle=()) -> None:
    """Every rank's metrics finite and equal to rank 0's, its parameters
    bit-equal to rank 0's, the kernels of the train path (`ran`) launched
    and those of `idle` not."""
    for r, o in enumerate(outs):
        check(o["disagree"] == 0, f"{name}: ranks' parameters differ")
        for m in o["metrics"]:
            check(all(math.isfinite(v) for v in m.values()),
                  f"{name}: non-finite metrics on rank {r}: {m}")
        check(o["metrics"] == outs[0]["metrics"],
              f"{name}: rank {r} metrics differ from rank 0's")
        check_launched(f"{name}: rank {r}", o["launches"], ran, idle)


def check_dp_run(name: str, outs: list[dict], want: dict, loss_rel: float,
                 norm_rel: float, ran=("run_copy", "dense_build"),
                 idle=()) -> None:
    """check_ranks_agree, and step 1 against one process at the same
    global batch."""
    check_ranks_agree(name, outs, ran, idle)
    got = outs[0]["metrics"][0]
    lr = abs(got["loss"] / want["loss"] - 1)
    nr = abs(got["grad_norm"] / want["grad_norm"] - 1)
    print(f"  {name}: step 1 loss {got['loss']} vs {want['loss']} one "
          f"process (rel {lr}), pre-clip grad_norm {got['grad_norm']} vs "
          f"{want['grad_norm']} (rel {nr}); losses "
          f"{[m['loss'] for m in outs[0]['metrics']]}; launches per rank "
          f"{[o['launches'] for o in outs]}; ranks bit-identical")
    check(lr <= loss_rel, f"{name}: loss rel {lr} > {loss_rel}")
    check(nr <= norm_rel, f"{name}: grad_norm rel {nr} > {norm_rel}")


def phase_data_parallel(frames, device, seed, tmp, card, step_fps) -> dict:
    """Phase 7 -> the launch counts of rank 0 of the Car run (a)."""
    print("[7] data parallel: 2 ranks on cuda:0 over gloo (Car bf16 B=4, "
          "tiny f32 B=4), torchrun cli.train, NCCL on 2 cards where present")
    car = {"name": "car", "overrides": {}, "batch": 4, "seed": seed,
           "steps": DP_STEPS, "timed": DP_STEPS}
    tiny = dict(car, name="tiny", overrides=TINY, steps=1, timed=0)
    want = {run["name"]: one_process_step(run["overrides"], frames, device,
                                          4, seed)
            for run in (car, tiny)}
    outs = run_dp_workers(tmp, "gloo", "gloo", "cuda:0", [car, tiny])
    check_dp_run("(a) Car bf16, 2 ranks x B=2", [o["car"] for o in outs],
                 want["car"], 2e-2, 5e-2)
    # f32 statistics summed over half the batch, then across the ranks,
    # round differently from one sum over the batch, and a ReLU input
    # within that rounding of 0 flips and moves a gradient: grad norm
    # 1.4e-4 to 9.7e-4 apart over 4 seeds on a CPU, held at the f64 JAX
    # step test's 5e-3 for the same effect. The exact check is f64, on the
    # CPU (tests/test_torch_parallel.py): dense_build takes bf16 and f32
    check_dp_run("(b) tiny f32, 2 ranks x B=2", [o["tiny"] for o in outs],
                 want["tiny"], 1e-4, 5e-3)
    a = outs[0]["car"]
    print(f"  collectives per train step: {a['all_reduces_per_step']} "
          f"all-reduces, {a['all_reduce_bytes_per_step']} bytes (one "
          f"gradient buffer of {a['grad_all_reduce_bytes']} bytes, one "
          f"metric vector, the BatchNorm statistics forward and backward)")
    print(f"  gloo on one card (both ranks on cuda:0, staged through the "
          f"host; not an NCCL time): gradient all-reduce "
          f"{a['grad_all_reduce_ms']} ms alone, "
          f"{a['grad_all_reduce_in_step_ms']} ms in the step; step "
          f"{a['step_ms']} ms at B=2 a rank [{card}]")

    # (c) the CLI under torchrun, on phase 6's KITTI tree
    data = os.path.join(tmp, "kitti")
    exp = os.path.join(tmp, "exp_dp")
    cfg = os.path.join(tmp, "dp.yaml")
    with open(cfg, "w") as f:
        f.write("system: {num_data_shards: 2}\n"
                "train: {num_epochs: 1, batch_size: 2}\n"
                "val: {batch_size: 2}\n")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "voxelnet_tpu_torch.cli.train",
         "--dist-backend", "gloo", "--device", "cuda:0", "--data-dir", data,
         "--exp-dir", exp, "--cfg", cfg, "--print-interval", "1"],
        capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    check(r.returncode == 0, f"torchrun cli.train exited {r.returncode}:\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    logged = [line for line in r.stdout.splitlines()
              if line.startswith(("Train ", "Epoch "))]
    steps = TRAINER_FILES["training"] // 2
    print(f"  (c) torchrun cli.train, 2 ranks: {time.perf_counter() - t0} s"
          + "".join(f"\n    {line}" for line in logged))
    check(len(logged) == steps + 1, f"(c) expected {steps} step lines and "
          f"one epoch line, from rank 0 only: {logged}")
    check(os.path.exists(os.path.join(exp, "config.yaml")), "(c) no config")
    ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    check(ckpts == ["0"], f"(c) checkpoints {ckpts}")
    saved = torch.load(os.path.join(exp, "checkpoints", "0", "state.pt"),
                       map_location="cpu", weights_only=True)
    check(saved["step"] == steps, f"(c) step count {saved['step']}")
    val_tags = sorted(f[:-4] for f in os.listdir(
        os.path.join(data, "validation", "velodyne")))
    dumped = sorted(f[:-4] for f in os.listdir(
        os.path.join(exp, "preds", "1", "data")))
    check(dumped == val_tags, f"(c) preds/1: {dumped}")
    ap = json.loads(run_cli(eval_cli.main, [
        "--preds", os.path.join(exp, "preds", "1", "data"),
        "--gt", os.path.join(data, "validation", "label_2"),
        "--iou", "0.5", "--mode", "bev"]))
    check(ap["frames"] == len(val_tags), f"(c) cli.eval frames {ap}")
    print(f"  (c) exp dir, checkpoint 0 at step {saved['step']}, dumps of "
          f"all {len(val_tags)} val frames; cli.eval {json.dumps(ap)}")

    # (d) NCCL between two cards
    if torch.cuda.device_count() >= 2:
        run8 = dict(car, name="car8", batch=16, timed=DP_TIMED_STEPS)
        outs8 = [o["car8"] for o in run_dp_workers(tmp, "nccl", "nccl",
                                                    None, [run8])]
        check_ranks_agree("(d) Car bf16, NCCL, 2 cards x B=8", outs8)
        o = outs8[0]
        print(f"  (d) NCCL, 2 cards, Car B=8 a card: step {o['step_ms']} ms,"
              f" {8e3 / o['step_ms']} frames/s a card (one card, phase 5: "
              f"{step_fps[8]}); gradient all-reduce {o['grad_all_reduce_ms']}"
              f" ms alone, {o['grad_all_reduce_in_step_ms']} ms in the step"
              f" [{card}]")
    else:
        print(f"  (d) NCCL across cards: not run, torch sees "
              f"{torch.cuda.device_count()} card")
    return a["launches"]


def ap_equal(a: float, b: float) -> bool:
    """Equal within 1e-6, NaN (no ground truth in the bucket) equal to
    itself."""
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-6


def phase_learning_run(device, tmp, card) -> tuple[dict, dict]:
    """(a) the synthetic learning run's functions: Car, momentum SGD,
    LEARN_STEPS steps at B=4 over LEARN_FRAMES fixed frames, then
    LEARN_EVAL_FRAMES held-out frames -> (train launches, eval launches)."""
    print(f"[8a] learning run: tools/synthetic_smoke.py, Car, momentum "
          f"0.9, {LEARN_STEPS} steps at B={LEARN_BATCH} over "
          f"{LEARN_FRAMES} frames, {LEARN_EVAL_FRAMES} held-out frames")
    sm = synthetic_smoke
    config = sm.make_config("Car")
    frames = sm.Frames(config, "Car")
    optimizer = sm.make_optimizer(config, 0.005, LEARN_STEPS)
    reset_launches()
    run = sm.train(config, frames, optimizer, steps=LEARN_STEPS,
                   num_frames=LEARN_FRAMES, batch=LEARN_BATCH, device=device,
                   log_every=LEARN_LOG_EVERY, echo=lambda line: None)
    train_launches = launch_counts()
    losses = [row[1] for row in run.log]
    print(f"  {LEARN_STEPS} steps in {run.seconds} s: "
          f"{LEARN_STEPS / run.seconds} steps/s, "
          f"{LEARN_STEPS * LEARN_BATCH / run.seconds} frames/s [{card}]; "
          f"launches {train_launches}")
    print("  loss every %d steps: %s" % (LEARN_LOG_EVERY, " ".join(
        f"{v:.4f}" for v in losses)))
    check(all(math.isfinite(v) for row in run.log for v in row[1:4]),
          f"non-finite losses: {run.log}")
    check(losses[-1] < 0.5 * losses[0],
          f"the loss fell from {losses[0]} to {losses[-1]} only")
    check(train_launches["run_copy"] == LEARN_STEPS
          and train_launches["dense_build"] == LEARN_STEPS
          and train_launches["vfe_fused"] == 0,
          f"train launches {train_launches}, want run_copy and dense_build "
          f"{LEARN_STEPS} each")
    reset_launches()
    held_out = sm.evaluate(config, run.state.model, frames,
                           eval_frames=LEARN_EVAL_FRAMES, batch=LEARN_BATCH,
                           device=device)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    n_batches = LEARN_EVAL_FRAMES // LEARN_BATCH
    check(eval_launches["vfe_fused"] == n_batches
          and eval_launches["dense_build"] == n_batches
          and eval_launches["run_copy"] == 0,
          f"eval launches {eval_launches}, want vfe_fused and dense_build "
          f"{n_batches} each")
    ap = sm.score(held_out, "Car")
    ap_cli = sm.score_dumps(*sm.dump_labels(
        held_out, os.path.join(tmp, "learning_run")), "Car",
        echo=lambda line: None)
    check(all(ap_equal(ap_cli[k], v) for k, v in ap.items()),
          f"cli.eval {ap_cli} vs in-process {ap}")
    print(f"  held out: {sum(f.num_det for f in held_out)} detections, "
          f"{sum(f.num_gt for f in held_out)} GT; moderate AP (in process "
          f"= cli.eval): {json.dumps(ap)}; launches {eval_launches}")
    del run
    return train_launches, eval_launches


def phase_host_voxelizer(frames, device, tmp, card) -> dict:
    """(b) the native voxelizer against voxelize_np at the full Car grid,
    both voxelizers' host frames/s, and a Trainer epoch with
    train.host_voxelize on phase 6's tree -> its launches."""
    print("[8b] host voxelizer: native build, bit-equal to voxelize_np, "
          "host frames/s; a Trainer epoch with train.host_voxelize")
    from voxelnet_tpu_torch import native

    t0 = time.perf_counter()
    fn = resolve_host_voxelizer("native")
    print(f"  native built and loaded in {time.perf_counter() - t0} s by "
          f"{native.compiler()}")
    config = get_config("Car")
    spec = VoxelGridSpec.from_object_config(config.object)
    K = config.data.max_voxels
    points, num = predict.stage_points(frames, config,
                                       np.random.default_rng(SEED))
    staged = [p[:n] for p, n in zip(points, num)]
    for i, p in enumerate(staged):
        a, b = voxelize_np(p, spec, K), fn(p, spec, K)
        for name, x, y in zip(a._fields, a, b):
            check(np.array_equal(x, y) and np.asarray(x).dtype
                  == np.asarray(y).dtype,
                  f"frame {i}: native {name} differs from voxelize_np")
    print(f"  native == voxelize_np on {len(staged)} frames "
          f"({[int(n) for n in num]} points, "
          f"{[int(fn(p, spec, K).num_voxels) for p in staged]} voxels)")
    rates = {}
    for name, f in (("numpy", voxelize_np), ("native", fn)):
        t0 = time.perf_counter()
        for _ in range(HOST_VOX_REPS):
            for p in staged:
                f(p, spec, K)
        rates[name] = HOST_VOX_REPS * len(staged) / (time.perf_counter()
                                                     - t0)
    print(f"  host voxelizer frames/s on one thread, Car grid, "
          f"{K} slots: numpy {rates['numpy']}, native {rates['native']} "
          f"({os.cpu_count()} host cores)")

    data = os.path.join(tmp, "kitti")
    hv = get_config("Car", train={"host_voxelize": True, "num_epochs": 1},
                    data={"host_voxelizer": "native"})
    reset_launches()
    out = io.StringIO()
    with Trainer(hv, os.path.join(data, "training"),
                 os.path.join(data, "validation"),
                 exp_dir=os.path.join(tmp, "exp_host_voxelize"),
                 device=device) as tr, contextlib.redirect_stdout(out):
        tr.train(print_interval=1, summary_interval=1000, val_interval=2)
        steps = tr.timings["epoch_steps"]
        epoch_s = tr.timings["epoch_s"]
    torch.cuda.synchronize()
    launches = launch_counts()
    logged = [line for line in out.getvalue().splitlines()
              if line.startswith(("Train ", "Epoch "))]
    metrics = [float(v) for line in logged for v in re.findall(
        r"(?:loss|reg|cls|avg_val_loss) (\S+)", line)]
    print("\n".join(f"    {line}" for line in logged))
    want_steps = TRAINER_FILES["training"] // hv.train.batch_size
    check(steps == [want_steps], f"host_voxelize epoch steps {steps}")
    check(len(metrics) == 3 * want_steps + 1
          and all(math.isfinite(v) for v in metrics),
          f"host_voxelize trainer metrics missing or not finite: {metrics}")
    check(launches["run_copy"] == 0 and launches["dense_build"] > 0
          and launches["vfe_fused"] == 0,
          f"host_voxelize trainer launches {launches}: want no run_copy")
    print(f"  Trainer epoch, Car B=2, host_voxelize: {epoch_s[0]} s, "
          f"launches {launches} [{card}]")
    return launches


def phase_ghost_inference(frames, device) -> dict:
    """(c) compat.bn_over_padding inference, Car B=2: the run-copy table
    and the table VFE, no fused kernel -> its launches."""
    print("[8c] compat.bn_over_padding inference: Car, bf16, B=2")
    config = get_config("Car", compat={"bn_over_padding": True})
    model = make_model(config, device)
    reset_launches()
    det = predict.predict(make_inference_fn(config, device), model,
                          frames[:2], config, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    launches = launch_counts()
    counts = check_detections(det, config, 2)
    check(launches["run_copy"] > 0 and launches["dense_build"] > 0
          and launches["vfe_fused"] == 0,
          f"bn_over_padding inference launches {launches}")
    print(f"  valid detections {counts}; launches {launches}")
    phase_small_reference(device, compat={"bn_over_padding": True})
    return launches


# ---- phase 9: reference API, viz trainer with the raster check, raw drive

# phase 9: (b) the augmentation timing's draws a frame; (c) the raw drive's
# frames and points a frame
AUG_DRAWS = 20
RAW_FRAMES = 8
RAW_POINTS = 16384
KITTI_CALIB = """P0: 700 0 600 0 0 700 180 0 0 0 1 0
P1: 700 0 600 0 0 700 180 0 0 0 1 0
P2: 700 0 600 0 0 700 180 0 0 0 1 0
P3: 700 0 600 0 0 700 180 0 0 0 1 0
R0_rect: 1 0 0 0 1 0 0 0 1
Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0
Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0
"""


def by_score(boxes: np.ndarray, scores: np.ndarray):
    """Detections in score order (ties by x): top-k ties have no order on
    the card."""
    order = np.lexsort((boxes[:, 0], -scores))
    return boxes[order], scores[order]


def phase_reference_api(frames, device) -> dict:
    """(a) reference_api at full Car width on the card: pcl_to_voxels
    against voxelize_np, RPN3D + make_inference_fn on the vendored frames,
    and generate_targets, nms, deltas_to_boxes_3d and smooth_L1_loss on
    the card against their CPU run -> the inference's launches."""
    from voxelnet_tpu_torch import reference_api as ref

    print("[9a] reference_api on the card: Car, bf16, grid 10x400x352, "
          "65536 points, 16384 voxels")
    # every score kept: random weights score no box above the preset's 0.96
    config = get_config("Car", rpn={"score_thres": 0.0})
    car = ref.get_cfg_defaults("Car")
    spec = VoxelGridSpec.from_object_config(car.object)
    vox = ref.pcl_to_voxels(frames[0], "Car",
                            rng=np.random.default_rng(SEED))
    want = voxelize_np(frames[0], spec, shuffle=True,
                       rng=np.random.default_rng(SEED))
    for key, w in (("feature_buffer", want.features),
                   ("coordinate_buffer", want.coords),
                   ("number_buffer", want.counts)):
        check(np.array_equal(vox[key], w),
              f"pcl_to_voxels {key} differs from voxelize_np")
    model = ref.build_model(config, seed=SEED, device=device)
    randomize_bn_(model, torch.Generator().manual_seed(SEED + 1))
    check(isinstance(model, ref.RPN3D), "build_model did not give an RPN3D")
    reset_launches()
    det = predict.predict(ref.make_inference_fn(config, device), model,
                          frames, config, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    launches = launch_counts()
    counts = check_detections(det, config, len(frames))
    check(launches["vfe_fused"] > 0 and launches["dense_build"] > 0,
          f"RPN3D inference launches {launches}")
    check(sum(counts) > 0, "RPN3D gave no detections at score_thres 0.0")
    print(f"  pcl_to_voxels == voxelize_np ({len(vox['number_buffer'])} "
          f"voxels); RPN3D detections {counts}; launches {launches}")

    rng = np.random.default_rng(SEED + 9)
    anchors = ref.generate_anchors("Car")
    gt, mask = synthetic_gt(rng, car, 2)
    labels = [kitti.boxes_to_label_lines(g[m], ["Car"] * int(m.sum()),
                                         coordinate="lidar")
              for g, m in zip(gt, mask)]
    shape = (car.object.feature_height, car.object.feature_width)
    tg = ref.generate_targets(labels, shape, anchors, device=device)
    tc = ref.generate_targets(labels, shape, anchors, device="cpu")
    check(np.array_equal(tg[0], tc[0]) and np.array_equal(tg[1], tc[1]),
          "generate_targets: the masks differ between the card and the CPU")
    t_err = float(np.abs(tg[2] - tc[2]).max())
    check(t_err <= 1e-5 and tg[0].sum() >= 10,
          f"generate_targets: targets {t_err} apart, {tg[0].sum()} pos")
    deltas = rng.normal(0, 0.3, (2,) + shape + (14,)).astype(np.float32)
    bg = ref.deltas_to_boxes_3d(deltas, anchors, device=device)
    bc = ref.deltas_to_boxes_3d(deltas, anchors, device="cpu")
    b_err = float(np.abs(bg - bc).max())
    check(b_err <= 1e-4, f"deltas_to_boxes_3d: {b_err} apart")
    scores = rng.uniform(0, 1, bc.shape[1]).astype(np.float32)
    kg = by_score(*ref.nms(bc[0], scores, top_k=100, device=device))
    kc = by_score(*ref.nms(bc[0], scores, top_k=100, device="cpu"))
    check(len(kg[0]) == len(kc[0]) == 100
          and np.array_equal(kg[1], kc[1])
          and np.abs(kg[0] - kc[0]).max() <= 1e-5,
          "nms: the card's detections differ from the CPU's")
    lg = ref.smooth_L1_loss(deltas, deltas[::-1], device=device)
    lc = ref.smooth_L1_loss(deltas, deltas[::-1], device="cpu")
    l_err = float(np.abs(lg - lc).max())
    check(l_err <= 1e-6, f"smooth_L1_loss: {l_err} apart")
    print(f"  card vs CPU: generate_targets masks equal, targets {t_err} "
          f"apart ({int(tg[0].sum())} positives); deltas_to_boxes_3d "
          f"{b_err}; nms 100 of {len(scores)} equal by score and box; "
          f"smooth_L1_loss {l_err}")
    return launches


def time_augmentation(data: str, config) -> dict:
    """Host ms a frame of augment_pointcloud over the split's frames,
    AUG_DRAWS draws each, with the raster collision check and with the
    exact IoU (the same Generators), and ms a box-pair check of each."""
    split = os.path.join(data, "training")
    tags = sorted(f[:-4] for f in os.listdir(os.path.join(split,
                                                           "velodyne")))
    clouds = [kitti.read_point_cloud(os.path.join(split, "velodyne",
                                                  t + ".bin")) for t in tags]
    boxes = []
    for t in tags:
        with open(os.path.join(split, "label_2", t + ".txt")) as f:
            boxes.append(kitti.parse_label_lines(f.readlines(), "Car",
                                                 "camera"))
    out = {}
    for name, iou in (("raster", lambda a, b: augment_lib.raster_iou_2d(
            a, b, config.object)), ("exact", augment_lib.rotated_iou_2d)):
        pairs = [0, 0.0]

        def counted(a, b, _iou=iou, _pairs=pairs):
            t0 = time.perf_counter()
            v = _iou(a, b)
            _pairs[0] += 1
            _pairs[1] += time.perf_counter() - t0
            return v

        t0 = time.perf_counter()
        per_box = 0
        for d in range(AUG_DRAWS):
            for i, (pts, gt) in enumerate(zip(clouds, boxes)):
                rng = np.random.default_rng([SEED, d, i])
                _, _, tag = augment_lib.augment_pointcloud(pts, gt, rng,
                                                           counted)
                per_box += tag.startswith("aug_1_")
        n = AUG_DRAWS * len(clouds)
        out[name] = {"ms_per_frame": (time.perf_counter() - t0) / n * 1e3,
                     "pair_checks": pairs[0],
                     "ms_per_pair": pairs[1] / max(pairs[0], 1) * 1e3,
                     "per_box_frames": per_box, "frames": n}
    return out


def phase_vis_trainer(frames, device, tmp, card) -> dict:
    """(b) one Trainer epoch at full Car width, B=2, on phase 6's tree
    with camera images and calib files added: num_vis_dump=2,
    train.augment with compat.raster_collision -> its launches."""
    print("[9b] viz trainer: one epoch, Car, bf16, B=2, num_vis_dump=2, "
          "augment + compat.raster_collision, images and calib added")
    data = os.path.join(tmp, "kitti")
    calib = os.path.join(data, "calib")
    os.makedirs(calib, exist_ok=True)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:375, 0:1242]
    os.makedirs(os.path.join(data, "validation", "image_2"), exist_ok=True)
    for split in TRAINER_FILES:
        for tag in sorted(f[:-4] for f in os.listdir(
                os.path.join(data, split, "velodyne"))):
            with open(os.path.join(calib, tag + ".txt"), "w") as f:
                f.write(KITTI_CALIB)
            if split == "validation":
                img = np.stack([xx // 5, yy // 2, (xx + yy) // 7], -1) % 256
                img = (img + rng.integers(0, 16, img.shape)).astype(np.uint8)
                image_io.write_png_rgb(os.path.join(data, split, "image_2",
                                                    tag + ".png"), img)
    config = get_config("Car", train={"augment": True, "num_epochs": 1},
                        compat={"raster_collision": True},
                        data={"calib_dir": calib})
    aug = time_augmentation(data, config)
    for name, a in aug.items():
        print(f"  augmentation, {name} collision check: {a['ms_per_frame']}"
              f" ms a frame (host, one thread; {a['per_box_frames']} of "
              f"{a['frames']} draws in the per-box branch, "
              f"{a['pair_checks']} box-pair checks at {a['ms_per_pair']} ms"
              f" each) [{os.cpu_count()} host cores]")
    exp = os.path.join(tmp, "exp_vis")
    reset_launches()
    out = io.StringIO()
    with Trainer(config, os.path.join(data, "training"),
                 os.path.join(data, "validation"), exp_dir=exp,
                 device=device) as tr, contextlib.redirect_stdout(out):
        tr.train(print_interval=1, summary_interval=1, val_interval=2,
                 num_vis_dump=2)
        epoch_s = tr.timings["epoch_s"]
        dump_s = tr.timings["val_dump_s"]
    torch.cuda.synchronize()
    launches = launch_counts()
    logged = [line for line in out.getvalue().splitlines()
              if line.startswith(("Train ", "Epoch "))]
    metrics = [float(v) for line in logged for v in re.findall(
        r"(?:loss|reg|cls|avg_val_loss) (\S+)", line)]
    print("\n".join(f"    {line}" for line in logged))
    want_steps = TRAINER_FILES["training"] // config.train.batch_size
    check(len(metrics) == 3 * want_steps + 1
          and all(math.isfinite(v) for v in metrics),
          f"viz trainer metrics missing or not finite: {metrics}")
    check(launches["run_copy"] > 0 and launches["dense_build"] > 0,
          f"viz trainer launches {launches}")
    vis = os.path.join(exp, "vis", "1")
    names = sorted(os.listdir(vis))
    val_tags = sorted(f[:-4] for f in os.listdir(
        os.path.join(data, "validation", "velodyne")))[:2]
    want = sorted(f"{t}_{k}.png" for t in val_tags
                  for k in ("front", "bv", "heatmap"))
    check(names == want, f"vis triplets {names}, want {want}")
    obj = config.object
    shapes = {n: image_io.read_png_bgr(os.path.join(vis, n)).shape
              for n in names}
    check(shapes[f"{val_tags[0]}_front.png"] == (375, 1242, 3)
          and shapes[f"{val_tags[0]}_bv.png"] == (obj.height * 2,
                                                  obj.width * 2, 3)
          and shapes[f"{val_tags[0]}_heatmap.png"] == (
              obj.feature_height * 2, obj.feature_width * 2, 3),
          f"vis image shapes {shapes}")
    check("cv2" not in sys.modules, "cv2 was imported")
    print(f"  epoch {epoch_s[0]} s, val dump with 2 triplets {dump_s[0]} s;"
          f" triplets decode through image_io: {shapes}; cv2 not imported;"
          f" launches {launches} [{card}]")
    return launches


def write_raw_drive(root: str, rng: np.random.Generator) -> str:
    """A synthetic KITTI raw drive as tests/test_raw_to_kitti.py builds
    one: RAW_FRAMES velodyne frames of RAW_POINTS uniform points, two Car
    tracklets, the drive's calib pair -> its date dir."""
    date = os.path.join(root, "2011_09_26")
    sync = os.path.join(date, "2011_09_26_drive_0001_sync")
    velo = os.path.join(sync, "velodyne_points", "data")
    os.makedirs(velo)
    for i in range(RAW_FRAMES):
        rng.uniform([0, -20, -2, 0], [60, 20, 1, 1], (RAW_POINTS, 4)).astype(
            np.float32).tofile(os.path.join(velo, f"{i:010d}.bin"))
    items = []
    for (h, w, l), x0, y0, rz in (((1.5, 1.6, 3.9), 18.0, 2.0, 0.3),
                                  ((1.4, 1.7, 4.2), 30.0, -4.0, -0.8)):
        poses = "".join(
            f"<item><tx>{x0 + 0.5 * i}</tx><ty>{y0}</ty><tz>-1.6</tz>"
            f"<rx>0</rx><ry>0</ry><rz>{rz}</rz><state>2</state>"
            f"<occlusion>0</occlusion><occlusion_kf>0</occlusion_kf>"
            f"<truncation>0</truncation></item>" for i in range(RAW_FRAMES))
        items.append(
            f"<item><objectType>Car</objectType><h>{h}</h><w>{w}</w>"
            f"<l>{l}</l><first_frame>0</first_frame><poses><count>"
            f"{RAW_FRAMES}</count><item_version>2</item_version>{poses}"
            "</poses><finished>1</finished></item>")
    with open(os.path.join(sync, "tracklet_labels.xml"), "w") as f:
        f.write('<?xml version="1.0"?><boost_serialization><tracklets '
                f'class_id="0"><count>{len(items)}</count><item_version>1'
                "</item_version>" + "".join(items)
                + "</tracklets></boost_serialization>")
    p2 = [700.0, 0, 600, 0, 0, 700, 180, 0, 0, 0, 1, 0]
    with open(os.path.join(date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("P_rect_02: " + " ".join(map(str, p2)) + "\n"
                "R_rect_00: 1 0 0 0 1 0 0 0 1\n")
    with open(os.path.join(date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0.01 -0.05 -0.29\n")
    return date


def phase_raw_to_kitti(device, tmp, card) -> dict:
    """(c) data.raw_to_kitti on a synthetic raw drive, then cli.train for
    one epoch on its output (Car, bf16, B=2) -> its launches."""
    from voxelnet_tpu_torch.data import raw_to_kitti

    print(f"[9c] raw_to_kitti on a synthetic raw drive ({RAW_FRAMES} "
          f"frames), then cli.train one epoch on its output")
    raw = write_raw_drive(os.path.join(tmp, "raw"),
                          np.random.default_rng(SEED))
    out = os.path.join(tmp, "kitti_from_raw")
    printed = run_cli(raw_to_kitti.main, ["--raw-root", raw, "--out-dir",
                                          out, "--copy", "--val-frac",
                                          "0.25"])
    n_val = math.ceil(RAW_FRAMES * 0.25)
    check(f"'training': {RAW_FRAMES - n_val}, 'validation': {n_val}"
          in printed, f"raw_to_kitti printed {printed!r}")
    cfg = os.path.join(tmp, "raw_epochs1.yaml")
    with open(cfg, "w") as f:
        f.write("train: {num_epochs: 1}  # Car preset else\n")
    exp = os.path.join(tmp, "exp_raw")
    reset_launches()
    logged = run_cli(train_cli.main, [
        "--data-dir", out, "--exp-dir", exp, "--cfg", cfg, "--device",
        device.type, "--print-interval", "1"])
    torch.cuda.synchronize()
    launches = launch_counts()
    metrics = [float(v) for v in re.findall(
        r"(?:loss|reg|cls|avg_val_loss) (\S+)", logged)]
    check(metrics and all(math.isfinite(v) for v in metrics),
          f"cli.train on raw_to_kitti's output: metrics {metrics}")
    val = sorted(os.listdir(os.path.join(out, "validation", "label_2")))
    dumped = sorted(os.listdir(os.path.join(exp, "preds", "1", "data")))
    check(dumped == val and os.listdir(os.path.join(exp, "checkpoints"))
          == ["0"], f"cli.train on raw_to_kitti's output: dumps {dumped}")
    check(launches["run_copy"] > 0 and launches["dense_build"] > 0,
          f"raw_to_kitti trainer launches {launches}")
    print(f"  {printed.strip()}; cli.train: {len(metrics)} metrics, all "
          f"finite; {len(dumped)} val dumps; launches {launches} [{card}]")
    return launches


# ---- phase 10: sparse1, block 1 from the voxel table

# phase 10 (b): a detection of phase 4's conv3d run is matched by a sparse1
# one of the same frame within these score and box gaps (m, rad)
MATCH_SCORE = 2e-2
MATCH_BOX = 0.1
SPARSE_WINDOW = (96, 88)   # (x0, wloc) of the w_window check


def vendored_table(config, model, frames, device, batch: int):
    """The fused VFE's (voxelwise (B, K, 128) bf16, coords, counts) of
    `batch` vendored frames (cycled) at full Car width."""
    points, num = predict.stage_points(
        [frames[i % len(frames)] for i in range(batch)], config,
        np.random.default_rng(SEED))
    prep = prepare(torch.from_numpy(points).to(device),
                   torch.from_numpy(num).to(device),
                   VoxelGridSpec.from_object_config(config.object),
                   config.data.max_voxels)
    fln = model.feature_net
    w = (*vfe_fused.fold_layer(fln.vfe1.fcn, fln.vfe1.bn, 8),
         *vfe_fused.fold_layer(fln.vfe2.fcn, fln.vfe2.bn, 32))
    feat = vfe_fused.vfe_fused(prep.sorted_planar, prep.run_start,
                               prep.num_voxels, prep.counts, *w,
                               config.object.points_per_voxel)
    return feat, prep.coords, prep.counts


def sparse_block1_inputs(config, model, frames, device, batch: int):
    """Block 1's inputs in sparse1 inference at `batch` vendored frames:
    (feat, coords, counts, occ, vals (B, K, 27, Cout) bf16, its product's
    weight matrix, f32 bias)."""
    conv = model.middle.ConvBlock3D_0.Conv_0
    feat, coords, counts = vendored_table(config, model, frames, device,
                                          batch)
    wmat = weight_matrix(conv.weight.to(torch.bfloat16))
    occ = sparse_conv.occupancy_map(coords, counts,
                                    tuple(config.object.grid_size))
    vals = (feat @ wmat).view(*feat.shape[:2], 27, -1)
    return feat, coords, counts, occ, vals, wmat, conv.bias.float()


def check_sparse_conv(tag, vals, coords, counts, occ, bias, grid, stride,
                      pad) -> float:
    """The kernel torch.equal to sparse_conv_plain in bf16 and f32, on the
    whole W and SPARSE_WINDOW, with the ReLU off and on; the fused ReLU
    equal to the ReLU of the unfused output, the window to the full
    output's columns -> the largest error."""
    x0, wloc = SPARSE_WINDOW
    err = 0.0
    for v in (vals, vals.float()):
        full = {}
        for window in (None, SPARSE_WINDOW):
            for relu in (False, True):
                got = sparse_conv.sparse_conv(v, coords, counts, occ, bias,
                                              stride, pad, window, relu)
                want = sparse_conv.sparse_conv_plain(
                    v, coords, counts, bias, grid, stride, pad, window, relu)
                torch.cuda.synchronize()
                err = max(err, float((got.float() - want.float()).abs()
                                     .max()))
                check(torch.equal(got, want),
                      f"sparse_conv {tag} {v.dtype} window {window} relu "
                      f"{relu} differs from plain")
                if window is None:
                    full[relu] = got
                else:
                    check(torch.equal(got, full[relu][:, :, :,
                                                      x0:x0 + wloc]),
                          f"sparse_conv {tag} {v.dtype} relu {relu}: the "
                          "window differs from the full output's columns")
            print(f"  sparse_conv {tag} {v.dtype} window {window}: "
                  f"bit-equal over {got.numel()} elements, relu off and on")
        check(torch.equal(full[True], torch.relu(full[False])),
              f"sparse_conv {tag} {v.dtype}: the fused ReLU differs from "
              "relu(plain)")
    return err


def phase_sparse_kernels(config, model, frames, device, card):
    """(a) The occupancy kernel and both sparse-conv kernels against their
    plain versions at Car B=2 and at B=8, the batch of inference and of
    the train step -> (times, errs, bounds) in phase 3's form."""
    print("[10] sparse1 (a): occupancy_map, sparse_conv and its gradient "
          "against their plain versions (Car, B=2 and B=8, fused VFE on the "
          "vendored frames)")
    grid = tuple(config.object.grid_size)
    D, H, W = grid
    n_cells = D * H * W
    conv = model.middle.ConvBlock3D_0.Conv_0
    stride, pad = conv.stride[0], conv.padding[0]
    info = {str(t).removeprefix("torch."): sparse_conv.kernel_info(t)
            for t in (torch.bfloat16, torch.float32)}
    print(f"  sparse_conv_fwd_kernel: {info}")
    times, errs, bounds = {}, {}, {}
    for B, tag in ((2, ""), (8, "_b8")):
        with torch.inference_mode():
            feat, coords, counts, occ, vals, wmat, bias = \
                sparse_block1_inputs(config, model, frames, device, B)
            cin, cout = feat.shape[-1], vals.shape[-1]
            occ_plain = sparse_conv.occupancy_map_plain(coords, counts, grid)
            torch.cuda.synchronize()
            check(torch.equal(occ, occ_plain),
                  f"occupancy_map B={B} differs from plain")
            print(f"  occupancy_map B={B}: bit-equal over {occ.numel()} "
                  "cells")
            err = check_sparse_conv(f"B={B}", vals, coords, counts, occ, bias,
                                    grid, stride, pad)
            if not tag:
                errs.update(sparse_conv=err, occupancy_map=0.0)
            vals32 = vals.float()
            # the occupancy map's one torch call: a fill of -1 and one
            # index_put_ of the live rows' k at their cells
            live_rows = counts.reshape(-1) > 0
            occ_cells = ((coords[..., 0].long() * H + coords[..., 1]) * W
                         + coords[..., 2] + torch.arange(
                             B, device=device)[:, None] * n_cells
                         ).reshape(-1)[live_rows]
            occ_rows = torch.arange(counts.shape[1], dtype=torch.int32,
                                    device=device).repeat(B)[live_rows]
            occ_one_call = occ.reshape(-1)

            def occ_kernel():
                return sparse_conv.occupancy_map(coords, counts, grid)

            def occ_torch():
                return occ_one_call.new_full(occ_one_call.shape,
                                             -1).index_put_((occ_cells,),
                                                            occ_rows)

            check(torch.equal(occ_torch(), occ_one_call),
                  f"occupancy_map B={B}: the one torch call differs")
            ops = device_ops(occ_kernel)
            print(f"  occupancy_map B={B}: device ops a call {ops}")
            check([(profile_step.port_kernel(name), calls)
                   for name, calls in ops.items()] == [("occupancy_map", 1)],
                  f"occupancy_map B={B}: a call ran {ops}, not one occupancy "
                  "kernel and no memset")

            def fwd(v, relu=False):
                return sparse_conv.sparse_conv(v, coords, counts, occ, bias,
                                               stride, pad, relu=relu)

            def fwd_plain(v):
                return sparse_conv.sparse_conv_plain(v, coords, counts, bias,
                                                     grid, stride, pad)

            got = fwd(vals)
            ids = torch.where(counts > 0, (coords[..., 0] * H
                                           + coords[..., 1]) * W
                              + coords[..., 2], n_cells).to(torch.int32)
            dense = dense_build.dense_build(feat, ids, n_cells).view(
                B, D, H, W, cin).permute(0, 4, 1, 2, 3)
            wcl = conv.weight.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last_3d)
            b16 = conv.bias.to(torch.bfloat16)
            # name -> (kernel, plain version, one torch call or None); the
            # plain sums (~14 ms a call at B=2) over 5 calls a window
            times.update({
                f"sparse_conv{tag}": (
                    timed(lambda: fwd(vals)),
                    timed(lambda: fwd_plain(vals), 5),
                    timed(lambda: torch.nn.functional.conv3d(
                        dense, wcl, b16, conv.stride, conv.padding))),
                f"sparse_conv{tag}_f32": (
                    timed(lambda: fwd(vals32)),
                    timed(lambda: fwd_plain(vals32), 5), None),
                f"occupancy_map{tag}": (
                    {**timed(occ_kernel), "host_us": host_us(occ_kernel)},
                    timed(lambda: sparse_conv.occupancy_map_plain(
                        coords, counts, grid)),
                    {**timed(occ_torch), "host_us": host_us(occ_torch)}),
            })
            # the taps that reach the output: the rows of vals the forward
            # reads, the rows of dout the gradient gathers
            sites = sparse_conv.tap_sites(coords, counts, stride, pad,
                                          tuple(got.shape[1:4]))
            hits = int((sites < got[..., 0].numel()).sum())
            live = int((counts > 0).sum())
            out_elems = got.numel()
            print(f"  B={B}: live voxels {live}, taps that reach the output "
                  f"{hits}")
            bounds.update({
                # the rows the taps read, the map, the bias, the output
                # written; one f32 add a tap and channel
                f"sparse_conv{tag}": bound(hits * cout * 2
                                           + nbytes(occ, bias)
                                           + out_elems * 2, hits * cout),
                f"sparse_conv{tag}_f32": bound(hits * cout * 4
                                               + nbytes(occ, bias)
                                               + out_elems * 4, hits * cout),
                f"occupancy_map{tag}": bound(nbytes(coords, counts, occ)),
            })
            g = torch.Generator(device=device).manual_seed(SEED)
            cot = torch.randn(tuple(got.shape), generator=g,
                              device=device).to(torch.bfloat16)
            dgot = sparse_conv.sparse_conv_grad(cot, coords, counts, stride,
                                                pad)
            dwant = sparse_conv.sparse_conv_grad_plain(cot, coords, counts,
                                                       stride, pad)
            torch.cuda.synchronize()
            check(torch.equal(dgot, dwant),
                  f"sparse_conv_grad B={B} differs from plain")
            print(f"  sparse_conv_grad B={B}: bit-equal over {dgot.numel()} "
                  "elements")
            if not tag:
                errs["sparse_conv_grad"] = float(
                    (dgot.float() - dwant.float()).abs().max())
            del dwant
            flat = torch.cat([cot.reshape(-1, cout),
                              cot.new_zeros((1, cout))])
            rows = sites.reshape(-1)
            times[f"sparse_conv_grad{tag}"] = (
                timed(lambda: sparse_conv.sparse_conv_grad(
                    cot, coords, counts, stride, pad)),
                timed(lambda: sparse_conv.sparse_conv_grad_plain(
                    cot, coords, counts, stride, pad), 5),
                timed(lambda: flat.index_select(0, rows)))
            # the rows of dout the taps gather, the table, all of dvals
            # written
            bounds[f"sparse_conv_grad{tag}"] = bound(
                hits * cout * 2 + nbytes(coords, counts) + dgot.numel() * 2)
            del cot, dgot, flat
            if tag:
                del dense
                continue
            times["sparse_conv_relu"] = (timed(lambda: fwd(vals, True)),
                                         None, None)
            bounds["sparse_conv_relu"] = bounds["sparse_conv"]
            times.update({
                "sparse_conv_product": (timed(lambda: feat @ wmat), None,
                                        None),
                "sparse_conv_grid": (timed(lambda: dense_build.dense_build(
                    feat, ids, n_cells)), None, None),
            })
            bounds.update({
                # the live rows' product on the tensor cores, all of vals
                # written
                "sparse_conv_product": bound(
                    live * cin * 2 + nbytes(wmat, vals),
                    2 * live * cin * 27 * cout, torch.bfloat16),
                "sparse_conv_grid": bound(nbytes(feat, ids)
                                          + B * n_cells * cin * 2),
            })
            del dense
    for name, parts in times.items():
        print(f"  {name}: " + ", ".join(
            f"{what} {t['ms']} ms (device {t['device_ms']} ms"
            + (f", host {t['host_us']} us" if "host_us" in t else "") + ")"
            for what, t in zip(("kernel", "plain", "one torch call"), parts)
            if t is not None) + f" [{card}]")
    print("  one torch calls: sparse_conv cuDNN's Conv3d of block 1 on the "
          "dense grid at the same batch (built by dense_build, "
          "sparse_conv_grid at B=2), sparse_conv_grad one index_select of "
          "the rows, occupancy_map a fill of -1 and one index_put_ of the "
          "live rows")
    for name, (ms, by) in bounds.items():
        share = ms / times[name][0]["device_ms"]
        print(f"  {name}: bound {ms} ms ({by}) at these inputs, "
              f"{share:.1%} of it reached (profiler time)")
    return times, errs, bounds, info


def match_detections(got, want) -> dict:
    """Detections of two runs compared by score and box, not by slot (top-k
    and NMS ties, ROADMAP queue 3): per frame the valid counts, the sorted
    scores' largest gap, and the share of `want`'s detections that one of
    `got`'s matches within MATCH_SCORE and MATCH_BOX (overall and of each
    frame's 20 best), with the largest gaps of the matches."""
    out = {"counts": [], "sorted_score_gap": 0.0, "detections": 0,
           "matched": 0, "best20": 0, "best20_of": 0, "score_gap": 0.0,
           "box_gap": 0.0}
    for b in range(got.scores.shape[0]):
        gs = got.scores[b][got.valid[b]].float().cpu()
        gb = got.boxes[b][got.valid[b]].float().cpu()
        ws = want.scores[b][want.valid[b]].float().cpu()
        wb = want.boxes[b][want.valid[b]].float().cpu()
        out["counts"].append((len(gs), len(ws)))
        k = min(len(gs), len(ws))
        if k:
            out["sorted_score_gap"] = max(out["sorted_score_gap"], float(
                (gs.sort(descending=True).values[:k]
                 - ws.sort(descending=True).values[:k]).abs().max()))
        top = ws.argsort(descending=True)[:20]
        out["detections"] += len(ws)
        out["best20_of"] += len(top)
        if not (len(gs) and len(ws)):
            continue
        dscore = (ws[:, None] - gs[None]).abs()
        dbox = (wb[:, None] - gb[None]).abs().amax(-1)
        gap = torch.where(dscore <= MATCH_SCORE, dbox, math.inf).amin(1)
        hit = gap <= MATCH_BOX
        out["matched"] += int(hit.sum())
        out["best20"] += int(hit[top].sum())
        if hit.any():
            out["box_gap"] = max(out["box_gap"], float(gap[hit].max()))
            out["score_gap"] = max(out["score_gap"], float(torch.where(
                dbox <= MATCH_BOX, dscore, math.inf).amin(1)[hit].max()))
    return out


def phase_sparse_inference(model, frames, device, card, conv3d_dets,
                           tmp) -> tuple[dict, dict, dict]:
    """(b) Car inference with sparse1 through make_inference_fn (phase 4's
    calls) and cli.predict -> (its launches, {batch: frames/s}, {batch:
    print_profile's busy ms})."""
    print("[10] sparse1 (b): Car inference, bf16, 3 vendored frames, "
          "predict() and cli.predict --cfg")
    reset_launches()
    dets = {}
    for thres in (0.96, 0.0):
        config = get_config("Car", rpn={"score_thres": thres}, **SPARSE1)
        dets[thres] = predict.predict(make_inference_fn(config, device),
                                      model, frames, config,
                                      np.random.default_rng(SEED))
        torch.cuda.synchronize()
        counts = check_detections(dets[thres], config, len(frames))
        print(f"  score_thres {thres}: valid detections {counts}")
    cfg = os.path.join(tmp, "sparse1.yaml")
    with open(cfg, "w") as f:
        f.write("data: {middle_backend: sparse1}\n")
    out = run_cli(predict.main, ["--pcl", "sample:0", "--cfg", cfg,
                                 "--device", device.type])
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"  cli.predict --cfg: {out.splitlines()[0]}; launches {launches}")
    check_launched("sparse1 inference", launches,
                   ("vfe_fused", "occupancy_map", "sparse_conv"),
                   ("dense_build", "sparse_conv_grad"))
    m = match_detections(dets[0.0], conv3d_dets)
    print(f"  against phase 4's conv3d detections at score_thres 0 (score "
          f"within {MATCH_SCORE}, box within {MATCH_BOX}): {m}")
    check(m["detections"] > 0 and m["sorted_score_gap"] <= MATCH_SCORE
          and m["matched"] >= 0.5 * m["detections"],
          f"sparse1 detections differ from conv3d's: {m}")
    phase_small_reference(device, overrides=SPARSE1)
    print("  sparse1 inference times:")
    return (launches, *phase_timing(model, frames, device, card, SPARSE1))


def phase_sparse_train(frames, device, card, seed, tmp):
    """(c) The train step with sparse1 at Car B=8, one tiny f32 step on the
    card against the CPU, step times; cli.train (the Trainer) for one
    epoch and two gloo ranks -> the launches of the step, the trainer and
    rank 0."""
    ran, idle = ("run_copy", "occupancy_map", "sparse_conv",
                 "sparse_conv_grad"), (
        "dense_build",)
    launches = phase_train(frames, device, card, seed, SPARSE1, batch_size=8,
                           ran=ran, idle=idle, label="10c")
    phase_train_small_reference(frames, device, seed, SPARSE1)
    phase_train_timing(frames, device, card, seed, SPARSE1, batches=(8,))

    cfg = os.path.join(tmp, "sparse1_train.yaml")
    with open(cfg, "w") as f:
        f.write("data: {middle_backend: sparse1}\ntrain: {num_epochs: 1}\n")
    exp = os.path.join(tmp, "exp_sparse1")
    reset_launches()
    out = run_cli(train_cli.main, [
        "--data-dir", os.path.join(tmp, "kitti"), "--exp-dir", exp,
        "--device", device.type, "--cfg", cfg, "--print-interval", "1"])
    torch.cuda.synchronize()
    trainer = launch_counts()
    logged = [line for line in out.splitlines()
              if line.startswith(("Train ", "Epoch "))]
    metrics = [float(v) for line in logged for v in re.findall(
        r"(?:loss|reg|cls|avg_val_loss) (\S+)", line)]
    print("  cli.train, 1 epoch:" + "".join(f"\n    {x}" for x in logged)
          + f"\n  launches {trainer}")
    check_launched("sparse1 cli.train", trainer, ran, idle)
    check(metrics and all(math.isfinite(v) for v in metrics),
          f"sparse1 cli.train metrics {metrics}")
    check(os.listdir(os.path.join(exp, "checkpoints")) == ["0"],
          "sparse1 cli.train wrote no checkpoint 0")

    run = {"name": "sparse1", "overrides": SPARSE1, "batch": 4,
           "seed": seed, "steps": 2, "timed": 0}
    t0 = time.perf_counter()
    outs = [o["sparse1"] for o in run_dp_workers(tmp, "sparse1", "gloo",
                                                 "cuda:0", [run])]
    check_ranks_agree("sparse1, 2 gloo ranks x B=2", outs, ran, idle)
    print(f"  2 gloo ranks on cuda:0, Car B=2 a rank, 2 steps "
          f"({time.perf_counter() - t0} s with the ranks' start): losses "
          f"{[m['loss'] for m in outs[0]['metrics']]}, ranks bit-identical,"
          f" launches per rank {[o['launches'] for o in outs]}")
    return launches, trainer, outs[0]["launches"]


# ---- phase 11: spatial W-sharding, system.num_model_shards > 1

# (a) the inference batch and its timed calls a rank
SPATIAL_BATCH = 8
SPATIAL_TIMED = 5
# the sharded maps against one process, as shares of the one-process
# logits' spread (std): bf16 slab convs may take other cuDNN algorithms
# and sum in another order (a zero or wrong halo moves an edge column by
# about the spread itself); f32 (c) as tests/test_torch_model.py holds f32
MAP_GATES = {"bf16": (0.1, 0.01), "f32": (1e-4, 1e-5)}


def stage_frames(config, frames, batch: int):
    return predict.stage_points([frames[i % len(frames)]
                                 for i in range(batch)], config,
                                np.random.default_rng(SEED))


def eval_maps(config, model, points, num, device):
    """The eval-mode forward's (cls, reg) of the run-copy voxel table."""
    vox = voxelize_table(torch.as_tensor(points, device=device),
                         torch.as_tensor(num, device=device),
                         VoxelGridSpec.from_object_config(config.object),
                         config.data.max_voxels)
    with torch.no_grad():
        return model.eval()(vox.features, vox.coords, vox.counts)


def compare_maps(name: str, got, want, gate: str) -> dict:
    """Largest and median |got - want| as shares of want's spread, and the
    share of bit-equal elements; fatal past MAP_GATES[gate]."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"{name}: shape {got.shape} vs "
          f"{want.shape}")
    spread = float(want.std())
    diff = (got - want).abs()
    out = {"max": float(diff.max()) / spread,
           "median": float(diff.median()) / spread,
           "equal": float((diff == 0).float().mean())}
    top, med = MAP_GATES[gate]
    check(out["max"] <= top and out["median"] <= med,
          f"{name}: sharded maps off one process's by {out} of the spread "
          f"(gates {top}, {med})")
    return out


def check_spatial_infer(tag: str, run: dict, outs: list[dict], job: str,
                        frames, device, card) -> dict:
    """An inference run of phase 11 against one process on the card:
    detections matched by score and box, the eval forward's maps within
    MAP_GATES' bf16 shares of the spread, each rank's launches; prints
    them with the all-reduces of a call by group and the call times ->
    rank 0's launches."""
    class_name = run.get("class_name", "Car")
    middle = ("sparse1" if run["overrides"].get("data", {}).get(
        "middle_backend") == "sparse1" else "conv3d")
    config = get_config(class_name, **run["overrides"])
    model = make_model(config, device)
    points, num = stage_frames(config, frames, run["batch"])
    want = make_inference_fn(config, device)(model, points, num)
    saved = torch.load(f"{job}.{run['name']}.pt", weights_only=True)
    got = type(want)(*saved["det"])
    check_detections(got, config, run["batch"])
    m = match_detections(got, want)
    check(m["detections"] > 0 and m["sorted_score_gap"] <= MATCH_SCORE
          and m["matched"] >= 0.5 * m["detections"],
          f"{tag} {class_name} {middle}: sharded detections differ from "
          f"one process's: {m}")
    cls, reg = eval_maps(config, model, points, num, device)
    maps = {"cls": compare_maps(f"{tag} {middle} cls", saved["cls"], cls,
                                "bf16"),
            "reg": compare_maps(f"{tag} {middle} reg", saved["reg"], reg,
                                "bf16")}
    del model
    ran, idle = (("vfe_fused", "occupancy_map", "sparse_conv"),
                 ("dense_build", "run_copy", "sparse_conv_grad")
                 ) if middle == "sparse1" else (
        ("vfe_fused", "dense_build"),
        ("run_copy", "sparse_conv", "sparse_conv_grad", "occupancy_map"))
    for r, o in enumerate(outs):
        check_launched(f"{tag} {middle} rank {r}", o[run["name"]]
                       ["launches"], ran, idle)
    a = [o[run["name"]] for o in outs]
    slabs = [w_window(config, ProcessMesh(run["model"], r, run["model"],
                                          model_index=r))[1]
             for r in range(run["model"])]
    print(f"  {tag} {class_name} {middle}, bf16 B={run['batch']}, "
          f"1 x {run['model']} (W slabs {slabs}): against one process, "
          f"detections {m}; eval maps (shares of the spread) {maps}; "
          f"launches per rank {[o['launches'] for o in a]}; all-reduces of "
          f"a call by group [count, bytes] per rank "
          f"{[o['all_reduces_by_group'] for o in a]}; median call "
          f"{[o['stage_ms']['total'] for o in a]} ms per rank (gloo "
          f"through the host, every rank on one card) [{card}]")
    print("    rank 0 stages: " + ", ".join(
        f"{k} {a[0]['stage_ms'][k]}" for k in STAGES) + " (ms)")
    return a[0]["launches"]


def phase_spatial(frames, device, seed, tmp, card) -> dict:
    """Phase 11 -> the launch counts of rank 0 of each sharded path."""
    print("[11] spatial W-sharding: 1 x 2 inference (Car bf16 B=8, conv3d "
          "and sparse1; tiny f32 maps) and 2 x 2 train steps (Car bf16 "
          "B=4, tiny f32) on cuda:0 over gloo, torchrun cli.train with "
          "num_model_shards 2, NCCL where cards allow; uneven slabs: Car "
          "1 x 3 conv3d and Pedestrian 1 x 4 sparse1 inference B=8, tiny "
          "f32 1 x 3 step")
    thres0 = {"rpn": {"score_thres": 0.0}}
    infer = {middle: {"name": f"infer-{middle}", "kind": "infer",
                      "overrides": merged(thres0, SPARSE1 if middle ==
                                          "sparse1" else {}),
                      "model": 2, "batch": SPATIAL_BATCH,
                      "timed": SPATIAL_TIMED}
             for middle in ("conv3d", "sparse1")}
    tiny_infer = {"name": "infer-tiny", "kind": "infer", "overrides": TINY,
                  "model": 2, "batch": 2, "timed": 0}
    launches = {}

    # (a) inference on a 1 x 2 mesh, and (c)'s tiny f32 maps
    t0 = time.perf_counter()
    job = os.path.join(tmp, "spatial_infer.json")
    outs = run_dp_workers(tmp, "spatial_infer", "gloo", "cuda:0",
                          [*infer.values(), tiny_infer])
    print(f"  (a) 2 ranks: {time.perf_counter() - t0} s with the ranks' "
          f"start")
    for middle, run in infer.items():
        launches[f"spatial_{middle}_inference_rank0"] = check_spatial_infer(
            "(a)", run, outs, job, frames, device, card)
    config = get_config("Car", **TINY)
    model = make_model(config, device)
    points, num = stage_frames(config, frames, 2)
    saved = torch.load(f"{job}.infer-tiny.pt", weights_only=True)
    cls, reg = eval_maps(config, model, points, num, device)
    maps = {"cls": compare_maps("(c) tiny cls", saved["cls"], cls, "f32"),
            "reg": compare_maps("(c) tiny reg", saved["reg"], reg, "f32")}
    print(f"  (c) tiny f32 grid, 1 x 2 eval maps against one process: "
          f"{maps}")
    del model

    # (b) train steps on a 2 x 2 mesh, and (c)'s tiny f32 step
    car = {"name": "car", "overrides": {}, "model": 2, "batch": 4,
           "seed": seed, "steps": DP_STEPS, "timed": DP_STEPS}
    sp1 = dict(car, name="sparse1", overrides=SPARSE1, steps=2, timed=0)
    tiny = dict(car, name="tiny", overrides=TINY, steps=1, timed=0)
    want = {run["name"]: one_process_step(run["overrides"], frames, device,
                                          4, seed)
            for run in (car, sp1, tiny)}
    t0 = time.perf_counter()
    outs = run_dp_workers(tmp, "spatial_train", "gloo", "cuda:0",
                          [car, sp1, tiny], world=4)
    print(f"  (b) 4 ranks: {time.perf_counter() - t0} s with the ranks' "
          f"start")
    sparse_ran = ("run_copy", "occupancy_map", "sparse_conv",
                  "sparse_conv_grad")
    check_dp_run("(b) Car bf16, 2 x 2 ranks, B=4", [o["car"] for o in outs],
                 want["car"], 2e-2, 5e-2)
    check_dp_run("(b) Car bf16 sparse1, 2 x 2 ranks, B=4",
                 [o["sparse1"] for o in outs], want["sparse1"], 2e-2, 5e-2,
                 ran=sparse_ran, idle=("dense_build",))
    # phase 7 (b)'s tolerances: f32 statistics summed in another order
    check_dp_run("(c) tiny f32, 2 x 2 ranks, B=4", [o["tiny"] for o in outs],
                 want["tiny"], 1e-4, 5e-3)
    o = outs[0]["car"]
    print(f"  (b) Car 2 x 2: step {[p['car']['step_ms'] for p in outs]} ms "
          f"per rank at B=2 a data index (one shared card over gloo); the "
          f"gradient all-reduce over the world {o['grad_all_reduce_ms']} ms "
          f"alone, {o['grad_all_reduce_in_step_ms']} ms in the step [{card}]")
    for name in ("car", "sparse1"):
        o = outs[0][name]
        launches[f"spatial_{'sparse1' if name == 'sparse1' else 'conv3d'}"
                 f"_train_rank0"] = o["launches"]
        print(f"  (b) {name}: all-reduces of step 1 by group [count, bytes] "
              f"{o['all_reduces_by_group']} (in all "
              f"{o['all_reduces_per_step']}, "
              f"{o['all_reduce_bytes_per_step']} bytes)")

    # (d) the CLI under torchrun with a model axis, on phase 6's tree
    data = os.path.join(tmp, "kitti")
    exp = os.path.join(tmp, "exp_spatial")
    cfg = os.path.join(tmp, "spatial.yaml")
    with open(cfg, "w") as f:
        f.write("system: {num_model_shards: 2}\n"
                "train: {num_epochs: 1, batch_size: 2}\n"
                "val: {batch_size: 2}\n")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "voxelnet_tpu_torch.cli.train",
         "--dist-backend", "gloo", "--device", "cuda:0", "--data-dir", data,
         "--exp-dir", exp, "--cfg", cfg, "--print-interval", "1"],
        capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    check(r.returncode == 0, f"(d) torchrun cli.train exited {r.returncode}"
          f":\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    logged = [line for line in r.stdout.splitlines()
              if line.startswith(("Train ", "Epoch "))]
    steps = TRAINER_FILES["training"] // 2
    print(f"  (d) torchrun cli.train, 1 x 2: {time.perf_counter() - t0} s"
          + "".join(f"\n    {line}" for line in logged))
    check(len(logged) == steps + 1, f"(d) expected {steps} step lines and "
          f"one epoch line, from rank 0 only: {logged}")
    ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    check(ckpts == ["0"], f"(d) checkpoints {ckpts}")
    saved = torch.load(os.path.join(exp, "checkpoints", "0", "state.pt"),
                       map_location="cpu", weights_only=True)
    check(saved["step"] == steps, f"(d) step count {saved['step']}")
    val_tags = sorted(f[:-4] for f in os.listdir(
        os.path.join(data, "validation", "velodyne")))
    dumped = sorted(os.listdir(os.path.join(exp, "preds", "1", "data")))
    check(dumped == [t + ".txt" for t in val_tags], f"(d) preds/1: {dumped}")
    ap = json.loads(run_cli(eval_cli.main, [
        "--preds", os.path.join(exp, "preds", "1", "data"),
        "--gt", os.path.join(data, "validation", "label_2"),
        "--iou", "0.5", "--mode", "bev"]))
    check(ap["frames"] == len(val_tags), f"(d) cli.eval frames {ap}")
    print(f"  (d) one checkpoint at step {saved['step']}, one label file of "
          f"each of the {len(val_tags)} val frames; cli.eval "
          f"{json.dumps(ap)}")

    # (e) NCCL across cards
    cards = torch.cuda.device_count()
    if cards >= 2:
        outs = run_dp_workers(tmp, "spatial_nccl", "nccl", None,
                              [infer["conv3d"]])
        check_launched("(e) NCCL inference rank 0",
                       outs[0]["infer-conv3d"]["launches"],
                       ("vfe_fused", "dense_build"))
        print(f"  (e) NCCL, 1 x 2 on 2 cards: median call "
              f"{[o['infer-conv3d']['stage_ms']['total'] for o in outs]} ms "
              f"[{card}]")
        if cards >= 4:
            outs = run_dp_workers(tmp, "spatial_nccl4", "nccl", None, [car],
                                  world=4)
            check_dp_run("(e) Car bf16, NCCL 2 x 2 on 4 cards",
                         [o["car"] for o in outs], want["car"], 2e-2, 5e-2)
    else:
        print(f"  (e) NCCL across cards: not run, torch sees {cards} card")

    # (f) uneven meshes: Car 1 x 3 conv3d (W slabs 120/120/112) and
    # Pedestrian 1 x 4 sparse1 (64/64/56/56) inference, and (c)'s tiny f32
    # step on 1 x 3 (24/24/16)
    car3 = dict(infer["conv3d"], name="infer-car-1x3", model=3)
    ped4 = dict(infer["sparse1"], name="infer-pedestrian-1x4", model=4,
                class_name="Pedestrian")
    tiny3 = dict(tiny, name="tiny3", model=3)
    for world, runs in ((3, [car3, tiny3]), (4, [ped4])):
        t0 = time.perf_counter()
        name = f"spatial_uneven{world}"
        outs = run_dp_workers(tmp, name, "gloo", "cuda:0", runs, world=world)
        print(f"  (f) {world} ranks: {time.perf_counter() - t0} s with the "
              f"ranks' start")
        run = runs[0]
        middle = "sparse1" if run is ped4 else "conv3d"
        launches[f"spatial_{middle}_1x{world}_inference_rank0"] = (
            check_spatial_infer("(f)", run, outs,
                                os.path.join(tmp, f"{name}.json"), frames,
                                device, card))
        if tiny3 in runs:
            check_dp_run("(c) tiny f32, 1 x 3 ranks, B=4",
                         [o["tiny3"] for o in outs], want["tiny"], 1e-4,
                         5e-3)
            print(f"  (c) tiny 1 x 3: all-reduces of step 1 by group "
                  f"[count, bytes] "
                  f"{outs[0]['tiny3']['all_reduces_by_group']}")
    return launches


# ---- phase 12: the bench ladder, voxelnet_tpu_torch.bench in process

# each run of the bench (Car, B=8 unless it says otherwise, BENCH_REPEATS
# timed chains of bench.ITERS calls), and the kernels it must launch: every
# other one of KERNELS must stay idle
BENCH_RUNS = (
    ("vfe", ["--stage", "vfe"], ("vfe_fused",)),
    ("dense", ["--stage", "dense"], ("vfe_fused", "dense_build")),
    ("middle", ["--stage", "middle"], ("vfe_fused", "dense_build")),
    ("infer", ["--stage", "infer"], ("vfe_fused", "dense_build")),
    ("train", ["--stage", "train"], ("run_copy", "dense_build")),
    ("targets", ["--stage", "targets"], ()),
    ("middle_sparse1", ["--stage", "middle", "--middle-backend", "sparse1"],
     ("vfe_fused", "occupancy_map", "sparse_conv")),
    ("infer_sparse1", ["--stage", "infer", "--middle-backend", "sparse1"],
     ("vfe_fused", "occupancy_map", "sparse_conv")),
    ("train_sparse1", ["--stage", "train", "--middle-backend", "sparse1"],
     ("run_copy", "occupancy_map", "sparse_conv", "sparse_conv_grad")),
    ("train_host_voxelize", ["--stage", "train", "--host-voxelize"],
     ("dense_build",)),
    ("infer_b1", ["--stage", "infer", "--batch", "1"],
     ("vfe_fused", "dense_build")),
)
BENCH_REPEATS = 3
# the bench's inference B=8 frames/s (wall clock over a chain, NMS's host
# syncs included) against phase 4's (CUDA events around one call): within
# this factor either way
BENCH_INFER_FACTOR = 2.0


def phase_bench(phase4_fps: float) -> dict:
    """12. `voxelnet_tpu_torch.bench.main` in this process for each of
    BENCH_RUNS: its one JSON line (printed here) parses and has a
    positive value, the launch counts read around the run show its
    kernels and no other, and the inference B=8 value lies within
    BENCH_INFER_FACTOR of phase 4's -> {"bench_<run>": launches}."""
    from voxelnet_tpu_torch import bench

    print(f"[12] bench ladder: voxelnet_tpu_torch.bench, Car, "
          f"--repeats {BENCH_REPEATS}, ITERS={bench.ITERS}")
    by_run, values = {}, {}
    for name, argv, ran in BENCH_RUNS:
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench.main(argv + ["--repeats", str(BENCH_REPEATS)])
        took = time.perf_counter() - t0
        launches = launch_counts()
        lines = out.getvalue().splitlines()
        check(len(lines) == 1,
              f"bench {name}: {len(lines)} lines of output: {lines[-3:]}")
        line = json.loads(lines[0])
        print(f"  {name}: {lines[0]}")
        print(f"    {took} s; launches {launches}")
        check(line["value"] > 0 and line["repeats"] == BENCH_REPEATS,
              f"bench {name}: {line}")
        check_launched(f"bench {name}", launches, ran,
                       [k for k in KERNELS if k not in ran])
        by_run[f"bench_{name}"] = launches
        values[name] = line["value"]
        torch.cuda.empty_cache()
    ratio = values["infer"] / phase4_fps
    print(f"  bench inference B=8 {values['infer']} frames/s against phase "
          f"4's {phase4_fps}: ratio {ratio}")
    check(1 / BENCH_INFER_FACTOR <= ratio <= BENCH_INFER_FACTOR,
          f"bench inference B=8 {values['infer']} frames/s is not within "
          f"{BENCH_INFER_FACTOR}x of phase 4's {phase4_fps}")
    return by_run


# ---- phase 13: the profile tool and the root entry points

# each traced run of (a): the profile tool's flags (Car, B=8), the phase
# earlier in this call that profiled the same graph (print_profile), and the
# port kernels the run's table must list with their launches per iteration
# (those of phase 12's gates); every other kernel of KERNELS must be absent
# from the trace and stay idle
PROFILE_RUNS = (
    ("infer", ["--stage", "infer"], "phase 4",
     {"vfe_fused": 1, "dense_build": 1}),
    ("infer_sparse1", ["--stage", "infer", "--middle-backend", "sparse1"],
     "phase 10 (b)", {"vfe_fused": 1, "occupancy_map": 1, "sparse_conv": 1}),
    ("train", ["--stage", "train"], "phase 5",
     {"run_copy": 1, "dense_build": 1}),
)
PROFILE_ITERS = 3
# the tool's device busy time a call against print_profile's for the same
# graph earlier in the call: within this share. On an H100 80GB HBM3 at
# 700 W the pairs read 20.98 / 21.07, 20.95 / 21.08, 20.98 / 20.97 ms
# (inference), 13.09 / 13.13, 13.12 / 13.12 ms (sparse1) and 199.66 /
# 197.37 ms (train step), gaps up to 1.2%, and a later call -0.56%,
# +0.85%, -0.21%; print_profile's train step alone read 195.97 to 199.18
# ms over three calls (1.6%). 4% is twice the larger spread, well under
# the share of the step's largest ops, so a tool that traced other work,
# or divided by the wrong count, fails
PROFILE_BUSY_REL = 0.04
def phase_profile(earlier: dict, tmp: str) -> dict:
    """(a) `voxelnet_tpu_torch.tools.profile_step.main` in this process
    for each of PROFILE_RUNS, held to `earlier`: {phase: (print_profile's
    busy ms, CUDA-event ms) of the same graph} -> {"profile_<run>":
    launches}."""
    print(f"[13] (a) the profile tool: Car B=8, {PROFILE_ITERS} iterations "
          f"under torch.profiler a graph")
    by_run = {}
    for name, argv, against, want in PROFILE_RUNS:
        reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            (section,) = profile_step.main(argv + [
                "--out", tmp, "--out-md", f"{name}.md", "--iters",
                str(PROFILE_ITERS)])
        torch.cuda.synchronize()
        launches = launch_counts()
        s, (busy, events) = section.summary, earlier[against]
        print(f"  {name}: device op total {s.total_ms} ms, busy {s.busy_ms} "
              f"ms, host wall {section.wall_ms} ms a call under the "
              f"profiler; {against}'s busy {busy} ms (gap "
              f"{s.busy_ms / busy - 1}), its CUDA events {events} ms (idle "
              f"share {1 - s.busy_ms / events}); launches {launches}")
        for r in s.rows[:10]:
            print(f"      {r.ms:9.4f} ms x{r.calls:<4g} "
                  f"{profile_step.short_name(r.name)} <- {r.launched_by}")
        for kernel in KERNELS:
            row, n = s.row(kernel), want.get(kernel, 0)
            calls = 0 if row is None else row.calls
            check(calls == n, f"profile {name}: {kernel} at {calls} "
                  f"launches a call in the trace, expected {n}")
            # the tool's warm-up call and the traced ones
            check(launches[kernel] == (PROFILE_ITERS + 1) * n,
                  f"profile {name}: {kernel} counted {launches[kernel]} "
                  f"launches, expected {n} a call")
            if row is not None:
                check(row.launched_by == source_path(kernel),
                      f"profile {name}: {kernel} launched by "
                      f"{row.launched_by}")
        # the union and the sum of the same durations, summed in
        # another order: equal within rounding where nothing overlaps
        check(s.busy_ms <= s.total_ms * (1 + 1e-9)
              and s.busy_ms <= section.wall_ms,
              f"profile {name}: busy {s.busy_ms} ms above the op total "
              f"{s.total_ms} or the wall {section.wall_ms}")
        check(abs(s.busy_ms - busy) <= PROFILE_BUSY_REL * busy,
              f"profile {name}: device busy {s.busy_ms} ms not within "
              f"{PROFILE_BUSY_REL} of {against}'s {busy} ms")
        by_run[f"profile_{name}"] = launches
        torch.cuda.empty_cache()
    return by_run


def phase_graft_entry(device) -> dict:
    """(b) graft_entry.entry() on the card: its maps against the same fn
    on the CPU (plain versions) within MAP_GATES' bf16 shares, its
    launches; (c) dryrun_multichip(4) and dryrun_multihost(2), every rank
    on cuda:0 over gloo -> {path: launches}."""
    from voxelnet_tpu_torch import graft_entry

    print("[13] (b) graft_entry.entry(): Car forward, 16384 points, 6144 "
          "voxel slots, bf16")
    fn, (model, points, num) = graft_entry.entry()
    fn(model, points, num)
    torch.cuda.synchronize()
    reset_launches()
    cls, reg = fn(model, points, num)
    torch.cuda.synchronize()
    launches = launch_counts()
    cpu_fn = make_maps_fn(graft_entry.entry_config(), "cpu")
    want = cpu_fn(copy.deepcopy(model).cpu(), points.cpu(), num.cpu())
    check(tuple(cls.shape) == (1, 200, 176, 2)
          and tuple(reg.shape) == (1, 200, 176, 14),
          f"entry maps {cls.shape}, {reg.shape}")
    gaps = {name: compare_maps(f"entry {name} (card vs CPU)", got, w, "bf16")
            for name, got, w in (("cls", cls, want[0]), ("reg", reg, want[1]))}
    print(f"  card vs CPU, shares of the spread: {gaps}; launches {launches}")
    check_launched("entry", launches, ("vfe_fused", "dense_build"),
                   ("run_copy", "sparse_conv", "sparse_conv_grad",
                    "occupancy_map"))
    del model
    by_path = {"graft_entry": launches}

    print("[13] (c) dryrun_multichip(4) and dryrun_multihost(2), ranks on "
          "cuda:0 over gloo")
    t0 = time.perf_counter()
    chip = graft_entry.dryrun_multichip(4)
    t1 = time.perf_counter()
    host = graft_entry.dryrun_multihost(2)
    print(f"  {t1 - t0} s and {time.perf_counter() - t1} s")
    for r, rank in enumerate(chip["ranks"]):
        check_launched(f"dryrun_multichip rank {r} step",
                       rank["step_launches"], ("run_copy", "dense_build"))
        check_launched(f"dryrun_multichip rank {r} inference",
                       rank["infer_launches"], ("vfe_fused", "dense_build"))
        check_launched(f"dryrun_multichip rank {r} sparse1",
                       rank["sparse1_launches"],
                       ("occupancy_map", "sparse_conv"), ("dense_build",))
    for r, rank in enumerate(host["ranks"]):
        check_launched(f"dryrun_multihost rank {r}", rank["step_launches"],
                       ("run_copy", "dense_build"))
    by_path.update(dryrun_multichip_rank0=chip["ranks"][0]["step_launches"],
                   dryrun_multihost_rank0=host["ranks"][0]["step_launches"])
    return by_path


# ---- phase 14: the port's detections against the JAX package's

# the JAX package's detections for make_model's Car weights on the staged
# vendored frames (tests/torch_jax_dumps.py writes them where JAX runs):
# one directory of KITTI label files a setting, calib/ and meta.json
AB_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "fixtures", "jax_car_dumps")
# every setting: full Car width at score_thres 0 (20 boxes a frame after
# NMS), the fused VFE on both sides; then the middle and compute dtype
AB_BASE = {"rpn": {"score_thres": 0.0}, "data": {"vfe_backend": "fused"}}
AB_SETTINGS = {
    "conv3d_bf16": {},
    "conv3d_f32": {"train": {"compute_dtype": "float32"}},
    "sparse1_bf16": SPARSE1,
    "sparse1_f32": merged(SPARSE1, {"train": {"compute_dtype": "float32"}}),
}
AB_LAUNCHED = {"conv3d": ("vfe_fused", "dense_build"),
               "sparse1": ("vfe_fused", "occupancy_map", "sparse_conv")}
AB_IOU = 0.7
# each setting's gates by its compute dtype (the port is A, JAX is B).
# make_model's random weights score the anchors alike: the 256 candidates
# of a frame's NMS span 3.7e-4, half their neighbouring gaps are exact
# ties, and the port's f32 scores lie up to 4.5e-6 from JAX's
# (`tests/torch_jax_dumps.py --diagnose`), so the greedy NMS picks among
# equals and the match rate reads summation order more than the stack.
# Measured on an H100 80GB HBM3 at 700 W (two runs, equal): match rate
# conv3d f32 0.85, sparse1 f32 0.6667, bf16 0.2167 / 0.2333 (the port's
# CPU run: 0.7 / 0.7, 0.2333 / 0.15); matched boxes' mean BEV IoU 1.0 (f32)
# and 0.9994-0.9996 (bf16); p95 score gap 0 (f32) and 1e-4 (bf16), in
# units of the dumps' 4 decimals. The match-rate floors sit below the
# least reading for that spread; the IoU and score gates hold the
# matched boxes, where a wrong kernel shows first
AB_GATES = {"f32": {"match_rate": 0.5, "mean_matched_bev_iou": 0.999,
                    "p95_abs_score_diff": 1e-4},
            "bf16": {"match_rate": 0.1, "mean_matched_bev_iou": 0.99,
                     "p95_abs_score_diff": 1e-3}}


def ab_config(name: str):
    return get_config("Car", **merged(AB_BASE, AB_SETTINGS[name]))


def ab_inputs(frames) -> tuple[np.ndarray, np.ndarray]:
    """The vendored frames staged as phase 4 stages them."""
    return predict.stage_points(frames, get_config("Car"),
                                np.random.default_rng(SEED))


def state_sha256(model) -> str:
    """sha256 over the f32 bytes of the model's floating state_dict
    entries, in sorted key order, each after its key."""
    h = hashlib.sha256()
    state = model.state_dict()
    for key in sorted(state):
        if state[key].is_floating_point():
            h.update(key.encode())
            h.update(state[key].detach().cpu().float().contiguous()
                     .numpy().tobytes())
    return h.hexdigest()


def points_sha256(points: np.ndarray, num: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(points, np.float32).tobytes()
                          + np.ascontiguousarray(num, np.int32).tobytes()
                          ).hexdigest()


def ab_compare_runs(device, tmp: str, fixture: str = AB_FIXTURE):
    """make_model's Car weights through the port's make_inference_fn on
    `device` in each of AB_SETTINGS, dumped to `tmp` and compared with
    the fixture's dumps of the same setting (A the port, B JAX) ->
    {setting: (compare()'s dict, launches)}. Raises where the weights or
    the staged points are not the fixture's."""
    with open(os.path.join(fixture, "meta.json")) as f:
        meta = json.load(f)
    model = make_model(get_config("Car"), device)
    points, num = ab_inputs(sample_frames())
    for what, got, want in (
            ("weights", state_sha256(model), meta["weights_sha256"]),
            ("staged points", points_sha256(points, num),
             meta["points_sha256"])):
        check(got == want, f"{what} sha256 {got} is not the fixture's "
              f"{want}: regenerate it with tests/torch_jax_dumps.py where "
              f"JAX runs")
    out = {}
    for name in AB_SETTINGS:
        reset_launches()
        det = make_inference_fn(ab_config(name), device)(model, points, num)
        launches = launch_counts()
        dump = os.path.join(tmp, name)
        write_dumps(dump, det.boxes.cpu().numpy(), det.scores.cpu().numpy(),
                    det.valid.cpu().numpy())
        out[name] = (compare(dump, os.path.join(fixture, name),
                             os.path.join(fixture, "calib"), AB_IOU),
                     launches)
    return out


def phase_ab_compare(device, tmp: str, card: str) -> dict:
    """The port's Car detections on the card against the JAX package's
    from the same weights and points (AB_FIXTURE), box by box through
    tools/ab_compare_dumps.py, in each of AB_SETTINGS, held to AB_GATES;
    each run's launches -> {"ab_<setting>": launches}."""
    print("[14] the port's detections against the JAX package's "
          "(tests/fixtures/jax_car_dumps): Car, full width, 3 vendored "
          f"frames, score_thres 0, BEV IoU >= {AB_IOU} [{card}]")
    t0 = time.perf_counter()
    runs = ab_compare_runs(device, tmp)
    by_path = {}
    for name, (res, launches) in runs.items():
        middle, dtype = name.split("_")
        print(f"  {name}: {json.dumps(res)}; launches {launches}")
        check_launched(f"ab {name}", launches, AB_LAUNCHED[middle],
                       set(KERNELS) - set(AB_LAUNCHED[middle]))
        check(all(launches[k] == 1 for k in AB_LAUNCHED[middle]),
              f"ab {name}: launches {launches}, expected one a kernel")
        gate = AB_GATES[dtype]
        check(res["frames"] == 3 and res["boxes_a"] == res["boxes_b"]
              and res["match_rate"] >= gate["match_rate"]
              and res["mean_matched_bev_iou"] is not None
              and res["mean_matched_bev_iou"]
              >= gate["mean_matched_bev_iou"]
              and res["p95_abs_score_diff"] <= gate["p95_abs_score_diff"],
              f"ab {name}: {res} misses the gates {gate}")
        by_path[f"ab_{name}"] = launches
    # the NMS's candidate pick at the inference B=8 batch: torch.topk
    # against the stable descending sort that nms_bev runs (ties keep the
    # lower anchor index, as lax.top_k does)
    config = ab_config("conv3d_bf16")
    scores = torch.rand((8, config.object.num_anchors),
                        generator=torch.Generator(device=device)
                        .manual_seed(SEED), device=device)
    k = config.rpn.nms_pre_topk
    pick = {"topk": timed(lambda: torch.topk(scores, k, dim=-1)),
            "stable_sort": timed(lambda: torch.sort(
                scores, dim=-1, descending=True, stable=True))}
    print(f"  NMS candidate pick, B=8 x {scores.shape[1]} anchors, k={k}: "
          f"{pick} [{card}]")
    print(f"  gates {AB_GATES}; phase 14 took {time.perf_counter() - t0} s")
    return by_path


def kernel_entry(name, times, errs, bounds, launches, by_path) -> dict:
    """One kernel's object of the {"kernels": [...]} line: event and
    profiler device times of the kernel, its plain version and its one
    torch call, its bound, and extra shapes of the same kernel."""
    def cols(prefix, key):
        k, p, lib = times[key]
        out = {f"{prefix}ms": k["ms"], f"{prefix}device_ms": k["device_ms"]}
        if "host_us" in k:
            out[f"{prefix}host_us"] = k["host_us"]
        if p is not None:
            out.update({f"{prefix}plain_ms": p["ms"],
                        f"{prefix}plain_device_ms": p["device_ms"]})
        if lib is not None and prefix:
            out.update({f"{prefix}library_ms": lib["ms"],
                        f"{prefix}library_device_ms": lib["device_ms"]})
        if lib is not None and "host_us" in lib:
            out[f"{prefix}library_host_us"] = lib["host_us"]
        out[f"{prefix}bound_ms"], out[f"{prefix}bound_by"] = bounds.get(
            key, (None, None))
        return out

    lib = times[name][2]
    entry = {"name": name, "route": "cuda",
             "source": source_path(name),
             "replaces": REPLACES[name], "design_pr": DESIGN_PR[name],
             "launches": launches[name],
             "launches_by_path": {path: counts[name]
                                  for path, counts in by_path.items()},
             "max_abs_err": errs[name], **cols("", name),
             "library_ms": lib["ms"] if lib else None,
             "library_device_ms": lib["device_ms"] if lib else None}
    for extra in EXTRA_SHAPES.get(name, ()):
        entry.update(cols(f"{extra.removeprefix(name + '_')}_", extra))
    return entry


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic GT boxes and point shuffles")
    p.add_argument("--dp-worker", metavar="JOB", default=None,
                   help="run as one rank of a phase 7, 10 or 11 job "
                        "(internal)")
    p.add_argument("--rank", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    if args.dp_worker:
        return dp_worker(args.dp_worker, args.rank)
    device = torch.device("cuda", 0)
    # f32 comparisons (the plain VFE's matmuls, the tiny-grid convs) run
    # in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[1] {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(SOURCES)
    for module in (vfe_fused, dense_build, run_copy, sparse_conv):
        _build.load(module.__name__.rsplit(".", 1)[1], module._ARGTYPES)
    print(f"[2] built {sorted(_build.build_seconds)} in "
          f"{time.perf_counter() - t0} s ({_build.build_seconds})")
    vfe_info = vfe_fused.kernel_info()
    print(f"    vfe_fused_kernel: {vfe_info}")

    frames = sample_frames()
    check(len(frames) == 3, "expected 3 vendored frames")
    config = get_config("Car")
    model = make_model(config, device)
    times, errs, bounds = phase_kernels(config, model, frames, device, card)
    infer_launches, conv3d_dets = phase_main_path(model, frames, device)
    phase_small_reference(device)
    infer_fps, infer_busy = phase_timing(model, frames, device, card)
    del model
    train_launches = phase_train(frames, device, card, args.seed)
    phase_train_small_reference(frames, device, args.seed)
    step_fps, step_busy = phase_train_timing(frames, device, card, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer_launches = phase_trainer(frames, device, args.seed, tmp)
        phase_trainer_timing(frames, device, args.seed, tmp, card, step_fps)
        dp_launches = phase_data_parallel(frames, device, args.seed, tmp,
                                          card, step_fps)
        learn_train, learn_eval = phase_learning_run(device, tmp, card)
        host_vox = phase_host_voxelizer(frames, device, tmp, card)
        ghost = phase_ghost_inference(frames, device)
        t9 = time.perf_counter()
        ref_api = phase_reference_api(frames, device)
        vis_trainer = phase_vis_trainer(frames, device, tmp, card)
        raw_train = phase_raw_to_kitti(device, tmp, card)
        print(f"[9] phase 9 took {time.perf_counter() - t9} s")
        took = [time.perf_counter()]
        model = make_model(config, device)
        *more, sparse_info = phase_sparse_kernels(config, model, frames,
                                                  device, card)
        for part, extra in zip((times, errs, bounds), more):
            part.update(extra)
        took.append(time.perf_counter())
        sparse_infer, sparse_fps, sparse_busy = phase_sparse_inference(
            model, frames, device, card, conv3d_dets, tmp)
        del model
        took.append(time.perf_counter())
        sparse_train, sparse_trainer, sparse_dp = phase_sparse_train(
            frames, device, card, args.seed, tmp)
        took.append(time.perf_counter())
        print(f"[10] phase 10 took {took[-1] - took[0]} s: (a) "
              f"{took[1] - took[0]}, (b) {took[2] - took[1]}, (c) "
              f"{took[3] - took[2]} s")
        t11 = time.perf_counter()
        spatial = phase_spatial(frames, device, args.seed, tmp, card)
        print(f"[11] phase 11 took {time.perf_counter() - t11} s")
    t12 = time.perf_counter()
    bench_launches = phase_bench(infer_fps[8])
    print(f"[12] phase 12 took {time.perf_counter() - t12} s")
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        profile_launches = phase_profile(
            {"phase 4": (infer_busy[8], 8e3 / infer_fps[8]),
             "phase 10 (b)": (sparse_busy[8], 8e3 / sparse_fps[8]),
             "phase 5": (step_busy[8], 8e3 / step_fps[8])}, tmp)
    t13b = time.perf_counter()
    entry_launches = phase_graft_entry(device)
    print(f"[13] phase 13 took {time.perf_counter() - t13} s: (a) "
          f"{t13b - t13}, (b)-(c) {time.perf_counter() - t13b} s")
    with tempfile.TemporaryDirectory() as tmp:
        ab_launches = phase_ab_compare(device, tmp, card)

    # each kernel's count on the path of the slice that brought it: the
    # fused VFE runs only for inference, dense_build and run_copy on the
    # train step; sparse_conv and occupancy_map on sparse1's inference,
    # the gradient on sparse1's train step
    launches = {"vfe_fused": infer_launches["vfe_fused"],
                "dense_build": train_launches["dense_build"],
                "run_copy": train_launches["run_copy"],
                "sparse_conv": sparse_infer["sparse_conv"],
                "sparse_conv_grad": sparse_train["sparse_conv_grad"],
                "occupancy_map": sparse_infer["occupancy_map"]}
    print(card)
    by_path = {"inference": infer_launches, "train": train_launches,
               "trainer": trainer_launches,
               "data_parallel_rank0": dp_launches,
               "learning_run_train": learn_train,
               "learning_run_eval": learn_eval,
               "host_voxelize_trainer": host_vox,
               "bn_over_padding_inference": ghost,
               "reference_api_inference": ref_api,
               "vis_trainer": vis_trainer,
               "raw_to_kitti_train": raw_train,
               "sparse1_inference": sparse_infer,
               "sparse1_train": sparse_train,
               "sparse1_trainer": sparse_trainer,
               "sparse1_data_parallel_rank0": sparse_dp, **spatial,
               **bench_launches, **profile_launches, **entry_launches,
               **ab_launches}
    entries = [kernel_entry(name, times, errs, bounds, launches, by_path)
               for name in KERNELS]
    entries[KERNELS.index("vfe_fused")].update(vfe_info)
    entries[KERNELS.index("sparse_conv")].update(kernel_info=sparse_info)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
