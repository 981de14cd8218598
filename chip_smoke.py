"""Drive the PyTorch port's Car inference path and train step on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the three CUDA sources of voxelnet_tpu_torch/csrc/ with nvcc,
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
     torch.profiler kernel table of one call at each;
  5. the train path: make_train_step at full Car width (bf16, B=2, 64 GT
     slots) through several steps on one batch of vendored frames with
     seeded synthetic Car boxes; every metric finite and the loss falling;
     launch counts of the run-copy and dense-grid kernels read around
     those steps; one step at the tiny f32 grid on the card against the
     CPU; CUDA-event step times with the stage split and peak memory at
     B=2 and B=8, and a profiler kernel table of one step at B=8.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Exits non-zero without printing it when
torch sees no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from voxelnet_tpu_torch.cli import predict
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.data.sample import sample_frames
from voxelnet_tpu_torch.kernels import _build, dense_build, run_copy, vfe_fused
from voxelnet_tpu_torch.models.init import randomize_bn_
from voxelnet_tpu_torch.models.voxelnet import (STAGES, build_model,
                                                make_inference_fn)
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, prepare
from voxelnet_tpu_torch.training.train_step import (TRAIN_STAGES,
                                                    create_train_state,
                                                    make_train_step)

SEED = 0
TINY = {"object": {"x_max": 12.8, "y_min": -6.4, "y_max": 6.4},
        "data": {"max_points": 2048, "max_voxels": 256, "max_gt_boxes": 8},
        "train": {"compute_dtype": "float32"}, "rpn": {"score_thres": 0.0}}
KERNELS = ("vfe_fused", "dense_build", "run_copy")
REPLACES = {
    "vfe_fused": "voxelnet_tpu/kernels/vfe_fused.py:52",
    "dense_build": "voxelnet_tpu/kernels/dense_build.py:62",
    "run_copy": "voxelnet_tpu/kernels/voxelize_pallas.py:189 "
                "(_planar_t_kernel), :79 (_planar_kernel), :48 (_kernel)",
}
# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth, and the peak
# operation rate by the type of the operands (bf16 on the tensor cores, f32
# outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# MACs per stored point of the VFE stack: 7->16 and 32->64
VFE_FLOP_PER_POINT = 2 * (7 * 16 + 32 * 64)
TRAIN_STEPS = 8
# the PR whose design each kernel runs
DESIGN_PR = {"vfe_fused": 3, "dense_build": 1, "run_copy": 2}
# timed shapes beside each kernel's Car B=2 one: the fused VFE at the
# inference B=8 batch; the dense grid in f32 (train) and its backward (a
# torch gather, no kernel of the port)
EXTRA_SHAPES = {"vfe_fused": ("vfe_fused_b8",),
                "dense_build": ("dense_build_f32", "dense_build_grad")}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int = 50, windows: int = 5, warmup: int = 3) -> float:
    """Time of one fn() call in ms: after `warmup` calls, one CUDA-event
    pair around `reps` back-to-back calls, divided by `reps`; the median
    over `windows` such windows. Where the host work of a call outlasts
    the kernels it launches, the device waits and this time is the
    host's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 50) -> float:
    """The device's self time of every kernel that one fn() call launches,
    in ms: torch.profiler over `reps` back-to-back calls, divided by `reps`.
    Host time between the kernels is not in it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / reps


def timed(fn) -> dict:
    """{"ms": cuda_ms(fn), "device_ms": device_ms(fn)} over the same
    back-to-back calls."""
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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
                    got, ids, n)), None),
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


def reset_launches():
    vfe_fused.launches = dense_build.launches = run_copy.launches = 0


def phase_main_path(model, frames, device):
    """cli.predict's path on the 3 vendored frames at full Car width."""
    print("[4] main path: cli.predict on 3 vendored frames, Car, bf16")
    reset_launches()
    results = {}
    for thres in (0.96, 0.0):
        config = get_config("Car", rpn={"score_thres": thres})
        infer = make_inference_fn(config, device)
        det = predict.predict(infer, model, frames, config,
                              np.random.default_rng(SEED))
        torch.cuda.synchronize()
        results[thres] = check_detections(det, config, len(frames))
    launches = {"vfe_fused": vfe_fused.launches,
                "dense_build": dense_build.launches,
                "run_copy": run_copy.launches}
    print(f"  valid detections per frame: score_thres 0.96 -> "
          f"{results[0.96]}, 0.0 -> {results[0.0]}; launches {launches}")
    check(launches["vfe_fused"] > 0 and launches["dense_build"] > 0,
          f"a kernel was not launched on the inference path: {launches}")
    check(sum(results[0.0]) > 0, "no detections at score_thres 0.0")
    return launches


def phase_small_reference(device):
    """The same path at a tiny grid in f32: card against CPU."""
    config = get_config("Car", **TINY)
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


def phase_timing(model, frames, device, card):
    config = get_config("Car")
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
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        print(f"  B={batch}: end-to-end {med['total']} ms CUDA events, "
              f"{statistics.median(host)} ms host, "
              f"{batch * 1e3 / med['total']} frames/s, peak {peak} GiB "
              f"[{card}]")
        print("    " + ", ".join(f"{s} {med[s]}" for s in STAGES) + " (ms)")
        print_profile(lambda: infer(model, points, num))


def print_profile(call):
    """Kernel time by name for one call(), and the device's busy share of
    the call's CUDA-event span."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
    kernels = [e for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    span = start.elapsed_time(end)
    print(f"    profile: kernels busy {busy} ms of {span} ms "
          f"(idle share {1 - busy / span})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"      {e.self_device_time_total / 1e3:9.4f} ms "
              f"x{e.count:<4d} {e.key[:150]}")


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


def phase_train(frames, device, card, seed):
    """make_train_step at full Car width on one repeated batch."""
    print("[5] train path: make_train_step, Car, bf16, B=2, "
          f"{TRAIN_STEPS} steps on one batch")
    config = get_config("Car")
    batch = train_batch(config, frames, config.train.batch_size, seed)
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
    launches = {"vfe_fused": vfe_fused.launches,
                "dense_build": dense_build.launches,
                "run_copy": run_copy.launches}
    print(f"  launches {launches}")
    check(launches["run_copy"] > 0 and launches["dense_build"] > 0,
          f"a kernel was not launched on the train path: {launches}")
    check(losses[-1] < 0.9 * losses[0],
          f"loss did not fall: first {losses[0]}, last {losses[-1]}")
    del state
    return launches


def phase_train_small_reference(frames, device, seed):
    """One f32 step at the tiny grid from the same weights and batch, on
    the card and on the CPU."""
    config = get_config("Car", **TINY)
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


def phase_train_timing(frames, device, card, seed):
    config = get_config("Car")
    for batch_size in (2, 8):
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
        print(f"  train B={batch_size}: step {med['total']} ms CUDA events, "
              f"{statistics.median(host)} ms host, "
              f"{batch_size * 1e3 / med['total']} frames/s, peak {peak} GiB "
              f"[{card}]")
        print("    " + ", ".join(f"{s} {med[s]}" for s in TRAIN_STAGES)
              + " (ms)")
        if batch_size == 8:
            print_profile(lambda: step(state, batch))
        del state, batch


def kernel_entry(name, times, errs, bounds, launches, infer_launches,
                 train_launches) -> dict:
    """One kernel's object of the {"kernels": [...]} line: event and
    profiler device times of the kernel, its plain version and its one
    torch call, its bound, and extra shapes of the same kernel."""
    def cols(prefix, key):
        k, p, lib = times[key]
        out = {f"{prefix}ms": k["ms"], f"{prefix}device_ms": k["device_ms"]}
        if p is not None:
            out.update({f"{prefix}plain_ms": p["ms"],
                        f"{prefix}plain_device_ms": p["device_ms"]})
        out[f"{prefix}bound_ms"], out[f"{prefix}bound_by"] = bounds.get(
            key, (None, None))
        return out

    lib = times[name][2]
    entry = {"name": name, "route": "cuda",
             "source": f"voxelnet_tpu_torch/csrc/{name}.cu",
             "replaces": REPLACES[name], "design_pr": DESIGN_PR[name],
             "launches": launches[name],
             "launches_by_path": {"inference": infer_launches[name],
                                  "train": train_launches[name]},
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
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
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
    _build.build(KERNELS)
    for module in (vfe_fused, dense_build, run_copy):
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
    infer_launches = phase_main_path(model, frames, device)
    phase_small_reference(device)
    phase_timing(model, frames, device, card)
    del model
    train_launches = phase_train(frames, device, card, args.seed)
    phase_train_small_reference(frames, device, args.seed)
    phase_train_timing(frames, device, card, args.seed)

    # each kernel's count on the path of the slice that brought it: the
    # fused VFE runs only for inference, the others on the train step
    launches = {"vfe_fused": infer_launches["vfe_fused"],
                "dense_build": train_launches["dense_build"],
                "run_copy": train_launches["run_copy"]}
    print(card)
    entries = [kernel_entry(name, times, errs, bounds, launches,
                            infer_launches, train_launches)
               for name in KERNELS]
    entries[KERNELS.index("vfe_fused")].update(vfe_info)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
