"""Drive the PyTorch port's Car inference path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build both CUDA kernels from voxelnet_tpu_torch/csrc/ with nvcc;
  3. each kernel against its plain torch version at Car shapes (B=2,
     vendored frames): the fused VFE (>= 99.9% of elements bit-equal, the
     rest within 2**-7 relative) and the dense-grid build (bit-equal), with
     CUDA-event medians of both;
  4. the main path through cli.predict on the 3 vendored frames at full
     Car width (grid 10x400x352, max_points 65536, max_voxels 16384, bf16,
     random init from a seed with random BN statistics), at score_thres
     0.96 and 0.0; kernel launch counts read around that run; then the
     same path at a tiny grid in f32 on the card against the CPU; then
     per-stage and end-to-end CUDA-event times at B=1 and B=8, and a
     torch.profiler kernel table of one call at each.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Exits non-zero without printing it when
torch sees no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from voxelnet_tpu_torch.cli import predict
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.data.sample import sample_frames
from voxelnet_tpu_torch.kernels import _build, dense_build, vfe_fused
from voxelnet_tpu_torch.models.init import randomize_bn_
from voxelnet_tpu_torch.models.voxelnet import (STAGES, build_model,
                                                make_inference_fn)
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, prepare

SEED = 0
TINY = {"object": {"x_max": 12.8, "y_min": -6.4, "y_max": 6.4},
        "data": {"max_points": 2048, "max_voxels": 256},
        "train": {"compute_dtype": "float32"}, "rpn": {"score_thres": 0.0}}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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
              f"(raw {prep.num_voxels_raw.tolist()}), voxels over 32 "
              f"points: {int((prep.counts > 32).sum())}")
        vfe_err = compare_vfe(got, want)

        # crowded voxels: every voxel over 32 points, the kernel's
        # two-slot path
        n_pts = config.data.max_points
        g = np.random.default_rng(SEED + 2)
        obj = config.object
        size = np.asarray([obj.x_voxel_size, obj.y_voxel_size,
                           obj.z_voxel_size])
        lo = np.asarray([obj.x_min, obj.y_min, obj.z_min])
        cells = g.integers(0, [obj.width, obj.height, obj.depth], (1800, 3))
        centres = lo + (cells + 0.5) * size
        crowd = np.zeros((1, n_pts, 4), np.float32)
        crowd[0, :, :3] = (centres[np.arange(n_pts) % 1800]
                           + g.uniform(-0.25, 0.25, (n_pts, 3)) * size)
        crowd[0, :, 3] = g.uniform(0, 1, n_pts)
        cp = prepare(torch.from_numpy(crowd).to(device),
                     torch.tensor([crowd.shape[1]], device=device), spec, K)
        cargs = (cp.sorted_planar, cp.run_start, cp.num_voxels, cp.counts, *w)
        print(f"  crowded frame: {int((cp.counts > 32).sum())} voxels over "
              "32 points")
        check(int((cp.counts > 32).sum()) > 100, "crowded case too sparse")
        vfe_err = max(vfe_err, compare_vfe(vfe_fused.vfe_fused(*cargs, T),
                                           vfe_fused.vfe_fused_plain(
                                               *cargs, T)))

        D, H, W = config.object.grid_size
        n = D * H * W
        c = prep.coords
        ids = torch.where(prep.counts > 0, (c[..., 0] * H + c[..., 1]) * W
                          + c[..., 2], n).to(torch.int32)
        dgot = dense_build.dense_build(got, ids, n)
        dwant = dense_build.dense_build_plain(got, ids, n)
        torch.cuda.synchronize()
        dense_err = float((dgot.float() - dwant.float()).abs().max())
        check(torch.equal(dgot, dwant), "dense_build differs from plain")
        print(f"  dense_build: bit-equal over {dgot.numel()} elements")

        times = {
            "vfe_fused": (cuda_ms(lambda: vfe_fused.vfe_fused(*args, T)),
                          cuda_ms(lambda: vfe_fused.vfe_fused_plain(*args,
                                                                    T))),
            "dense_build": (cuda_ms(lambda: dense_build.dense_build(
                got, ids, n)), cuda_ms(lambda: dense_build.dense_build_plain(
                    got, ids, n))),
        }
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel {k_ms} ms, plain {p_ms} ms "
              f"(B=2, CUDA-event median) [{card}]")
    return times, {"vfe_fused": vfe_err, "dense_build": dense_err}


def check_detections(det, config, batch):
    post = config.rpn.nms_post_topk
    check(det.boxes.shape == (batch, post, 7), f"boxes {det.boxes.shape}")
    check(det.scores.shape == (batch, post), f"scores {det.scores.shape}")
    check(bool(torch.isfinite(det.boxes).all()), "non-finite boxes")
    check(bool(torch.isfinite(det.scores).all()), "non-finite scores")
    counts = det.valid.sum(1)
    check(bool((counts <= post).all()), "more detections than post_topk")
    return counts.tolist()


def phase_main_path(model, frames, device):
    """cli.predict's path on the 3 vendored frames at full Car width."""
    print("[4] main path: cli.predict on 3 vendored frames, Car, bf16")
    vfe_fused.launches = 0
    dense_build.launches = 0
    results = {}
    for thres in (0.96, 0.0):
        config = get_config("Car", rpn={"score_thres": thres})
        infer = make_inference_fn(config, device)
        det = predict.predict(infer, model, frames, config,
                              np.random.default_rng(SEED))
        torch.cuda.synchronize()
        results[thres] = check_detections(det, config, len(frames))
    launches = {"vfe_fused": vfe_fused.launches,
                "dense_build": dense_build.launches}
    print(f"  valid detections per frame: score_thres 0.96 -> "
          f"{results[0.96]}, 0.0 -> {results[0.0]}; launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    check(sum(results[0.0]) > 0, "no detections at score_thres 0.0")
    return launches


def phase_small_reference(device):
    """The same path at a tiny grid in f32: card against CPU."""
    config = get_config("Car", **TINY)
    frames = [f[:20000] for f in sample_frames()[:2]]
    points, num = predict.stage_points(frames, config,
                                       np.random.default_rng(SEED))
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
        for _ in range(10):
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
        print_profile(infer, model, points, num)


def print_profile(infer, model, points, num):
    """Kernel time by name for one call, and the device's busy share of
    the call's CUDA-event span."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        start.record()
        infer(model, points, num)
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


def main():
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
    for name, module in (("vfe_fused", vfe_fused),
                         ("dense_build", dense_build)):
        _build.load(name, module._ARGTYPES)
    print(f"[2] built {sorted(_build.build_seconds)} in "
          f"{time.perf_counter() - t0} s ({_build.build_seconds})")

    frames = sample_frames()
    check(len(frames) == 3, "expected 3 vendored frames")
    config = get_config("Car")
    model = make_model(config, device)
    times, errs = phase_kernels(config, model, frames, device, card)
    launches = phase_main_path(model, frames, device)
    phase_small_reference(device)
    phase_timing(model, frames, device, card)

    replaces = {"vfe_fused": "voxelnet_tpu/kernels/vfe_fused.py:52",
                "dense_build": "voxelnet_tpu/kernels/dense_build.py:62"}
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"voxelnet_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]} for name in ("vfe_fused",
                                                   "dense_build")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
