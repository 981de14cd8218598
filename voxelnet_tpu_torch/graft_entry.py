"""Entry points of the port: the single-graph Car forward and the
multi-process dry runs. The port's counterpart of `__graft_entry__.py`,
with its names:

    from voxelnet_tpu_torch import graft_entry as g
    fn, args = g.entry()          # Car forward + example inputs on the card
    cls, reg = fn(*args)          # (1, 200, 176, 2), (1, 200, 176, 14) f32
    g.dryrun_multichip(4)         # 4 gloo ranks: (data 2, model 2) mesh
    g.dryrun_multihost(2)         # 8 gloo ranks: (dcn 2, data 4, model 1)

`entry` and both dry runs run on the card unless the caller passes
device="cpu". A dry run starts one process per rank of its mesh (this
module as `python -m voxelnet_tpu_torch.graft_entry JOB RANK`), joined
over gloo through a file:// rendezvous; on the card every rank runs on
cuda:0 (NCCL refuses two ranks on one card). Each rank takes its
contiguous rows of one global batch, as the port's data parallelism
splits it (parallel/mesh.py), and the launching process compares what
the ranks report with the same work in its own process.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from voxelnet_tpu_torch.config import get_config, resolve_plan
from voxelnet_tpu_torch.kernels import launch_counts, reset_launches
from voxelnet_tpu_torch.models.voxelnet import (VoxelNet, build_model,
                                                make_inference_fn,
                                                make_maps_fn)
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, voxelize_table
from voxelnet_tpu_torch.parallel import distributed
from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# entry(): the Car preset with the JAX entry's caps, and its example frame
ENTRY_DATA = {"max_points": 16384, "max_voxels": 6144}
ENTRY_POINTS = 12000
# the dry runs' tiny grid (10 x 64 x 64 voxels, 32 x 64 feature map), its
# frames' points and their one GT box
TINY_OBJECT = {"x_max": 12.8, "y_min": -6.4, "y_max": 6.4}
TINY_DATA = {"max_points": 2048, "max_voxels": 256, "max_gt_boxes": 8}
FRAME_POINTS = 1500
GT_BOX = (6.0, 0.0, -1.0, 1.56, 1.6, 3.9, 0.3)
# the JAX production resolves, which the port maps to its one path
PRODUCTION = {"middle_backend": "wpack2", "train_vfe_backend": "planar",
              "bev_fold": "dsplit"}
# dryrun_multihost: ranks a process of the JAX mesh (its virtual devices)
# and the global batch
DEV_PER_PROC = 4
GLOBAL_BATCH = 8
# sharded against one process, as the JAX dry run holds them
RTOL = 1e-2
# dryrun_multihost: every rank's metrics against rank 0's
# (`__graft_entry__.py:80-86`), and the loss against one process's
# (tests/test_multihost.py)
AGREE_LOSS, AGREE_GNORM, MULTIHOST_LOSS_RTOL = 1e-6, 1e-4, 1e-3
WORKER_TIMEOUT_S = 600
COLLECTIVE_TIMEOUT_S = 300.0


def _card_or(device) -> torch.device:
    """`device`, or the card when None; raises where torch sees none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the entry points run on the card and torch sees no CUDA "
                "device: pass device='cpu' to run them on the CPU")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device")
    return device


@contextlib.contextmanager
def full_f32():
    """f32 matmuls and convs in full f32 on the card for the block (no
    TF32, which cuDNN's convs take by default), the settings restored
    after it, so that the dry runs compare f32 steps that all ran in full
    f32."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


# ---- entry ------------------------------------------------------------------

def entry_config():
    return get_config("Car", data=ENTRY_DATA)


def entry_points() -> tuple[np.ndarray, np.ndarray]:
    """The JAX entry's example frame: ENTRY_POINTS uniform points over the
    Car range from default_rng(0), padded to max_points -> (points (1, N,
    4) f32, num_points (1,) i32)."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([
        rng.uniform([0.0, -40.0, -3.0], [70.4, 40.0, 1.0],
                    (1, ENTRY_POINTS, 3)),
        rng.uniform(0.0, 1.0, (1, ENTRY_POINTS, 1)),
    ], axis=-1).astype(np.float32)
    points = np.zeros((1, ENTRY_DATA["max_points"], 4), np.float32)
    points[:, :ENTRY_POINTS] = pts
    return points, np.full((1,), ENTRY_POINTS, np.int32)


def entry(device=None):
    """(fn, example_args): the single-graph forward of the Car detector,
    from padded points through voxelization, the VFE, the dense grid, the
    middle convs and the RPN to the cls/reg maps (make_maps_fn: the path
    of make_inference_fn up to the heads), and its inputs:
    (build_model(config, seed=0) on the device, points, num_points). `fn`
    takes the model where the JAX entry takes its variables. `device`:
    None for the card (raises without one), "cpu" for the plain
    versions."""
    device = _card_or(device)
    config = entry_config()
    points, num_points = entry_points()
    model = build_model(config, seed=0, device=device)
    return make_maps_fn(config, device), (
        model, torch.from_numpy(points).to(device),
        torch.from_numpy(num_points).to(device))


# ---- the dry runs' configs and batches ------------------------------------

def tiny_config(system: dict, f32: bool = False, data=None, train=None):
    """The Car preset at the dry runs' tiny grid on the mesh `system`."""
    train = dict(train or {})
    if f32:
        train["compute_dtype"] = "float32"
    return get_config("Car", system=dict(system), object=TINY_OBJECT,
                      data=dict(TINY_DATA, **(data or {})), train=train)


def tiny_batch(batch: int):
    """The JAX dry runs' global batch: FRAME_POINTS uniform points a frame
    over the tiny grid from default_rng(0), one GT box -> numpy dict."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([
        rng.uniform([0.0, -6.4, -3.0], [12.8, 6.4, 1.0],
                    (batch, FRAME_POINTS, 3)),
        rng.uniform(0.0, 1.0, (batch, FRAME_POINTS, 1)),
    ], axis=-1).astype(np.float32)
    points = np.zeros((batch, TINY_DATA["max_points"], 4), np.float32)
    points[:, :FRAME_POINTS] = pts
    gt = np.zeros((batch, TINY_DATA["max_gt_boxes"], 7), np.float32)
    gt[:, 0] = GT_BOX
    gt_mask = np.zeros((batch, TINY_DATA["max_gt_boxes"]), bool)
    gt_mask[:, 0] = True
    return {"points": points,
            "num_points": np.full((batch,), FRAME_POINTS, np.int32),
            "gt_boxes": gt, "gt_mask": gt_mask}


def tiled(batch: dict, size: int) -> dict:
    """`size` copies of the batch's first frame (the production step's
    batch)."""
    return {k: np.repeat(v[:1], size, axis=0) for k, v in batch.items()}


def production_path(config) -> str:
    """What the JAX production resolves run on the port: its middle, its
    train voxel table and its fold."""
    return (f"middle[{resolve_plan(config, train=True).middle}], "
            "run_copy table, NCDHW reshape fold")


def local_rows(batch: dict, model: int, device) -> dict:
    """This process's contiguous rows of a global batch: the block of its
    data index (rank // model) of world // model, on `device`."""
    size = len(next(iter(batch.values())))
    local = size // (distributed.world_size() // model)
    lo = distributed.rank() // model * local
    return {k: torch.as_tensor(v[lo:lo + local], device=device)
            for k, v in batch.items()}


def one_step(config, batch: dict, device, model_axis: int = 1,
             model: VoxelNet | None = None):
    """Create a train state (the weights of `model`, by default
    build_model(config, seed=0)) and run ONE train step on this process's
    rows of the global `batch` -> (model after the step, loss,
    grad_norm)."""
    if model is None:
        model = build_model(config, seed=0)
    state = create_train_state(config, model, device=device)
    step = make_train_step(config, device, steps_per_epoch=10)
    state, metrics = step(state, local_rows(batch, model_axis, device))
    return state.model, float(metrics["loss"]), float(metrics["grad_norm"])


# ---- what a rank runs -----------------------------------------------------

def _multichip_rank(job: dict, device) -> dict:
    """The four stages of dryrun_multichip on this rank."""
    n, num_data, num_model = job["world"], job["num_data"], job["num_model"]
    mesh = {"num_data_shards": num_data, "num_model_shards": num_model}
    flat = {"num_data_shards": n, "num_model_shards": 1}
    batch = tiny_batch(2 * num_data)
    train = {"batch_size": 2 * num_data}
    out = {}
    # 1. the (data, model) step: bf16 finite, f32 against one process
    reset_launches()
    model, out["loss"], _ = one_step(tiny_config(mesh, train=train), batch,
                                     device, num_model)
    out["step_launches"] = launch_counts()
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    _, out["loss_f32"], out["gnorm_f32"] = one_step(
        tiny_config(mesh, True, train=train), batch, device, num_model)
    # 2. the production resolves, data parallel over every rank
    size = max(n, 2 * num_data)
    _, out["prod_loss"], out["prod_gnorm"] = one_step(
        tiny_config(flat, True, PRODUCTION, {"batch_size": size}),
        tiled(batch, size), device)
    # 3. inference with the fused VFE over the data ranks
    fused_cfg = tiny_config(flat, data={"vfe_backend": "fused"})
    net = VoxelNet(fused_cfg)
    net.load_state_dict(weights)
    rows = local_rows(tiled(batch, size), 1, device)
    reset_launches()
    det = make_inference_fn(fused_cfg, device)(net.to(device),
                                               rows["points"],
                                               rows["num_points"])
    out["infer_launches"] = launch_counts()
    out["scores_finite"] = bool(torch.isfinite(det.scores).all())
    # 4. sparse1 under the model axis
    out["sparse1"] = None
    if num_model > 1:
        s1_cfg = tiny_config(mesh, data={"middle_backend": "sparse1"},
                             train=train)
        s1 = VoxelNet(s1_cfg)
        s1.load_state_dict(weights)
        rows = local_rows(batch, num_model, device)
        vox = voxelize_table(rows["points"], rows["num_points"],
                             VoxelGridSpec.from_object_config(s1_cfg.object),
                             s1_cfg.data.max_voxels)
        reset_launches()
        with torch.no_grad():
            logits, _ = s1.to(device).eval()(vox.features, vox.coords,
                                             vox.counts)
        out["sparse1_launches"] = launch_counts()
        out["sparse1"] = bool(torch.isfinite(logits).all())
    return out


def _multihost_rank(job: dict, device) -> dict:
    """One train step and the production-resolves step on this rank of the
    (dcn, data, model) = (n, DEV_PER_PROC, 1) mesh."""
    mesh = {"num_dcn_shards": job["n_processes"],
            "num_data_shards": DEV_PER_PROC, "num_model_shards": 1}
    batch = tiny_batch(GLOBAL_BATCH)
    train = {"batch_size": GLOBAL_BATCH}
    reset_launches()
    _, loss, gnorm = one_step(tiny_config(mesh, True, train=train), batch,
                              device)
    out = {"loss": loss, "gnorm": gnorm, "step_launches": launch_counts()}
    _, out["prod_loss"], out["prod_gnorm"] = one_step(
        tiny_config(mesh, True, PRODUCTION, train), batch, device)
    return out


RANK_RUNS = {"multichip": _multichip_rank, "multihost": _multihost_rank}


def worker(job_path: str, rank: int) -> None:
    """A rank of a dry run: join the job's process group, run its part,
    write its results as JSON to <job>.out<rank>."""
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(job["threads"])
    device = distributed.initialize(job["init"], job["world"], rank,
                                    backend="gloo", device=job["device"],
                                    timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        with full_f32():
            out = RANK_RUNS[job["kind"]](job, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        distributed.shutdown()
    with open(f"{job_path}.out{rank}", "w") as f:
        json.dump(out, f)


def run_ranks(kind: str, world: int, device: torch.device,
              **params) -> list[dict]:
    """`world` processes of this module on a job of `kind`, joined over
    gloo, each on `device` (cuda:0 for every rank on the card) -> each
    rank's results. Each process is killed past WORKER_TIMEOUT_S; raises
    on a rank that did not exit 0, with the end of its output."""
    tmp = tempfile.mkdtemp(prefix="graft_entry_")
    try:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump(dict(params, kind=kind, world=world,
                           init="file://" + os.path.join(tmp, "rdv"),
                           device=str(device),
                           threads=1 if device.type == "cpu" else 2), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        if device.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "voxelnet_tpu_torch.graft_entry", job,
             str(r)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"{kind} rank {r} exited {p.returncode}:"
                                   f"\n{log[-4000:]}")
        outs = []
        for r in range(world):
            with open(f"{job}.out{r}") as f:
                outs.append(json.load(f))
        return outs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _assert_close(name: str, a: float, b: float, rtol: float) -> None:
    if not (math.isfinite(a) and math.isfinite(b)
            and abs(a - b) <= rtol * max(abs(a), abs(b), 1e-6)):
        raise AssertionError(f"{name}: sharded {a} vs one process {b} "
                             f"disagree beyond rtol={rtol}")


def _agreed(outs: list[dict], key: str, tol: float) -> float:
    """Rank 0's `key`, after every rank's agrees with it within tol."""
    vals = sorted(o[key] for o in outs)
    if not (math.isfinite(vals[0]) and math.isfinite(vals[-1])
            and vals[-1] - vals[0] <= tol * max(1.0, abs(vals[0]))):
        raise AssertionError(f"{key} differs across ranks: {vals}")
    return outs[0][key]


# ---- the dry runs -----------------------------------------------------------

def dryrun_multichip(n_devices: int, n_processes: int = 1,
                     device=None) -> dict:
    """ONE train step over an n_devices-rank mesh at a tiny grid, each
    rank a process over gloo: batch data parallel over 'data' and the
    grid's W sharded over 'model' (num_model 2 for an even n_devices).
    The stages of the JAX dry run:
      1. the (data, model) step: bf16 finite; in f32 its loss and grad
         norm equal one process's within rtol RTOL;
      2. the JAX production resolves (wpack2, planar, dsplit) data
         parallel over every rank, against one process; the port runs its
         one path for them (resolve_plan), which the printed line names;
      3. inference with vfe_backend='fused' over the data ranks: finite
         scores;
      4. sparse1 under the model axis: finite logits.
    n_processes > 1 runs dryrun_multihost(n_processes) instead. Prints
    one summary line -> the numbers and each rank's launch counts."""
    if n_processes > 1:
        return dryrun_multihost(n_processes, device)
    device = _card_or(device)
    num_model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    num_data = n_devices // num_model
    outs = run_ranks("multichip", n_devices, device, num_data=num_data,
                     num_model=num_model)
    one = {"num_data_shards": 1, "num_model_shards": 1}
    batch = tiny_batch(2 * num_data)
    size = max(n_devices, 2 * num_data)
    prod_cfg = tiny_config(one, True, PRODUCTION, {"batch_size": size})
    with full_f32():
        _, loss1, gnorm1 = one_step(
            tiny_config(one, True, train={"batch_size": 2 * num_data}),
            batch, device)
        _, ploss1, pgnorm1 = one_step(prod_cfg, tiled(batch, size), device)

    loss = _agreed(outs, "loss", AGREE_LOSS)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite bf16 loss {loss}")
    loss8, gnorm8 = (_agreed(outs, "loss_f32", AGREE_LOSS),
                     _agreed(outs, "gnorm_f32", AGREE_GNORM))
    ploss, pgnorm = (_agreed(outs, "prod_loss", AGREE_LOSS),
                     _agreed(outs, "prod_gnorm", AGREE_GNORM))
    _assert_close("auto f32 loss", loss8, loss1, RTOL)
    _assert_close("auto f32 grad_norm", gnorm8, gnorm1, RTOL)
    _assert_close("wpack2+planar f32 loss", ploss, ploss1, RTOL)
    _assert_close("wpack2+planar f32 grad_norm", pgnorm, pgnorm1, RTOL)
    if not all(o["scores_finite"] for o in outs):
        raise AssertionError("fused inference: non-finite scores")
    sparse_ok = "sparse1-skipped"
    if num_model > 1:
        if not all(o["sparse1"] for o in outs):
            raise AssertionError("sparse1 under the model axis: non-finite "
                                 "logits")
        sparse_ok = "sparse1-model-axis OK"
    print(f"dryrun_multichip({n_devices}): mesh data={num_data} "
          f"model={num_model} bf16 loss={loss:.4f}; f32 equality "
          f"{n_devices}-rank vs 1-process: loss {loss8:.6f}=={loss1:.6f} "
          f"grad_norm {gnorm8:.4f}=={gnorm1:.4f}; wpack2+planar+dsplit "
          f"[{production_path(prod_cfg)}] f32 loss {ploss:.6f}=={ploss1:.6f}"
          f" grad_norm {pgnorm:.4f}=={pgnorm1:.4f}; fused-data-parallel OK "
          f"{sparse_ok}")
    return {"num_data": num_data, "num_model": num_model, "loss": loss,
            "loss_f32": (loss8, loss1), "gnorm_f32": (gnorm8, gnorm1),
            "prod_loss": (ploss, ploss1), "prod_gnorm": (pgnorm, pgnorm1),
            "ranks": outs}


def dryrun_multihost(n_processes: int = 2, device=None) -> dict:
    """The JAX multi-host dry run's mesh, (dcn, data, model) =
    (n_processes, DEV_PER_PROC, 1), as DEV_PER_PROC x n_processes ranks,
    each a process over gloo: ONE f32 train step on the global batch of
    GLOBAL_BATCH frames (each rank its rows), then the production-resolves
    step. Loss and grad norm must agree across ranks and equal one
    process's. Prints one summary line -> the numbers and each rank's
    launch counts."""
    device = _card_or(device)
    world = DEV_PER_PROC * n_processes
    if GLOBAL_BATCH % world:
        raise ValueError(f"the global batch of {GLOBAL_BATCH} frames does "
                         f"not split over {world} ranks")
    outs = run_ranks("multihost", world, device, n_processes=n_processes)
    one = {"num_data_shards": 1, "num_model_shards": 1}
    train = {"batch_size": GLOBAL_BATCH}
    batch = tiny_batch(GLOBAL_BATCH)
    prod_cfg = tiny_config(one, True, PRODUCTION, train)
    with full_f32():
        _, loss1, gnorm1 = one_step(tiny_config(one, True, train=train),
                                    batch, device)
        _, ploss1, pgnorm1 = one_step(prod_cfg, batch, device)
    loss, gnorm = (_agreed(outs, "loss", AGREE_LOSS),
                   _agreed(outs, "gnorm", AGREE_GNORM))
    ploss, pgnorm = (_agreed(outs, "prod_loss", AGREE_LOSS),
                     _agreed(outs, "prod_gnorm", AGREE_GNORM))
    _assert_close("loss", loss, loss1, MULTIHOST_LOSS_RTOL)
    _assert_close("grad_norm", gnorm, gnorm1, RTOL)
    _assert_close("production loss", ploss, ploss1, MULTIHOST_LOSS_RTOL)
    _assert_close("production grad_norm", pgnorm, pgnorm1, RTOL)
    print(f"dryrun_multihost({n_processes}): loss={loss:.8f} "
          f"grad_norm={gnorm:.8f} agreed across {world} ranks "
          f"({n_processes} x {DEV_PER_PROC}) and with one process "
          f"({loss1:.8f}, {gnorm1:.8f}); production resolves "
          f"[wpack2+planar+dsplit -> {production_path(prod_cfg)}] "
          f"loss={ploss:.8f} grad_norm={pgnorm:.8f} agreed OK")
    return {"world": world, "loss": (loss, loss1), "gnorm": (gnorm, gnorm1),
            "prod_loss": (ploss, ploss1), "prod_gnorm": (pgnorm, pgnorm1),
            "ranks": outs}


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]))
