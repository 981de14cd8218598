"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
configs for both packages from one set of overrides, JAX variables with
random BatchNorm affines and statistics, and their torch model; the
launcher of the gloo worker processes (tests/torch_dp_worker.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# the tiny grid of tests/conftest.py::tiny_config (10 x 64 x 64 voxels)
TINY = {
    "object": {"x_max": 12.8, "y_min": -6.4, "y_max": 6.4},
    "data": {"max_points": 2048, "max_voxels": 256, "max_gt_boxes": 8},
    "train": {"batch_size": 2, "compute_dtype": "float32"},
}


@pytest.fixture(autouse=True)
def two_torch_threads():
    """Two intra-op threads for each test of a file that imports this
    fixture: the test runner's workers share the cores, and torch's
    default of one thread per core oversubscribes them (the gloo workers
    of tests/test_torch_parallel.py then outlast their timeout)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def merged(base: dict, **extra) -> dict:
    out = {k: dict(v) for k, v in base.items()}
    for group, values in extra.items():
        out.setdefault(group, {}).update(values)
    return out


def configs(class_name="Car", overrides=TINY):
    """(JAX config, port config) built from the same overrides."""
    from voxelnet_tpu.config import get_config as jax_get_config

    from voxelnet_tpu_torch.config import get_config

    return (jax_get_config(class_name, **overrides),
            get_config(class_name, **overrides))


def randomize_bn(variables, seed: int):
    """Numpy copy of a flax variables tree with every BatchNorm's scale,
    bias, mean and var drawn at random (scale/var in [0.5, 1.5], bias/mean
    ~ N(0, 0.1)), so eval-mode BN and its folds do real work."""
    import jax

    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda x: np.array(x, np.float32), variables)

    def walk(params, stats):
        for key, sub in params.items():
            if isinstance(sub, dict) and "scale" in sub:
                n = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                stats[key]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(key, {}))

    walk(out["params"], out["batch_stats"])
    return out


def jax_variables(cfg, seed: int = 0):
    """Random flax variables of the JAX VoxelNet for `cfg`, made with numpy
    from the tree's shapes (no init compile): kernels uniform in
    +-1/sqrt(fan_in), biases in +-0.1, random BatchNorms."""
    import jax
    import jax.numpy as jnp

    from voxelnet_tpu.models.voxelnet import build_model

    T = cfg.object.points_per_voxel
    shapes = jax.eval_shape(lambda: build_model(cfg, platform="cpu").init(
        jax.random.key(0), jnp.zeros((1, 1, T, 7)),
        jnp.zeros((1, 1, 3), jnp.int32), jnp.zeros((1, 1), jnp.int32)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        bound = (1.0 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
                 else 0.1)
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    return randomize_bn(variables, seed + 100)


def init_scale_biases(variables, seed):
    """Biases uniform in +-1/sqrt(fan_in), the scale of the real init
    (models/init.py), in place of the helper's +-0.1."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for sub in tree.values():
            if isinstance(sub, dict) and "kernel" in sub:
                bound = 1.0 / np.sqrt(np.prod(sub["kernel"].shape[:-1]))
                sub["bias"] = rng.uniform(-bound, bound, sub["bias"].shape
                                          ).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(variables["params"])
    return variables


def torch_model(port_cfg, variables):
    from voxelnet_tpu_torch.convert import from_jax_variables
    from voxelnet_tpu_torch.models.voxelnet import VoxelNet

    model = VoxelNet(port_cfg)
    model.load_state_dict(from_jax_variables(variables))
    return model.eval()


def random_points(rng, cfg, batch: int, n: int):
    """(B, max_points, 4) points uniform over the grid box plus a margin
    outside it, and (B,) counts n."""
    obj = cfg.object
    lo = np.asarray([obj.x_min - 1.0, obj.y_min - 1.0, obj.z_min - 0.5])
    hi = np.asarray([obj.x_max + 1.0, obj.y_max + 1.0, obj.z_max + 0.5])
    pts = np.zeros((batch, cfg.data.max_points, 4), np.float32)
    pts[:, :n, :3] = rng.uniform(lo, hi, (batch, n, 3))
    pts[:, :n, 3] = rng.uniform(0.0, 1.0, (batch, n))
    return pts, np.full((batch,), n, np.int32)


def jax_voxel_table(jcfg, rng, batch: int = 4, n: int = 1500):
    """JAX's voxel table (`voxelize_batch_jax`) of `batch` random frames
    of `n` points, as numpy: features, coords, counts."""
    import jax.numpy as jnp

    from voxelnet_tpu.ops.voxelize import VoxelGridSpec, voxelize_batch_jax

    points, num = random_points(rng, jcfg, batch, n)
    vox = voxelize_batch_jax(jnp.asarray(points), jnp.asarray(num),
                             VoxelGridSpec.from_object_config(jcfg.object),
                             jcfg.data.max_voxels)
    return tuple(np.asarray(t) for t in (vox.features, vox.coords,
                                         vox.counts))


def step_batch(cfg, seed=0, n=1800):
    """A train-step batch of 2 frames: random points off the voxel
    lattice (the jitted JAX voxelizer bins lattice points by a reciprocal
    multiply) and two GT cars per frame, the second frame's second one
    masked. The GTs sit where no two anchors tie for their best IoU
    (tests/test_torch_train.py::_assert_no_ties)."""
    rng = np.random.default_rng(seed)
    points, num = random_points(rng, cfg, 2, n)
    num[1] = n - 400
    G = cfg.data.max_gt_boxes
    gt = np.zeros((2, G, 7), np.float32)
    gt[:, 0] = [6.25, 0.18, -1.0, 1.56, 1.6, 3.9, 0.05]
    gt[:, 1] = [9.55, 2.3, -1.0, 1.56, 1.6, 3.9, 1.52]
    gt[1, 0, :2] += [0.137, -0.111]
    gt_mask = np.zeros((2, G), bool)
    gt_mask[0, :2] = True
    gt_mask[1, 0] = True
    return {"points": points, "num_points": num, "gt_boxes": gt,
            "gt_mask": gt_mask}


def assert_bf16_close(got: torch.Tensor, want: np.ndarray):
    """At least 99.9% of the elements bit-equal as values, the rest
    within 2**-7 relative (one bf16 ulp at a rounding boundary): the f32
    accumulation order of the two dot products differs."""
    g = got.to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    equal = g == w
    assert equal.mean() >= 0.999, equal.mean()
    rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
    assert (rel[~equal] <= 2.0 ** -7).all(), rel[~equal].max()


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# KITTI label lines of the mini-KITTI trees: two Cars, a Van, a
# Pedestrian and a DontCare region (camera frame, mean calib)
LABEL_LINES = (
    "Car 0.00 0 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 -0.65 "
    "1.71 6.70 -1.59\n",
    "Car 0.20 1 1.21 387.01 170.40 450.90 214.00 1.52 1.61 3.92 -2.45 "
    "1.69 8.21 1.12\n",
    "Van 0.00 2 -1.02 100.00 150.00 200.00 220.00 2.10 1.90 5.00 2.90 "
    "1.80 10.50 -0.31\n",
    "Pedestrian 0.00 0 0.33 700.00 160.00 720.00 230.00 1.70 0.60 0.80 "
    "1.40 1.70 5.10 0.20\n",
    "DontCare -1 -1 -10 500.00 170.00 520.00 190.00 -1 -1 -1 -1000 -1000 "
    "-1000 -10\n",
)


def write_mini_kitti(root, splits=(("training", 4), ("validation", 2)),
                     n_points=1200, seed=0, labels=LABEL_LINES[:1]):
    """A KITTI tree (velodyne/, label_2/, image_2/ per split) at the tiny
    grid, as tests/test_trainer_epoch_val.py's fixture builds it: frame i
    holds `n_points` uniform points over the grid box (numpy, `seed`) and
    the label lines `labels`."""
    import os

    rng = np.random.default_rng(seed)
    for split, n in splits:
        for sub in ("velodyne", "label_2", "image_2"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            pts = np.concatenate([
                rng.uniform([0, -6.4, -3], [12.8, 6.4, 1], (n_points, 3)),
                rng.uniform(0, 1, (n_points, 1))], axis=1).astype(np.float32)
            pts.tofile(os.path.join(root, split, "velodyne", f"{i:06d}.bin"))
            with open(os.path.join(root, split, "label_2", f"{i:06d}.txt"),
                      "w") as f:
                f.writelines(labels)
            open(os.path.join(root, split, "image_2", f"{i:06d}.png"),
                 "wb").close()
    return root


def fake_group(monkeypatch, world: int, rank: int = 0) -> None:
    """A stand-in process group of `world` processes, this one `rank`:
    torch's new_group only records that it was called."""
    from voxelnet_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "is_initialized", lambda: world > 1)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    monkeypatch.setattr(distributed, "rank", lambda: rank)
    monkeypatch.setattr(distributed, "_handles", {})
    monkeypatch.setattr(distributed.dist, "new_group", lambda ranks: ranks)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
# a hang guard: a launch takes about 50 s alone, and over twice that
# while the test runner's other workers load every core
WORKER_TIMEOUT_S = 300


def start_workers(tmp: str, cases: dict, world: int, name: str = "job",
                  threads: int = 2):
    """Start `world` worker processes of `threads` torch threads each on
    `cases`, joined by a file:// rendezvous under `tmp` -> a handle for
    finish_workers."""
    job = os.path.join(tmp, f"{name}.pt")
    torch.save({"world": world, "cases": cases, "threads": threads,
                "init": "file://" + os.path.join(tmp, f"{name}.rdv")}, job)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    return job, [subprocess.Popen([sys.executable, WORKER, job, str(r)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]


def finish_workers(started) -> list[dict]:
    """Wait for the workers of start_workers, WORKER_TIMEOUT_S each at
    most (killed past it) -> each rank's results; fails on a worker that
    did not exit 0, with the end of its output."""
    job, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(f"{job}.out{r}", weights_only=False)
            for r in range(len(procs))]
