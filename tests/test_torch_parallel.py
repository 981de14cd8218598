"""The port's data parallelism on the CPU: two worker processes in a gloo
group (tests/torch_dp_worker.py, a file:// rendezvous under tmp_path, 2
threads each, 300 s each at most) against one process on the global batch,
and against the JAX package's train step on a 2-device mesh.

Port against port runs in f64, the model's master weights included (the
BatchNorms then keep f64 statistics), so a global batch split across the
ranks gives the one-process result to f64 rounding: rel 1e-9. Against JAX
the f32 master weights and test_torch_train.py's tolerances hold. One
worker launch runs every case; the module's tests read its results."""

import os

import numpy as np
import pytest
import torch
from torch_dp_worker import bn_case, step_case, trainer_case
from torch_port_helpers import (TINY, configs, fake_group, finish_workers,
                                init_scale_biases, jax_variables, merged,
                                start_workers, step_batch, torch_model,
                                write_mini_kitti)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch.cli import train as train_cli
from voxelnet_tpu_torch.config import get_config, resolve_plan
from voxelnet_tpu_torch.models.voxelnet import build_model
from voxelnet_tpu_torch.parallel import distributed, mesh

REL = 1e-9
STEPS_PER_EPOCH = 10

# the port-only steps: f64 at the tiny grid, one frame a rank
F64 = merged(TINY, train={"compute_dtype": "float64"})
STEP_CASES = {f"clip{clip:g}-{remat}": (clip, remat)
              for clip in (5.0, 1e9) for remat in ("none", "seams")}
# the step held to JAX: test_torch_train.py's f64 step (2048 voxel slots)
JAX_F64 = merged(TINY, train={"compute_dtype": "float64"},
                 data={"max_voxels": 2048, "max_points": 8192})
# the trainer: a 10 x 32 x 32 grid, 4 train frames (2 steps of B=2), 3 val
# frames (a padded last val batch), f64
TRAINER = merged(TINY, object={"x_min": 3.2, "x_max": 9.6, "y_min": -3.2,
                               "y_max": 3.2},
                 train={"compute_dtype": "float64", "num_epochs": 1,
                        "num_workers": 2, "upload_points": "f32"},
                 val={"batch_size": 2})


def run_workers(tmp: str, cases: dict, world: int = 2) -> list[dict]:
    """Run `cases` in `world` worker processes -> each rank's results."""
    return finish_workers(start_workers(tmp, cases, world))


def _bn_inputs(rng, masked: bool) -> dict:
    c = 16
    shape = (4, 12, 5, c) if masked else (4, c, 3, 5, 6)
    channel_dim = -1 if masked else 1
    state = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, .1, c),
             "running_mean": rng.normal(0, .1, c),
             "running_var": rng.uniform(0.5, 1.5, c)}
    kw = {"x": torch.from_numpy(rng.normal(0.3, 2.0, shape)),
          "w": torch.from_numpy(rng.normal(0, 1, shape)),
          "bn_state": {k: torch.from_numpy(v) for k, v in state.items()},
          "channel_dim": channel_dim}
    if masked:
        counts = rng.integers(0, 6, (4, 12))
        counts[:, 0] = 5
        kw["mask"] = torch.from_numpy(
            np.arange(5)[None, None, :, None] < counts[..., None, None])
    return kw


def _all_cases(tmp: str) -> dict:
    rng = np.random.default_rng(0)
    cases = {"allreduce": ("allreduce", {})}
    for masked in (False, True):
        cases[f"bn-{'masked' if masked else 'dense'}"] = (
            "bn", _bn_inputs(rng, masked))
    cfg = get_config("Car", **F64)
    init = build_model(cfg, seed=3).state_dict()
    batch = step_batch(cfg, seed=3, n=1800)
    for name, (clip, remat) in STEP_CASES.items():
        cases[f"step-{name}"] = ("step", {
            "overrides": merged(F64, train={"gradient_clip": clip,
                                            "remat": remat}),
            "state_dict": init, "batch": batch, "double": True,
            "steps_per_epoch": STEPS_PER_EPOCH})
    cases["step-momentum"] = ("step", {
        "overrides": F64, "state_dict": init, "batch": batch,
        "double": True, "steps_per_epoch": STEPS_PER_EPOCH,
        "momentum": 0.9, "steps": 2})
    jcfg, tcfg = configs(overrides=JAX_F64)
    variables = init_scale_biases(jax_variables(jcfg, seed=21), 21)
    cases["step-jax"] = ("step", {
        "overrides": JAX_F64,
        "state_dict": torch_model(tcfg, variables).state_dict(),
        "batch": step_batch(tcfg, seed=21, n=8000),
        "steps_per_epoch": STEPS_PER_EPOCH})
    data = write_mini_kitti(os.path.join(tmp, "kitti"), n_points=4000,
                            splits=(("training", 4), ("validation", 3)))
    cases["trainer"] = ("trainer", {
        "overrides": TRAINER, "data": data,
        "exp_dir": os.path.join(tmp, "exp2"),
        "state_dict": build_model(get_config("Car", **TRAINER),
                                  seed=5).state_dict()})
    return cases


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """(cases, [rank 0 results, rank 1 results]) of one 2-rank run."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    cases = _all_cases(tmp)
    return cases, run_workers(tmp, cases)


def _close(got, want, what):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape, what
    torch.testing.assert_close(got.double(), want.double(), rtol=REL,
                               atol=REL * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


# --- the helpers --------------------------------------------------------------

def test_all_reduce_sum_forward_and_backward(dp):
    """Rank r holds x = r + 1; y = all_reduce_sum(x^2) is 5 on both; each
    rank's backward of y gives the global gradient 2 * 2 * x: 4 and 8."""
    _, outs = dp
    assert [o["allreduce"]["y"] for o in outs] == [5.0, 5.0]
    assert [o["allreduce"]["grad"] for o in outs] == [4.0, 8.0]
    x = torch.tensor(3.0, requires_grad=True)
    assert distributed.all_reduce_sum(x) is x      # no group: the identity
    assert distributed.all_reduce_([x])[0] is x
    one = mesh.process_mesh(get_config("Car").system)
    assert one.process_shard() is None
    assert one.local_num_real(3, 4) == 3


@pytest.mark.parametrize("shards,world,want", [
    ({}, 1, (1, 0, 1, 0, 0)),
    ({"num_data_shards": 2}, 2, (2, 1, 1, 1, 0)),
    ({"num_dcn_shards": 2, "num_data_shards": 2}, 4, (4, 1, 1, 1, 0)),
    # the 'model' axis: ranks laid out as JAX lays out devices,
    # rank = data index * num_model + model index
    ({"num_model_shards": 2}, 2, (2, 1, 2, 0, 1)),
    ({"num_data_shards": 2, "num_model_shards": 2}, 4, (4, 1, 2, 0, 1)),
])
def test_mesh_maps_batch_axes_onto_processes(monkeypatch, shards, world,
                                             want):
    """(world size, rank, model axis, data index, model index) of rank 1
    (rank 0 alone), and the plan's world size and rank."""
    fake_group(monkeypatch, world, min(1, world - 1))
    cfg = get_config("Car", system=shards)
    got = mesh.process_mesh(cfg.system)
    assert got[:5] == want
    assert resolve_plan(cfg, train=True)[2:4] == want[:2]
    if want[2] > 1:
        m, d = want[4], want[3]
        assert got.model_group.ranks == tuple(
            range(d * want[2], (d + 1) * want[2]))
        assert got.data_group.ranks == tuple(range(m, world, want[2]))


@pytest.mark.parametrize("shards,world,match", [
    ({"num_model_shards": 2}, 1, "no torch.distributed process group"),
    ({"num_data_shards": 2, "num_model_shards": 2}, 2,
     "= 4, but 2 processes.*--nproc_per_node 4"),
    # JAX's sparse1 refusal; conv3d takes uneven slabs there
    ({"num_model_shards": 3, "data": {"middle_backend": "sparse1"}}, 3,
     "W=352 must divide by num_model_shards=3"),
    # a grid of 350 columns is not a whole number of the RPN's units of
    # 2 x 4 (Car's 352 in 8 slabs of 44 columns is cut 48 x 4, 40 x 4)
    ({"num_model_shards": 8, "object": {"x_max": 70.0}}, 8,
     "multiple of rpn.block1_stride x 4 = 8"),
    ({"num_data_shards": 2}, 1, "no torch.distributed process group"),
    ({"num_data_shards": 4}, 2, "--nproc_per_node 4"),
    ({}, 2, "system.num_data_shards: 2"),
])
def test_mesh_refusals_say_what_to_do(monkeypatch, shards, world, match):
    """`shards` is the system section; another section of the config
    rides under its own key."""
    fake_group(monkeypatch, world, 0)
    sections = {k: v for k, v in shards.items() if isinstance(v, dict)}
    system = {k: v for k, v in shards.items() if k not in sections}
    with pytest.raises(ValueError, match=match):
        resolve_plan(get_config("Car", system=system, **sections))


@pytest.mark.parametrize("data,match", [
    ({"middle_backend": "sparsebwd"}, "'sparsebwd' does not partition over "
     "the spatial 'model' axis"),
    ({"vfe_backend": "fused"}, "'fused' does not partition over the "
     "spatial 'model' axis"),
    ({"dense_build": "pallas"}, "'pallas' does not partition over a mesh"),
])
def test_model_axis_refuses_what_jax_refuses(monkeypatch, data, match):
    """The JAX resolvers' refusals under a 'model' axis, with their
    messages (`voxelnet_tpu/models/voxelnet.py:226-230, 393-397,
    434-445`); without the axis the same knobs resolve."""
    fake_group(monkeypatch, 2, 0)
    with pytest.raises(ValueError, match=match):
        resolve_plan(get_config("Car", data=data,
                                system={"num_model_shards": 2}))
    assert resolve_plan(get_config("Car", data=data,
                                   system={"num_data_shards": 2}))


def test_train_cli_refuses_several_processes_without_exp_dir(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--exp-dir"):
        train_cli.main(["--device", "cpu", "--data-dir", "/nonexistent"])
    assert not distributed.is_initialized()


# --- BatchNorm over the global batch ------------------------------------------

@pytest.mark.parametrize("case", ["bn-dense", "bn-masked"])
def test_batch_norm_statistics_are_global(dp, case):
    """flax_batch_norm on 2 ranks == one process on the global batch:
    values, the input's gradient, the affine's gradient (summed over the
    ranks) and the running stats (the same on each rank), f64."""
    cases, outs = dp
    want = bn_case(**cases[case][1])
    _close(torch.cat([o[case]["y"] for o in outs]), want["y"], "y")
    _close(torch.cat([o[case]["x_grad"] for o in outs]), want["x_grad"],
           "x_grad")
    for key in ("weight_grad", "bias_grad"):
        _close(sum(o[case][key] for o in outs), want[key], key)
    for key in ("running_mean", "running_var"):
        for o in outs:
            _close(o[case][key], want[key], key)
        assert not torch.equal(want[key], cases[case][1]["bn_state"][key])


# --- the train step -------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_on_two_ranks_equals_one_process(dp, name):
    """One f64 step on 2 ranks (one frame each) == one process on both
    frames: loss and its parts, the pre-clip grad norm, every parameter and
    BN running stat; with the clip binding (5) and not (1e9), without and
    with the seams recompute. The ranks end bit-identical."""
    cases, outs = dp
    want = step_case(**cases[f"step-{name}"][1])
    clip = STEP_CASES[name][0]
    assert (want["metrics"]["grad_norm"] > clip) == (clip == 5.0)
    for o in outs:
        got = o[f"step-{name}"]
        assert got["disagree"] == 0
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=REL), k
        for k, v in want["state"].items():
            _close(got["state"][k], v, k)
    assert outs[0]["step-" + name]["metrics"]["voxels_clipped"] == 2


def test_momentum_steps_on_two_ranks_equal_one_process(dp):
    """Two f64 momentum steps on 2 ranks, each rank's trace made otherwise
    and then broadcast from rank 0 (a resumed run): equal to one process
    from rank 0's trace (loss, grad norm, parameters, BN stats and the
    trace), and the ranks end bit-identical, traces included."""
    cases, outs = dp
    want = step_case(**cases["step-momentum"][1])
    assert want["trace"] is not None
    for o in outs:
        got = o["step-momentum"]
        assert got["disagree"] == 0
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=REL), k
        for k, v in want["state"].items():
            _close(got["state"][k], v, k)
        for i, (g, w) in enumerate(zip(got["trace"], want["trace"])):
            _close(g, w, f"trace {i}")
    for a, b in zip(outs[0]["step-momentum"]["trace"],
                    outs[1]["step-momentum"]["trace"]):
        assert torch.equal(a, b)


def test_train_step_on_two_ranks_matches_jax_mesh(dp):
    """The 2-rank port step against the JAX package's make_train_step on a
    2-device mesh (data axis 2), x64, from the same weights and batch, at
    test_torch_train.py's f64-step tolerances (f32 master weights; f32 BN
    statistics in JAX), but for the loss parts: JAX's mesh step sums its
    f32 BN statistics per shard, and on these inputs its reg_loss differs
    from its own single-device step's by 8.8e-5 relative (the port's by
    4.6e-7 from the single-device one, 8.9e-5 from the mesh one), so the
    parts are held at 2e-4."""
    import jax
    import jax.numpy as jnp

    from voxelnet_tpu.parallel import make_mesh, shard_batch
    from voxelnet_tpu.training.optim import make_optimizer
    from voxelnet_tpu.training.train_step import TrainState
    from voxelnet_tpu.training.train_step import \
        make_train_step as jax_make_train_step
    from voxelnet_tpu_torch import convert

    cases, outs = dp
    kw = cases["step-jax"][1]
    jcfg, _ = configs(overrides=JAX_F64)
    variables = convert.to_jax_variables(kw["state_dict"])
    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    dmesh = make_mesh(num_data=2, num_model=1)
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.set_mesh(dmesh):
            state = TrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]))
            step = jax_make_train_step(jcfg, tx, donate=False, mesh=dmesh)
            new, metrics = step(state, shard_batch(dmesh, kw["batch"]))
            want = {k: float(v) for k, v in metrics.items()}
            want_p = jax.tree.map(np.asarray, new.params)
            want_s = jax.tree.map(np.asarray, new.batch_stats)
    finally:
        jax.config.update("jax_enable_x64", False)

    got = outs[0]["step-jax"]
    assert outs[1]["step-jax"]["disagree"] == 0
    m = got["metrics"]
    assert m["loss"] == pytest.approx(want["loss"], rel=5e-5)
    assert m["grad_norm"] == pytest.approx(want["grad_norm"], rel=5e-3)
    for name in ("cls_loss", "reg_loss", "cls_pos_loss", "cls_neg_loss"):
        assert m[name] == pytest.approx(want[name], rel=2e-4), name
    assert m["voxels_clipped"] == want["voxels_clipped"] == 2
    port = convert.to_jax_variables(got["state"])
    before = _leaves(variables["params"])
    got_p, jax_p = _leaves(port["params"]), _leaves(want_p)
    assert got_p.keys() == jax_p.keys()
    for path, leaf in jax_p.items():
        np.testing.assert_allclose(got_p[path], leaf, rtol=0, atol=2e-4,
                                   err_msg=path)
        dg, dw = got_p[path] - before[path], leaf - before[path]
        assert (np.linalg.norm(dg - dw)
                <= 0.1 * np.linalg.norm(dw) + 1e-6), path
    got_s, jax_s = _leaves(port["batch_stats"]), _leaves(want_s)
    for path, leaf in jax_s.items():
        np.testing.assert_allclose(got_s[path], leaf, rtol=0, atol=2e-5,
                                   err_msg=path)


def _leaves(tree):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# --- the trainer ----------------------------------------------------------------

def test_trainer_epoch_on_two_ranks_equals_one_process(dp, tmp_path):
    """One Trainer epoch on 2 ranks (global B=2, per-rank loading) == one
    process at the same global batch, f64: best val loss and step, step
    count, checkpointed weights and BN stats; the ranks end bit-identical;
    the per-rank label dumps together cover every val frame once (3 frames
    in batches of 2: rank 0 writes 2, rank 1 one, not the padding)."""
    cases, outs = dp
    kw = dict(cases["trainer"][1], exp_dir=str(tmp_path / "exp1"))
    want = trainer_case(**kw)
    for o in outs:
        got = o["trainer"]
        assert got["disagree"] == 0
        assert got["best_step"] == want["best_step"] == 0
        assert got["step"] == want["step"] == 2
        assert got["best_metric"] == pytest.approx(want["best_metric"],
                                                   rel=REL)
        for k, v in want["state"].items():
            _close(got["state"][k], v, k)
    assert [o["trainer"]["dumped"] for o in outs] == [[2], [1]]
    assert want["dumped"] == [3]
    exp2 = cases["trainer"][1]["exp_dir"]
    val = sorted(os.listdir(os.path.join(kw["data"], "validation",
                                         "velodyne")))
    for exp in (exp2, kw["exp_dir"]):
        dumped = sorted(os.listdir(os.path.join(exp, "preds", "1", "data")))
        assert [f[:-4] for f in dumped] == [f[:-4] for f in val]
    assert os.listdir(os.path.join(exp2, "checkpoints")) == ["0"]
    saved = torch.load(os.path.join(exp2, "checkpoints", "0", "state.pt"),
                       weights_only=True)
    for k, v in want["state"].items():
        _close(saved["model"][k], v, k)
