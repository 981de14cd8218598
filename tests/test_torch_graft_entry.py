"""The port's root entry points (voxelnet_tpu_torch/graft_entry.py)
against the JAX package's `__graft_entry__.py`: entry's example inputs
bit-equal, its forward from JAX's own key(0) variables carried across
(convert.from_jax_variables) equal to JAX's jitted forward (voxel coords
exactly, the bf16 maps within a stated share of their spread), the dry
runs' one-process f32 step from JAX's key(0) state equal to JAX's
single-device step, and both dry runs on the CPU, every rank a gloo
process."""

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import torch_model
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch import graft_entry
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.convert import from_jax_variables
from voxelnet_tpu_torch.models.voxelnet import VoxelNet, make_maps_fn
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, prepare

# bf16 maps, port against JAX: the largest and the mean absolute
# difference as shares of the JAX map's standard deviation. The port folds
# each BN into its conv's bf16 weights where flax applies it after the
# bf16 conv, and the two sum their products in other orders; measured on
# the CPU: cls 0.013 / 0.0022, reg 0.0077 / 0.0013
MAP_MAX_SHARE, MAP_MEAN_SHARE = 0.05, 0.01
# one f32 train step, port against JAX from the same variables: the
# train-stage tolerances of tests/test_torch_bench.py (XLA:CPU's sequential
# f32 BN statistics move JAX's step; the docstring there has the figures)
STEP_LOSS_REL, STEP_GNORM_REL = 5e-4, 1e-2


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry (forward, (variables, points, num_points)) and its
    jitted forward's (cls, reg), as numpy."""
    import __graft_entry__

    forward, args = __graft_entry__.entry()
    cls, reg = jax.jit(forward)(*args)
    return forward, args, np.asarray(cls), np.asarray(reg)


def test_entry_inputs_bit_equal_jax(jax_entry):
    _, (_, points, num_points), _, _ = jax_entry
    fn, (model, got_points, got_num) = graft_entry.entry("cpu")
    assert got_points.dtype == torch.float32 and got_num.dtype == torch.int32
    np.testing.assert_array_equal(got_points.numpy(), np.asarray(points))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(num_points))
    assert isinstance(model, VoxelNet) and not model.training
    cfg = graft_entry.entry_config()
    assert (cfg.data.max_points, cfg.data.max_voxels) == (16384, 6144)
    assert cfg.train.compute_dtype == "bfloat16"


def test_entry_forward_equals_jax(jax_entry):
    """From JAX's key(0) variables: the voxel coords and counts of the
    jitted JAX voxelizer exactly, then the cls and reg maps within
    MAP_MAX_SHARE / MAP_MEAN_SHARE of their spread."""
    from voxelnet_tpu.ops.voxelize import VoxelGridSpec as JaxSpec
    from voxelnet_tpu.ops.voxelize import voxelize_batch_jax

    _, (variables, points, num_points), want_cls, want_reg = jax_entry
    cfg = graft_entry.entry_config()
    jvox = jax.jit(lambda p, n: voxelize_batch_jax(
        p, n, JaxSpec.from_object_config(cfg.object),
        cfg.data.max_voxels))(points, num_points)
    prep = prepare(torch.from_numpy(np.array(points)),
                   torch.from_numpy(np.array(num_points)),
                   VoxelGridSpec.from_object_config(cfg.object),
                   cfg.data.max_voxels)
    np.testing.assert_array_equal(prep.coords.numpy(), np.asarray(jvox.coords))
    np.testing.assert_array_equal(prep.counts.numpy(), np.asarray(jvox.counts))

    fn, (_, got_points, got_num) = graft_entry.entry("cpu")
    model = VoxelNet(cfg)
    model.load_state_dict(from_jax_variables(
        jax.tree.map(lambda x: np.array(x, np.float32), variables)))
    cls, reg = fn(model.eval(), got_points, got_num)
    for name, got, want in (("cls", cls, want_cls), ("reg", reg, want_reg)):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        diff = np.abs(got.numpy() - want)
        spread = want.std()
        assert spread > 0 and np.isfinite(got.numpy()).all(), name
        assert diff.max() <= MAP_MAX_SHARE * spread, (name, diff.max(),
                                                       spread)
        assert diff.mean() <= MAP_MEAN_SHARE * spread, (name, diff.mean(),
                                                        spread)
    assert cls.shape == (1, 200, 176, 2) and reg.shape == (1, 200, 176, 14)


def test_entry_forward_follows_weight_changes():
    """fn re-folds the model after its weights change in place, as
    make_inference_fn does."""
    cfg = graft_entry.tiny_config({"num_data_shards": 1}, f32=True)
    fn = make_maps_fn(cfg, "cpu")
    model = graft_entry.build_model(cfg, seed=0)
    batch = graft_entry.tiny_batch(1)
    first = fn(model, batch["points"], batch["num_points"])[1].clone()
    with torch.no_grad():
        model.rpn.reg_conv.bias.add_(1.0)
    second = fn(model, batch["points"], batch["num_points"])[1]
    torch.testing.assert_close(second, first + 1.0, rtol=0, atol=1e-5)


def test_maps_fn_refuses_a_model_of_another_vfe():
    """entry's forward is make_inference_fn's front half, with its check
    that the model's VFE matches the config's compat.bn_over_padding."""
    cfg = graft_entry.tiny_config({"num_data_shards": 1}, f32=True)
    ghost = get_config(
        "Car", object=graft_entry.TINY_OBJECT, data=graft_entry.TINY_DATA,
        train={"compute_dtype": "float32"}, compat={"bn_over_padding": True})
    batch = graft_entry.tiny_batch(1)
    with pytest.raises(ValueError, match="bn_over_padding"):
        make_maps_fn(ghost, "cpu")(graft_entry.build_model(cfg, seed=0),
                                   batch["points"], batch["num_points"])


def test_dryrun_one_process_step_equals_jax():
    """The dry runs' one-process f32 step (graft_entry.one_step on the
    batch of dryrun_multichip(4)) from JAX's own key(0) train state,
    carried across, against JAX's single-device step on that batch as
    `__graft_entry__.py` takes it (a 1-device mesh, steps_per_epoch 10):
    loss within STEP_LOSS_REL, the pre-clip grad norm within
    STEP_GNORM_REL."""
    from voxelnet_tpu.config import get_config as jax_get_config
    from voxelnet_tpu.parallel import make_mesh, shard_batch
    from voxelnet_tpu.training import create_train_state, make_train_step
    from voxelnet_tpu.training.optim import make_optimizer

    one = {"num_data_shards": 1, "num_model_shards": 1}
    train = {"batch_size": 4, "compute_dtype": "float32"}
    batch = graft_entry.tiny_batch(train["batch_size"])
    jcfg = jax_get_config("Car", system=one, object=graft_entry.TINY_OBJECT,
                          data=graft_entry.TINY_DATA, train=train)
    mesh = make_mesh(num_data=1, num_model=1, devices=jax.devices()[:1])
    with jax.set_mesh(mesh):
        tx = make_optimizer(jcfg, steps_per_epoch=10)
        state = create_train_state(jcfg, tx, jax.random.key(0))
        variables = jax.tree.map(
            lambda x: np.array(x, np.float32),
            {"params": state.params, "batch_stats": state.batch_stats})
        _, want = make_train_step(jcfg, tx, donate=False, mesh=mesh)(
            state, shard_batch(mesh, batch))
    cfg = graft_entry.tiny_config(one, True, train=train)
    _, loss, gnorm = graft_entry.one_step(cfg, batch, "cpu",
                                          model=torch_model(cfg, variables))
    assert float(want["reg_loss"]) > 0          # the GT box is in the grid
    assert loss == pytest.approx(float(want["loss"]), rel=STEP_LOSS_REL)
    assert gnorm == pytest.approx(float(want["grad_norm"]),
                                  rel=STEP_GNORM_REL)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="sees no CUDA"):
        graft_entry.dryrun_multichip(2, device="cuda")


def test_tiny_batch_is_the_jax_dry_runs(tiny_config, tiny_batch):
    """The dry runs' global batch equals conftest's (the JAX dry runs'
    :168-185) frame for frame."""
    got = graft_entry.tiny_batch(tiny_config.train.batch_size)
    for key in ("points", "num_points", "gt_boxes", "gt_mask"):
        np.testing.assert_array_equal(got[key], tiny_batch[key], err_msg=key)


def test_dryrun_multichip_four_ranks(capsys):
    """dryrun_multichip(4) on the CPU: a (data 2, model 2) mesh of 4 gloo
    processes, the four stages, one summary line."""
    out = graft_entry.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): mesh data=2 model=2 bf16")
    assert "[middle[conv3d], run_copy table" in line
    assert line.endswith("fused-data-parallel OK sparse1-model-axis OK")
    assert (out["num_data"], out["num_model"]) == (2, 2)
    assert len(out["ranks"]) == 4
    for rank in out["ranks"]:
        assert rank["scores_finite"] and rank["sparse1"]
        assert rank["loss_f32"] == out["ranks"][0]["loss_f32"]
    for got, want in (out["loss_f32"], out["gnorm_f32"], out["prod_loss"],
                      out["prod_gnorm"]):
        assert abs(got - want) <= graft_entry.RTOL * abs(want)


def test_dryrun_multihost_two_processes(capsys):
    """dryrun_multihost(2) on the CPU: the (dcn 2, data 4, model 1) mesh,
    8 gloo processes of one frame each."""
    out = graft_entry.dryrun_multihost(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multihost(2): loss=")
    assert "agreed across 8 ranks (2 x 4)" in line and line.endswith("OK")
    assert out["world"] == 8 and len(out["ranks"]) == 8
    assert len({r["loss"] for r in out["ranks"]}) == 1
    assert abs(out["loss"][0] - out["loss"][1]) <= (
        graft_entry.MULTIHOST_LOSS_RTOL * abs(out["loss"][1]))


def test_dryrun_multichip_delegates_to_multihost(monkeypatch):
    calls = []
    monkeypatch.setattr(graft_entry, "dryrun_multihost",
                        lambda n, device=None: calls.append((n, device)))
    graft_entry.dryrun_multichip(8, n_processes=3, device="cpu")
    assert calls == [(3, "cpu")]


def test_dryrun_multihost_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split over 12 ranks"):
        graft_entry.dryrun_multihost(3, device="cpu")


def test_no_jax_import():
    """Neither new module imports JAX, the JAX package, the root tools,
    scripts/ or tests/."""
    import ast
    import os

    from voxelnet_tpu_torch import kernels
    from voxelnet_tpu_torch.tools import profile_step

    for module in (graft_entry, profile_step, kernels):
        with open(module.__file__) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "voxelnet_tpu", "scripts",
                               "tests", "__graft_entry__", "bench",
                               "flax", "optax"), (module.__file__, name)
        assert os.path.basename(module.__file__) in (
            "graft_entry.py", "profile_step.py", "__init__.py")
