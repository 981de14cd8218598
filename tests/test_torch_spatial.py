"""Spatial W-sharding of the port (`system.num_model_shards > 1`,
parallel/spatial.py) on the CPU, in gloo worker processes
(tests/torch_dp_worker.py: a launch of 2 ranks, then one of 4, a thread
and 300 s each at most) at the tiny grid (10 x 64 x 64: W slabs of 32 at
M = 2, 16 at M = 4):

  (i) the units: `halo_exchange` and `gather_w` under
      torch.autograd.gradcheck over 2, 3 and 4 ranks, and each conv kind
      of the middle and the RPN on slabs against the whole conv's slice,
      forward and backward, f64, rel 1e-12;
 (ii) the port against itself: 1 x 2 and 2 x 2 meshes (and sparse1 on
      1 x 4), f64 with f64 master weights, conv3d and sparse1: the eval
      step's maps and loss, one train step's loss, grad norm, parameters
      and BN stats against one process on the whole batch, rel 1e-9, as
      tests/test_torch_parallel.py holds data parallelism; a trainer epoch
      on 1 x 2 whose label files are written once;
(iii) the port against JAX: its 2 x 2 f32 forward against the JAX
      package's on a 2 x 2 CPU mesh (`tests/test_sharding.py`,
      `tests/test_sparse_middle.py`), from the same weights;
 (iv) loading: model peers load the same rows, batch shards their own.
"""

import os

import numpy as np
import pytest
import torch
from torch_dp_worker import (CONV_KINDS, HALOS, conv_kind, conv_kind_grads,
                             step_case, trainer_case)
from torch_port_helpers import (TINY, configs, finish_workers,
                                jax_variables, jax_voxel_table, merged,
                                start_workers, step_batch, torch_model,
                                write_mini_kitti)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.models.voxelnet import build_model
from voxelnet_tpu_torch.parallel.spatial import slab

REL = 1e-9
UNIT_REL = 1e-12
F64 = merged(TINY, train={"compute_dtype": "float64"})
MIDDLES = ("conv3d", "sparse1")
# the meshes of (ii): (data shards, model shards); the launch of a mesh
# is its world
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
STEPS = [(mesh, middle) for mesh in ("1x2", "2x2") for middle in MIDDLES
         ] + [("1x4", "sparse1")]
# train.remat on the 1 x 2 mesh: the recompute exchanges the halos again
REMATS = {"conv3d": "seams", "sparse1": "full"}
# the trainer: a 10 x 32 x 32 grid (W slabs of 16), 8 train frames (4
# steps of B=2), 3 val frames, f64
TRAINER = merged(TINY, object={"x_min": 3.2, "x_max": 9.6, "y_min": -3.2,
                               "y_max": 3.2},
                 train={"compute_dtype": "float64", "num_epochs": 1,
                        "num_workers": 2, "upload_points": "f32"},
                 val={"batch_size": 2})


def _overrides(middle: str) -> dict:
    return merged(F64, data={"middle_backend": middle})


def _inputs(tmp: str) -> dict:
    cfg = get_config("Car", **F64)
    jcfg, tcfg = configs()
    variables = jax_variables(jcfg, seed=31)
    rng = np.random.default_rng(31)
    return {
        "state": build_model(cfg, seed=11).state_dict(),
        "batch": step_batch(cfg, seed=11, n=1800),
        "jax_variables": variables,
        "jax_state": torch_model(tcfg, variables).state_dict(),
        "table": jax_voxel_table(jcfg, rng),
        "kitti": write_mini_kitti(os.path.join(tmp, "kitti"), n_points=2000,
                                  splits=(("training", 8),
                                          ("validation", 3))),
    }


def _step(inputs, middle, model=1, remat=None) -> tuple:
    overrides = _overrides(middle)
    if remat is not None:
        overrides = merged(overrides, train={"remat": remat})
    return ("step", {"overrides": overrides, "state_dict": inputs["state"],
                     "batch": inputs["batch"], "double": True,
                     "model": model, "evaluate": remat is None})


def _cases(inputs: dict, tmp: str) -> dict:
    """world -> the cases of its launch."""
    loading = {"data": inputs["kitti"], "overrides": TINY, "batch_size": 4}
    two = {"gradcheck": ("gradcheck", {"ranks": (0, 1), "seed": 2}),
           "kinds": ("conv_kinds", {"ranks": (0, 1), "seed": 2}),
           "loading": ("loading", dict(loading, model=2)),
           "trainer": ("trainer", {
               "overrides": TRAINER, "data": inputs["kitti"],
               "exp_dir": os.path.join(tmp, "exp"), "model": 2,
               "state_dict": build_model(get_config("Car", **TRAINER),
                                         seed=5).state_dict()})}
    four = {"gradcheck3": ("gradcheck", {"ranks": (0, 1, 2), "seed": 3}),
            "kinds3": ("conv_kinds", {"ranks": (0, 1, 2), "seed": 3}),
            "gradcheck4": ("gradcheck", {"ranks": (0, 1, 2, 3), "seed": 4}),
            "kinds4": ("conv_kinds", {"ranks": (0, 1, 2, 3), "seed": 4}),
            "loading": ("loading", dict(loading, model=2)),
            "step-1x4-sparse1": _step(inputs, "sparse1", 4)}
    for middle, remat in REMATS.items():
        two[f"remat-{middle}-{remat}"] = _step(inputs, middle, 2, remat)
    for middle in MIDDLES:
        two[f"step-1x2-{middle}"] = _step(inputs, middle, 2)
        four[f"step-2x2-{middle}"] = _step(inputs, middle, 2)
        four[f"jax-{middle}"] = ("forward", {
            "overrides": merged(TINY, data={"middle_backend": middle}),
            "state_dict": inputs["jax_state"], "table": inputs["table"],
            "model": 2})
    return {2: two, 4: four}


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """(inputs, {world: [each rank's results]}) of one launch of 2 ranks,
    then one of 4, each process on one thread (the test runner's other
    workers share the cores)."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    inputs = _inputs(tmp)
    return inputs, {world: finish_workers(start_workers(
        tmp, cases, world, f"w{world}", threads=1))
        for world, cases in _cases(inputs, tmp).items()}


def _close(got, want, what, rel=REL):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape, what
    torch.testing.assert_close(got.double(), want.double(), rtol=rel,
                               atol=rel * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


# --- (i) the units -----------------------------------------------------------

@pytest.mark.parametrize("world,name", [(2, "gradcheck"), (4, "gradcheck3"),
                                        (4, "gradcheck4")])
def test_halo_exchange_and_gather_w_pass_gradcheck(spatial, world, name):
    """Over 2, 3 and 4 ranks (rank 3 outside the 3-rank group): each
    halo's values equal the zero-padded whole input's slice, and the
    halo exchange (each halo of HALOS) and the gather pass gradcheck."""
    _, outs = spatial
    members = [o[name] for o in outs[world] if o[name]]
    assert len(members) == {"gradcheck": 2, "gradcheck3": 3,
                            "gradcheck4": 4}[name]
    want = {f"halo{a}{b}-{k}" for a, b in HALOS
            for k in ("values", "gradcheck")} | {"gather-gradcheck"}
    for r, got in enumerate(members):
        assert set(got) == want
        assert all(got.values()), (r, got)


@pytest.mark.parametrize("world,name", [(2, "kinds"), (4, "kinds3"),
                                        (4, "kinds4")])
@pytest.mark.parametrize("kind", list(CONV_KINDS))
def test_conv_kind_on_slabs_equals_the_whole_conv(spatial, world, name,
                                                  kind):
    """Each conv kind on M = 2, 3 and 4 slabs, its halo exchanged (BN
    folded away: conv + ReLU), f64: the slabs' outputs and input
    gradients side by side equal the whole conv's, and the weight and
    bias gradients summed over the slabs equal its, rel 1e-12."""
    _, outs = spatial
    seed = {"kinds": 2, "kinds3": 3, "kinds4": 4}[name]
    got = [o[name][kind] for o in outs[world] if o[name]]
    want = conv_kind_grads(*conv_kind(kind, seed))
    for key in ("y", "x_grad"):
        _close(torch.cat([g[key] for g in got], -1), want[key], key,
               UNIT_REL)
    for key in ("weight_grad", "bias_grad"):
        _close(sum(g[key] for g in got), want[key], key, UNIT_REL)


def test_slab_refuses_a_width_that_does_not_divide():
    """Equal slabs where the units divide among the ranks; uneven ones,
    the first ranks a unit more, where they do not; empty ones past the
    last unit; a width that is not a whole number of units refused."""
    assert slab(352, 2, 1) == (176, 176)
    assert slab(64, 4, 3) == (48, 16)
    assert slab(352, 2, 1, 8) == (176, 176)
    assert [slab(352, 3, m, 8) for m in range(3)] == [(0, 120), (120, 120),
                                                      (240, 112)]
    assert [slab(48, 8, m, 8) for m in range(5, 8)] == [(40, 8), (48, 0),
                                                        (48, 0)]
    with pytest.raises(ValueError, match="W=350 must be a multiple of 8 "
                                         "columns"):
        slab(350, 3, 0, 8)


# --- (ii) the port against itself --------------------------------------------

@pytest.fixture(scope="module")
def one_process(spatial):
    """step_case on one process, the whole batch, per middle."""
    inputs, _ = spatial
    return {middle: step_case(**_step(inputs, middle)[1])
            for middle in MIDDLES}


@pytest.mark.parametrize("mesh,middle", STEPS)
def test_sharded_step_equals_one_process(spatial, one_process, mesh, middle):
    """The eval step (cls probabilities and reg of each rank's rows, whole
    W; the loss over the global batch, not M times it) and one train step
    (loss and its parts, pre-clip grad norm, every parameter and BN
    running stat) on the mesh equal one process on the whole batch, f64,
    rel 1e-9; the ranks end bit-identical; the all-reduces of the step
    split by group (model groups only with a model axis)."""
    nd, nm = MESHES[mesh]
    name = f"step-{mesh}-{middle}"
    outs = spatial[1][nd * nm]
    want = one_process[middle]
    b = want["probs"].shape[0]
    for r, o in enumerate(outs):
        got = o[name]
        d = r // nm
        assert got["disagree"] == 0
        lo, hi = d * b // nd, (d + 1) * b // nd
        _close(got["probs"], want["probs"][lo:hi], "probs")
        _close(got["reg"], want["reg"][lo:hi], "reg")
        for k, v in want["eval"].items():
            assert got["eval"][k] == pytest.approx(v, rel=REL), k
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=REL), k
        for k, v in want["state"].items():
            _close(got["state"][k], v, k)
        assert set(got["all_reduces"]) == (
            {"world", "model"} | ({"data"} if nd > 1 else set()))
        assert got["all_reduces"]["model"][0] == want_model_count(middle)


@pytest.mark.parametrize("middle", list(REMATS))
def test_remat_on_a_model_group_equals_one_process(spatial, one_process,
                                                   middle):
    """train.remat ('seams' for conv3d, 'full' for sparse1) on the 1 x 2
    mesh: the backward's recompute runs the halo exchanges again, in the
    same order on both ranks, and the step equals one process without
    remat (the recompute repeats the same f64 ops): loss and its parts,
    grad norm, parameters and BN stats at rel 1e-9; the ranks agree."""
    _, outs = spatial
    want = one_process[middle]
    for o in outs[2]:
        got = o[f"remat-{middle}-{REMATS[middle]}"]
        assert got["disagree"] == 0
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=REL), k
        for k, v in want["state"].items():
            _close(got["state"][k], v, k)
        # the forward's halos and the recompute's, and their adjoints
        assert got["all_reduces"]["model"][0] > want_model_count(middle)


def want_model_count(middle: str) -> int:
    """Model-group all-reduces of one step without remat: a halo exchange
    forward and backward a conv that reads past its slab (3 Conv3d, or 2
    with sparse1's halo-free block 1, 17 RPN convs, 1 deconv) and the
    heads' gather."""
    return 2 * ((2 if middle == "sparse1" else 3) + 17 + 1) + 1


def test_trainer_epoch_on_a_model_group_writes_each_label_once(spatial,
                                                              tmp_path):
    """One Trainer epoch on a 1 x 2 mesh == one process, f64: best val
    loss, step count, the weights; both ranks end bit-identical; rank 0
    (model index 0) writes every val frame's label file and rank 1
    none."""
    inputs, outs = spatial
    kw = dict(_cases(inputs, str(tmp_path))[2]["trainer"][1],
              exp_dir=str(tmp_path / "one"), model=1)
    want = trainer_case(**kw)
    for o in outs[2]:
        got = o["trainer"]
        assert got["disagree"] == 0
        assert got["step"] == want["step"] == 4
        assert got["best_metric"] == pytest.approx(want["best_metric"],
                                                   rel=REL)
        for k, v in want["state"].items():
            _close(got["state"][k], v, k)
    assert [o["trainer"]["dumped"] for o in outs[2]] == [[3], [0]]
    assert want["dumped"] == [3]


# --- (iii) the port against JAX ----------------------------------------------

@pytest.mark.parametrize("middle", MIDDLES)
def test_two_by_two_forward_matches_jax_mesh(spatial, middle):
    """The port's forward on 2 x 2 ranks (eval mode, f32) against the JAX
    package's VoxelNet with `spatial_shard` on a 2 x 2 CPU mesh (XLA's
    halo exchanges; sparse1's `sparse_conv3x3_sharded`), from the same
    weights and voxel table: cls and reg within 1e-4 of the logits'
    spread, tests/test_torch_model.py's tolerance for the unsharded
    forward (f32 through ~20 conv layers in two summation orders)."""
    import dataclasses

    import jax

    from voxelnet_tpu.models.voxelnet import build_model as jax_build
    from voxelnet_tpu.parallel import make_mesh

    inputs, outs = spatial
    jcfg, _ = configs(overrides=merged(TINY,
                                       data={"middle_backend": middle}))
    jcfg = jcfg.replace(system=dataclasses.replace(
        jcfg.system, num_data_shards=2, num_model_shards=2))
    model = jax_build(jcfg)
    assert model.spatial_shard and model.num_model == 2
    with jax.set_mesh(make_mesh(num_data=2, num_model=2)):
        want = jax.jit(lambda v, f, c, n: model.apply(v, f, c, n,
                                                      train=False))(
            inputs["jax_variables"], *inputs["table"])
    b = inputs["table"][0].shape[0]
    for r, o in enumerate(outs[4]):
        d = r // 2
        for got, full in zip((o[f"jax-{middle}"]["cls"],
                              o[f"jax-{middle}"]["reg"]), want):
            w = np.asarray(full)[d * b // 2:(d + 1) * b // 2]
            spread = float(np.asarray(full).std())
            assert spread > 1e-2
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=1e-4 * spread)


# --- (iv) loading ------------------------------------------------------------

def test_model_peers_load_the_same_rows(spatial):
    """One augmented epoch through LazyBatchIterator (global B=4): on the
    1 x 2 mesh both ranks get the whole batches; on 2 x 2 ranks 0-1 (data
    index 0) the same first two rows, ranks 2-3 the same last two, which
    together are the 1 x 2 mesh's batches, row for row and bit for bit
    (augmentations included)."""
    _, outs = spatial
    two = [o["loading"]["batches"] for o in outs[2]]
    four = [o["loading"]["batches"] for o in outs[4]]
    assert len(two[0]) == 2
    for rank_batches, (world, half) in ((two[1], (2, None)),
                                        (four[1], (4, 0)), (four[2], (4, 1)),
                                        (four[3], (4, 1))):
        ref = two[0] if world == 2 else four[2 * half]
        for got, want in zip(rank_batches, ref, strict=True):
            assert got["tags"] == want["tags"]
            np.testing.assert_array_equal(got["points"], want["points"])
    for d in (0, 1):
        for got, whole in zip(four[2 * d], two[0], strict=True):
            assert got["tags"] == whole["tags"][2 * d:2 * d + 2]
            np.testing.assert_array_equal(got["points"],
                                          whole["points"][2 * d:2 * d + 2])

