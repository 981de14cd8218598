"""Uneven spatial W-sharding of the port (`system.num_model_shards = M`
where the RPN's units of rpn.block1_stride x 4 columns do not divide
evenly among M ranks, parallel/spatial.py::slab) on the CPU, in gloo
worker processes (tests/torch_dp_worker.py: a launch of 3 ranks and one of
2, started together, a thread and 300 s each at most) at tiny grids:

  (i) the partition: `slab` on the Car, Pedestrian and tiny grids, empty
      slabs past the last unit, the refusal of a width that is not a
      whole number of units; resolve_plan on the meshes JAX runs and
      JAX's refusals; empty windows launch nothing;
 (ii) the units on uneven slabs and on a member of width 0: halo_exchange
      and gather_w under gradcheck, each conv kind of the middle and the
      RPN against the whole conv's slice, f64;
(iii) the port against itself, f64 with f64 master weights: the eval
      step's maps and loss, and one train step's loss, grad norm, every
      parameter's update and BN stat, on 1 x 3 at W=64 (slabs 24/24/16,
      conv3d), 1 x 2 at W=40 (24/16, sparse1) and 1 x 3 at W=16 (8/8/0:
      the last rank empty, conv3d) against one process, rel 1e-9;
 (iv) the port against JAX: its f32 forward on 1 x 3 (W=64, conv3d) and
      1 x 2 (W=40, sparse1) against the JAX package's own mesh of the
      same shape (XLA pads the uneven dimension), from the same weights.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_dp_worker import CONV_KINDS, conv_kind, conv_kind_grads, step_case
from torch_port_helpers import (TINY, configs, fake_group, finish_workers,
                                jax_variables, jax_voxel_table, merged,
                                start_workers, step_batch, torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch.config import get_config, resolve_plan
from voxelnet_tpu_torch.kernels import sparse_conv as sparse_kernels
from voxelnet_tpu_torch.models import scatter, voxelnet
from voxelnet_tpu_torch.models import sparse_conv as sparse_model
from voxelnet_tpu_torch.models.voxelnet import build_model
from voxelnet_tpu_torch.parallel.spatial import slab

REL = 1e-9
UNIT_REL = 1e-12
# (grid W, model shards, middle) of (iii); W = x_max / 0.2 at x_min 0
MESHES = {"w64-1x3-conv3d": (64, 3, "conv3d"),
          "w40-1x2-sparse1": (40, 2, "sparse1"),
          "w16-1x3-conv3d": (16, 3, "conv3d")}
JAX_MESHES = ("w64-1x3-conv3d", "w40-1x2-sparse1")
# the members' widths of (ii): uneven (every slab of the RPN's k3 s2
# conv starts on an even column and spans an even number), and one
# member of width 0 past the right edge
GRADCHECK_WIDTHS = {"uneven": (4, 3, 2), "empty": (3, 2, 0)}
KIND_WIDTHS = {"3-uneven": (10, 8, 6), "3-empty": (12, 12, 0),
               "2-uneven": (14, 10)}


def _overrides(name: str, dtype: str = "float64") -> dict:
    width, _, middle = MESHES[name]
    return merged(TINY, object={"x_max": width * 0.2},
                  data={"middle_backend": middle},
                  train={"compute_dtype": dtype})


def _step(inputs, name: str, model: int = 1):
    """step_case's arguments for mesh `name` on `model` ranks."""
    cfg = get_config("Car", **_overrides(name))
    return {"overrides": _overrides(name), "state_dict": inputs["state"],
            "batch": step_batch(cfg, seed=11, n=1800), "double": True,
            "model": model, "evaluate": True}


def _cases(inputs: dict) -> dict:
    """world -> the cases of its launch."""
    three = {f"gradcheck-{k}": ("gradcheck", {"ranks": (0, 1, 2), "seed": 5,
                                              "widths": w})
             for k, w in GRADCHECK_WIDTHS.items()}
    two = {}
    for k, widths in KIND_WIDTHS.items():
        launch = three if len(widths) == 3 else two
        launch[f"kinds-{k}"] = ("conv_kinds", {
            "ranks": tuple(range(len(widths))), "seed": 6,
            "widths": widths})
    for name, (_, model, _) in MESHES.items():
        launch = three if model == 3 else two
        launch[f"step-{name}"] = ("step", _step(inputs, name, model))
    for name in JAX_MESHES:
        model = MESHES[name][1]
        launch = three if model == 3 else two
        launch[f"jax-{name}"] = ("forward", {
            "overrides": _overrides(name, "float32"),
            "state_dict": inputs["jax_state"], "table": inputs[name],
            "model": model})
    return {3: three, 2: two}


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    """(inputs, {world: [each rank's results]}) of a launch of 3 ranks
    and one of 2, started together, each process on one thread."""
    tmp = str(tmp_path_factory.mktemp("uneven"))
    jcfg, tcfg = configs()
    variables = jax_variables(jcfg, seed=33)
    inputs = {"state": build_model(get_config("Car", **TINY),
                                   seed=13).state_dict(),
              "jax_variables": variables,
              "jax_state": torch_model(tcfg, variables).state_dict()}
    rng = np.random.default_rng(33)
    for name in JAX_MESHES:
        inputs[name] = jax_voxel_table(
            configs(overrides=_overrides(name, "float32"))[0], rng, 2)
    started = {world: start_workers(tmp, cases, world, f"u{world}",
                                    threads=1)
               for world, cases in _cases(inputs).items()}
    return inputs, {world: finish_workers(s) for world, s in started.items()}


def _close(got, want, what, rel=REL):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape, what
    torch.testing.assert_close(got.double(), want.double(), rtol=rel,
                               atol=rel * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


# --- (i) the partition -------------------------------------------------------

@pytest.mark.parametrize("width,num,align,want", [
    # Car (352 = 44 units of 8) and Pedestrian/Cyclist (240 = 30)
    (352, 3, 8, (120, 120, 112)),
    (352, 8, 8, (48,) * 4 + (40,) * 4),
    (352, 2, 8, (176, 176)),
    (352, 4, 8, (88,) * 4),
    (240, 4, 8, (64, 64, 56, 56)),
    (240, 8, 8, (32,) * 6 + (24,) * 2),
    (240, 7, 8, (40, 40) + (32,) * 5),
    # the tiny grids of (iii), and fewer units than ranks
    (64, 3, 8, (24, 24, 16)),
    (40, 2, 8, (24, 16)),
    (16, 3, 8, (8, 8, 0)),
    (48, 8, 8, (8,) * 6 + (0, 0)),
    # block1_stride 1: units of 4
    (40, 3, 4, (16, 12, 12)),
])
def test_slab_cuts_whole_units_first_ranks_wider(width, num, align, want):
    """The ranks' widths; the slabs tile the width in order, each starts
    on a multiple of `align` and spans whole units, and no two differ by
    more than a unit; where the units divide, the equal slabs W / M."""
    got = [slab(width, num, m, align) for m in range(num)]
    assert tuple(w for _, w in got) == want
    x0 = 0
    for start, w in got:
        assert start == x0 and start % align == 0 and w % align == 0
        x0 += w
    assert x0 == width
    assert max(want) - min(want) <= align
    if (width // align) % num == 0:
        assert want == (width // num,) * num


def test_slab_refuses_a_width_of_part_units():
    with pytest.raises(ValueError, match="W=60 must be a multiple of 8 "
                                         "columns"):
        slab(60, 2, 0, 8)


@pytest.mark.parametrize("cls,num,middle", [
    ("Car", 3, "conv3d"), ("Car", 8, "conv3d"), ("Pedestrian", 4, "conv3d"),
    ("Pedestrian", 8, "conv3d"), ("Cyclist", 7, "conv3d"),
    ("Car", 8, "sparse1"), ("Pedestrian", 4, "sparse1"),
])
def test_resolve_plan_accepts_what_jax_runs(monkeypatch, cls, num, middle):
    """The meshes the JAX package runs at the presets' full width: conv3d
    at any M (XLA pads), sparse1 where M divides W."""
    fake_group(monkeypatch, num)
    plan = resolve_plan(get_config(cls, data={"middle_backend": middle},
                                   system={"num_model_shards": num}),
                        train=True)
    assert plan.world_size == num and plan.middle == middle


@pytest.mark.parametrize("cls,num,data,match", [
    ("Car", 3, {"middle_backend": "sparse1"},
     "W=352 must divide by num_model_shards=3 for the sparse1"),
    ("Pedestrian", 7, {"middle_backend": "sparse1"},
     "W=240 must divide by num_model_shards=7 for the sparse1"),
    ("Car", 3, {"middle_backend": "sparsebwd"}, "'sparsebwd' does not "
     "partition over the spatial 'model' axis"),
    ("Car", 3, {"vfe_backend": "fused"}, "'fused' does not partition over "
     "the spatial 'model' axis"),
    ("Car", 3, {"dense_build": "pallas"}, "'pallas' does not partition "
     "over a mesh"),
])
def test_resolve_plan_keeps_jax_refusals(monkeypatch, cls, num, data,
                                         match):
    """JAX's own refusals under an uneven model axis, with its messages
    (`voxelnet_tpu/models/sparse_conv.py:255-258`,
    `voxelnet_tpu/models/voxelnet.py:226-230, 393-397, 434-445`)."""
    fake_group(monkeypatch, num)
    with pytest.raises(ValueError, match=match):
        resolve_plan(get_config(cls, data=data,
                                system={"num_model_shards": num}))


def test_empty_windows_launch_nothing(monkeypatch):
    """An empty W window builds no dense grid, no occupancy map and no
    sparse conv (each raises here if called): it returns a tensor of no
    columns of the right shape, whose backward gives zero gradients to
    the voxel table and block 1's weight and bias."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel path ran on an empty window")

    monkeypatch.setattr(scatter, "dense_build_autograd", refuse)
    monkeypatch.setattr(sparse_model, "sparse_conv_autograd", refuse)
    monkeypatch.setattr(voxelnet, "occupancy_map", refuse)
    gen = torch.Generator().manual_seed(3)
    feat = torch.randn((2, 5, 8), generator=gen, dtype=torch.float64,
                       requires_grad=True)
    coords = torch.zeros((2, 5, 3), dtype=torch.int32)
    counts = torch.ones((2, 5), dtype=torch.int32)
    dense = scatter.scatter_to_dense_streamed(feat, coords, counts,
                                              (4, 6, 16), (16, 0))
    assert dense.shape == (2, 4, 6, 0, 8)
    occ = voxelnet.window_occupancy(coords, counts, (4, 6, 16), (16, 0))
    assert occ.shape == (2, 4, 6, 0)
    weight = torch.randn((16, 8, 3, 3, 3), generator=gen,
                         dtype=torch.float64, requires_grad=True)
    bias = torch.randn((16,), generator=gen, dtype=torch.float64,
                       requires_grad=True)
    y = sparse_model.sparse_conv3x3(feat, coords, counts, occ, weight, bias,
                                    2, 1, (16, 0))
    assert y.shape == (2, sparse_kernels.depth_out(4, 2, 1), 6, 0, 16)
    grads = torch.autograd.grad((dense.sum() + y.sum()),
                                (feat, weight, bias))
    for g, t in zip(grads, (feat, weight, bias)):
        assert g.shape == t.shape and not g.any()


# --- (ii) the units ----------------------------------------------------------

@pytest.mark.parametrize("name", list(GRADCHECK_WIDTHS))
def test_halo_exchange_and_gather_w_pass_gradcheck_on_uneven_slabs(uneven,
                                                                   name):
    """Over 3 ranks of widths (4, 3, 2), and (3, 2, 0) with the last
    member empty: each halo's values equal the zero-padded whole input's
    slice, and the halo exchange (each halo of HALOS) and the gather pass
    gradcheck, f64."""
    _, outs = uneven
    for r, o in enumerate(outs[3]):
        got = o[f"gradcheck-{name}"]
        assert len(got) == 9 and all(got.values()), (r, got)


@pytest.mark.parametrize("name", list(KIND_WIDTHS))
@pytest.mark.parametrize("kind", list(CONV_KINDS))
def test_conv_kind_on_uneven_slabs_equals_the_whole_conv(uneven, name,
                                                         kind):
    """Each conv kind on slabs of 10/8/6, 12/12/0 (an empty member: no
    conv runs there) and 14/10 columns of 24, its halo exchanged (BN
    folded away: conv + ReLU), f64: the slabs' outputs and input
    gradients side by side equal the whole conv's, and the weight and
    bias gradients summed over the slabs equal its, rel 1e-12."""
    _, outs = uneven
    widths = KIND_WIDTHS[name]
    got = [o[f"kinds-{name}"][kind] for o in outs[len(widths)]]
    assert [g["x_grad"].shape[-1] for g in got] == list(widths)
    want = conv_kind_grads(*conv_kind(kind, 6))
    for key in ("y", "x_grad"):
        _close(torch.cat([g[key] for g in got], -1), want[key], key,
               UNIT_REL)
    for key in ("weight_grad", "bias_grad"):
        _close(sum(g[key] for g in got), want[key], key, UNIT_REL)


# --- (iii) the port against itself -------------------------------------------

@pytest.mark.parametrize("name", list(MESHES))
def test_uneven_step_equals_one_process(uneven, name):
    """The eval step (cls probabilities and reg, whole W; its loss) and
    one train step (loss and its parts, pre-clip grad norm, each
    parameter's update, i.e. each gradient leaf once clipped, and every
    parameter and BN running stat after it) on the uneven mesh equal one
    process, f64, rel 1e-9; the ranks end bit-identical; a step's
    model-group all-reduces are those of the even mesh."""
    inputs, outs = uneven
    _, model, middle = MESHES[name]
    want = step_case(**_step(inputs, name))
    for o in outs[model]:
        got = o[f"step-{name}"]
        assert got["disagree"] == 0
        _close(got["probs"], want["probs"], "probs")
        _close(got["reg"], want["reg"], "reg")
        for k, v in want["eval"].items():
            assert got["eval"][k] == pytest.approx(v, rel=REL), k
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=REL), k
        # a conv bias under a train-mode BN has a zero gradient by
        # construction: its update is f64 rounding noise, held to the
        # largest update's 1e-12
        floor = 1e-12 * max(float(v.abs().max())
                            for v in want["update"].values())
        for k, v in want["update"].items():
            torch.testing.assert_close(
                got["update"][k], v, rtol=REL,
                atol=max(REL * float(v.abs().max()), floor),
                msg=lambda m, k=k: f"update of {k}: {m}")
        for k, v in want["state"].items():
            _close(got["state"][k], v, k)
        # a halo exchange forward and backward a conv that reads past its
        # slab (3 Conv3d, 2 with sparse1's block 1, 17 RPN convs, 1
        # deconv) and the heads' gather, whatever the slabs' widths
        halo_convs = (2 if middle == "sparse1" else 3) + 17 + 1
        assert got["all_reduces"]["model"][0] == 2 * halo_convs + 1


# --- (iv) the port against JAX -----------------------------------------------

@pytest.mark.parametrize("name", JAX_MESHES)
def test_uneven_forward_matches_jax_mesh(uneven, name):
    """The port's forward on the uneven mesh (eval mode, f32) against the
    JAX package's VoxelNet with `spatial_shard` on a 1 x M CPU mesh of
    the same shape (XLA pads the uneven W dimension; sparse1's
    `sparse_conv3x3_sharded` windows of W / M), from the same weights and
    voxel table: cls and reg within 1e-4 of the logits' spread, the
    tolerance of tests/test_torch_spatial.py's 2 x 2 case."""
    import jax

    from voxelnet_tpu.models.voxelnet import build_model as jax_build
    from voxelnet_tpu.parallel import make_mesh

    inputs, outs = uneven
    _, model_shards, _ = MESHES[name]
    jcfg, _ = configs(overrides=_overrides(name, "float32"))
    jcfg = jcfg.replace(system=dataclasses.replace(
        jcfg.system, num_model_shards=model_shards))
    model = jax_build(jcfg)
    assert model.spatial_shard and model.num_model == model_shards
    with jax.set_mesh(make_mesh(num_data=1, num_model=model_shards)):
        want = jax.jit(lambda v, f, c, n: model.apply(v, f, c, n,
                                                      train=False))(
            inputs["jax_variables"], *inputs[name])
    for o in outs[model_shards]:
        for got, full in zip((o[f"jax-{name}"]["cls"],
                              o[f"jax-{name}"]["reg"]), want):
            full = np.asarray(full)
            spread = float(full.std())
            assert spread > 1e-2
            np.testing.assert_allclose(got.numpy(), full, rtol=0,
                                       atol=1e-4 * spread)
