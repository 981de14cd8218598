"""The port's benchmark (voxelnet_tpu_torch/bench.py) against the JAX
package's root bench.py: its frames bit-equal, its baseline figure, each
stage's result against the JAX computation that bench.py chains (taken
without its `* 0.0`) at f32 on weights carried over by
convert.from_jax_variables; its JSON line for each stage at a small
config on the CPU, every flag of bench.py resolved to the port's path
and named in the label, and its refusals."""

import json

import bench as jax_bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, configs, init_scale_biases,
                                jax_variables, merged, torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu.ops.voxelize import VoxelGridSpec as JaxSpec
from voxelnet_tpu_torch import bench
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec

# the tiny grid (10 x 64 x 64 voxels) moved 12.8 m ahead, so that the
# bench's GT box at x = 20 m lies inside it
STAGE = merged(TINY, object={"x_min": 12.8, "x_max": 25.6})
BATCH = 2


def write_frames(root, n_frames=4 * BATCH, n=2600, seed=3):
    """`n_frames` clouds as KITTI .bin files under `root`: points uniform
    over STAGE's grid box and a margin outside it, off the 5 mm lattice of
    the vendored frames (on which XLA's jitted voxelizer bins boundary
    points one voxel higher, ROADMAP.md) -> the glob of them."""
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        pts = np.concatenate([
            rng.uniform([11.8, -7.4, -3.5], [26.6, 7.4, 1.5], (n, 3)),
            rng.uniform(0, 1, (n, 1))], axis=1).astype(np.float32)
        pts.tofile(str(root / f"{i:06d}.bin"))
    return str(root / "*.bin")


def tiny_get_config(overrides):
    """get_config at `overrides`, with the caller's overrides on top."""
    def get(class_name, **more):
        out = merged(overrides)
        for group, values in more.items():
            out.setdefault(group, {}).update(values)
        return get_config(class_name, **out)

    return get


# ---- (a) frames, (b) baseline ----------------------------------------------

@pytest.mark.parametrize("crop", [True, False], ids=["crop", "nocrop"])
@pytest.mark.parametrize("source", ["files", "vendored", "synthetic"])
def test_load_frames_equal_bench(source, crop, tmp_path, monkeypatch):
    """The same batches, bit for bit, from each of bench.load_frames'
    sources: the glob's files, the vendored frames tiled, and synthetic
    clouds, with the grid crop on and off."""
    import voxelnet_tpu.data.sample as jax_sample
    import voxelnet_tpu_torch.data.sample as port_sample

    pattern = (write_frames(tmp_path) if source == "files"
               else str(tmp_path / "none" / "*.bin"))
    monkeypatch.setattr(jax_bench, "DATA_GLOB", pattern)
    monkeypatch.setattr(bench, "DATA_GLOB", pattern)
    if source == "synthetic":
        monkeypatch.setattr(jax_sample, "sample_frames", lambda: [])
        monkeypatch.setattr(port_sample, "sample_frames", lambda: [])
    jcfg, tcfg = configs(overrides=STAGE)
    max_points = tcfg.data.max_points
    want = jax_bench.load_frames(
        max_points, BATCH, JaxSpec.from_object_config(jcfg.object)
        if crop else None)
    got = bench.load_frames(
        max_points, BATCH, VoxelGridSpec.from_object_config(tcfg.object)
        if crop else None)
    assert len(got) == len(want) == 4
    for (gp, gn), (wp, wn) in zip(got, want):
        assert gp.dtype == wp.dtype and gn.dtype == wn.dtype
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gn, wn)
    # the crop keeps fewer points than the cap takes where it is on
    assert (want[0][1] > 0).all()


def test_baseline_fps_is_bench_py_s():
    assert bench.BASELINE_FPS is not None
    assert bench.BASELINE_FPS == jax_bench.BASELINE_FPS


# ---- (c) each stage against the JAX computation ---------------------------

@pytest.fixture(scope="module")
def stage_case(tmp_path_factory):
    """(JAX config, port config, JAX variables, points, num_points): one
    batch of bench.load_frames at STAGE in f32."""
    jcfg, tcfg = configs(overrides=STAGE)
    pattern = write_frames(tmp_path_factory.mktemp("frames"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "DATA_GLOB", pattern)
        points, num = bench.load_frames(
            tcfg.data.max_points, BATCH,
            VoxelGridSpec.from_object_config(tcfg.object))[0]
    assert num.min() > 1000
    return jcfg, tcfg, jax_variables(jcfg, seed=7), points, num


@pytest.fixture(scope="module")
def jax_table(stage_case):
    """bench.py's `--vfe-backend fused` voxel table + VFE (the Pallas
    kernel in interpret mode): (voxelwise bf16, coords, counts)."""
    from voxelnet_tpu.kernels.vfe_fused import voxelize_vfe_fused

    jcfg, _, variables, points, num = stage_case
    return voxelize_vfe_fused(
        jnp.asarray(points), jnp.asarray(num),
        JaxSpec.from_object_config(jcfg.object), jcfg.data.max_voxels,
        variables["params"]["feature_net"],
        variables["batch_stats"]["feature_net"], interpret=True)


def _jax_layer_stage(stage, middle, jcfg, variables, table):
    """The tail of bench.py's vfe/dense/middle chain at f32: the dense
    grid (data.dense_build 'scatter') and the middle stack on it, or
    sparse1's middle on the voxel table."""
    from voxelnet_tpu.models.middle import MiddleLayers
    from voxelnet_tpu.models.scatter import scatter_to_dense

    vw, coords, counts = table
    if stage == "vfe":
        return vw
    grid = tuple(jcfg.object.grid_size)
    if middle == "sparse1" and stage == "middle":
        dense = table
    else:
        dense = scatter_to_dense(vw, coords, counts, grid,
                                 indices_sorted=jcfg.data.scatter_hints)
    if stage == "dense":
        return dense
    return jax.jit(lambda x: MiddleLayers(
        dtype=jnp.float32, backend=middle, depth_in=grid[0],
        grid_hw=grid[1:]).apply(
        {"params": variables["params"]["middle"],
         "batch_stats": variables["batch_stats"]["middle"]}, x, False))(
        dense)


@pytest.mark.parametrize("stage,middle", [
    ("vfe", "conv3d"), ("dense", "conv3d"), ("middle", "conv3d"),
    ("middle", "sparse1")])
def test_layer_stage_matches_jax(stage_case, jax_table, stage, middle):
    """vfe: the voxelwise features; dense: the grid; middle: the BEV map
    (BN folded and weights cast, as inference runs them, against JAX's
    unfolded f32 middle), within 1e-4 of the result's spread, as
    tests/test_torch_model.py holds the f32 middle."""
    jcfg, tcfg, variables, points, num = stage_case
    tcfg = get_config("Car", **merged(STAGE, data={"middle_backend": middle}))
    run = bench.make_stage_fn(stage, tcfg, device="cpu", batch=BATCH,
                              model=torch_model(tcfg, variables))
    got = run.fn(torch.from_numpy(points), torch.from_numpy(num))
    want = np.asarray(_jax_layer_stage(stage, middle, jcfg, variables,
                                       jax_table), np.float32)
    got = got.to(torch.float32)
    if stage == "middle":
        got = got.permute(0, 2, 3, 1)          # NCHW view -> JAX's NHWC
    got = got.numpy()
    assert got.shape == want.shape
    spread = float(want.std())
    assert spread > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * spread)


def test_infer_stage_matches_jax(stage_case):
    """make_inference_fn through the stage against JAX's inference graph
    (both Pallas kernels in interpret mode): scores within 1e-6 and boxes
    within 1e-4 m, by score order, as tests/test_torch_slice.py holds the
    whole slice."""
    from voxelnet_tpu.models.voxelnet import make_inference_fn as jax_fn

    _, _, variables, points, num = stage_case
    overrides = merged(STAGE, data={"vfe_backend": "fused",
                                    "dense_build": "pallas"},
                       rpn={"score_thres": 0.0})
    jcfg, tcfg = configs(overrides=overrides)
    want = jax.jit(jax_fn(jcfg, platform="cpu"))(variables, points, num)
    run = bench.make_stage_fn("infer", tcfg, device="cpu", batch=BATCH,
                              model=torch_model(tcfg, variables))
    got = run.fn(torch.from_numpy(points), torch.from_numpy(num))
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    assert got.valid.sum() >= 20
    for b in range(BATCH):
        wv, gv = np.asarray(want.valid[b]), got.valid[b].numpy()
        w_scores = np.asarray(want.scores[b])[wv]
        g_scores = got.scores[b].numpy()[gv]
        wo, go = np.argsort(-w_scores), np.argsort(-g_scores)
        np.testing.assert_allclose(g_scores[go], w_scores[wo], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy()[gv][go],
                                   np.asarray(want.boxes[b])[wv][wo],
                                   rtol=0, atol=1e-4)


def test_train_stage_matches_jax(stage_case):
    """One step of the train stage (one GT box a frame, steps_per_epoch
    100) against bench.py's JAX step from the same variables (biases at
    the init's scale, as the step parity tests of tests/test_torch_train.py
    take them) and batch, in f32: loss and its parts within rel 5e-4, the
    pre-clip grad norm within rel 1e-2; and against the stage's own f64
    step within rel 1e-5 and, for the grad norm, the 5e-3 of
    tests/test_torch_train.py's f64 step (units whose inputs sit within
    rounding of a ReLU boundary flip).

    XLA:CPU sums flax's f32 train-mode BN statistics in sequence, and on
    this sparse grid the drift, divided by small batch stds, moves JAX's
    step (its x64 mode keeps those statistics f32): measured here 1.1e-4
    (loss) and 2.4e-3 (grad norm) off the port, whose f32 step is 2e-6 and
    3.9e-4 off its own f64 one; with the helper's +-0.1 biases JAX's gap
    grows to 1.8e-3 and 2.4e-2 while the port's stays at 2e-6 and 1.2e-5
    (ROADMAP.md, known differences). A step that loses the GT box
    or the targets moves the loss by its reg part, several per cent."""
    from voxelnet_tpu.training.optim import make_optimizer
    from voxelnet_tpu.training.train_step import TrainState, make_train_step

    jcfg, tcfg, variables, points, num = stage_case
    variables = init_scale_biases(jax.tree.map(np.copy, variables), 7)
    G = jcfg.data.max_gt_boxes
    gt = np.zeros((BATCH, G, 7), np.float32)
    gt[:, 0] = bench.GT_BOX
    gt_mask = np.zeros((BATCH, G), bool)
    gt_mask[:, 0] = True
    tx = make_optimizer(jcfg, steps_per_epoch=100)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    _, want = make_train_step(jcfg, tx, donate=False)(
        state, {"points": points, "num_points": num, "gt_boxes": gt,
                "gt_mask": gt_mask})
    batch = (torch.from_numpy(points), torch.from_numpy(num))
    got = bench.make_stage_fn("train", tcfg, device="cpu", batch=BATCH,
                              model=torch_model(tcfg, variables)).fn(*batch)
    cfg64 = get_config("Car", **merged(STAGE, train={
        "compute_dtype": "float64"}))
    got64 = bench.make_stage_fn(
        "train", cfg64, device="cpu", batch=BATCH,
        model=torch_model(cfg64, variables).double()).fn(*batch)
    assert float(want["reg_loss"]) > 0          # the GT box is in the grid
    assert float(want["grad_norm"]) > tcfg.train.gradient_clip
    for key in ("loss", "cls_loss", "reg_loss"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=5e-4), key
        assert float(got[key]) == pytest.approx(float(got64[key]),
                                                rel=1e-5), key
    assert float(got["grad_norm"]) == pytest.approx(
        float(want["grad_norm"]), rel=1e-2)
    assert float(got["grad_norm"]) == pytest.approx(
        float(got64["grad_norm"]), rel=5e-3)


def test_targets_stage_matches_jax(stage_case):
    """The stage's maps for its 8 GT boxes a frame against bench.py's
    jitted `_compute_target_maps`: the pos and neg maps exact, the
    regression map within rtol 1e-6, atol 1e-6, as
    tests/test_torch_train.py holds the assignment."""
    from voxelnet_tpu.training.train_step import _compute_target_maps

    jcfg, tcfg, _, points, num = stage_case
    G = jcfg.data.max_gt_boxes
    gt = np.zeros((BATCH, G, 7), np.float32)
    gt[:, :8] = bench.GT_BOX
    gt_mask = np.zeros((BATCH, G), bool)
    gt_mask[:, :8] = True
    want = jax.jit(lambda g, m: _compute_target_maps(jcfg, g, m))(
        gt, gt_mask)
    run = bench.make_stage_fn("targets", tcfg, device="cpu", batch=BATCH)
    got = run.fn(torch.from_numpy(points), torch.from_numpy(num))
    assert float(np.asarray(want[0]).sum()) > 0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-6)


# ---- (d) main's JSON line, (e) every flag, (f) no card ---------------------

KEYS = {"metric", "value", "unit", "vs_baseline", "repeats", "spread",
        "runs", "card"}


@pytest.mark.parametrize("argv", [
    ["--stage", "vfe"], ["--stage", "dense"], ["--stage", "middle"],
    ["--stage", "middle", "--middle-backend", "sparse1"],
    ["--stage", "infer"], ["--stage", "train"],
    ["--stage", "train", "--host-voxelize", "--host-targets"],
    ["--stage", "targets"]], ids=lambda a: "-".join(a[1::2]))
def test_main_prints_one_json_line(argv, tmp_path, monkeypatch, capsys):
    """main at STAGE, B=2, ITERS=2, one repeat: one line of JSON with
    bench.py's keys and `card`, a positive frames/s; `vs_baseline` for
    inference only. sparse1's middle runs with the dense grid's build made
    to raise."""
    monkeypatch.setattr(bench, "get_config", tiny_get_config(STAGE))
    monkeypatch.setattr(bench, "DATA_GLOB", write_frames(tmp_path))
    monkeypatch.setattr(bench, "ITERS", 2)
    if "sparse1" in argv:
        def no_grid(*a, **k):
            raise AssertionError("sparse1 built the dense grid")

        monkeypatch.setattr(bench, "scatter_to_dense_streamed", no_grid)
    result = bench.main(argv + ["--device", "cpu", "--batch", str(BATCH),
                                "--repeats", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == result and set(line) == KEYS
    assert line["value"] > 0 and line["runs"] == [line["value"]]
    assert line["repeats"] == 1 and line["spread"] == 0.0
    assert line["unit"] == "frames/sec/chip" and line["card"] == "cpu"
    assert (line["vs_baseline"] is not None) == (argv[1] == "infer")


def _label(argv):
    args = bench.parse_args(argv)
    config = bench.stage_config(args)
    return bench.stage_label(args.stage, config, args.host_targets,
                             args.host_voxelize)


FLAG_PATHS = (
    [("--middle-backend", v, stage, f"middle[{path}]")
     for v in ("auto", "conv3d", "folded2d", "tap2d", "sparse1", "sparsebwd",
               "wpack", "wpack2")
     for stage in ("middle", "infer", "train")
     for path in ["sparse1" if v == "sparse1" else "conv3d"]]
    + [("--voxelizer-backend", v, "train", "voxelizer[run_copy]")
       for v in ("auto", "xla", "gather", "pallas", "planar")]
    + [("--class-name", v, "infer", f"({v}, inference")
       for v in ("Car", "Pedestrian", "Cyclist")]
    + [("--vfe-backend", v, stage, path)
       for v in ("xla", "fused", "planar")
       for stage, path in (("vfe", "[vfe_fused]"), ("dense", "[vfe_fused,"),
                           ("train", "voxelizer[run_copy]"))]
    + [("--dense-build", v, stage, "vfe_fused, dense_build")
       for v in ("scatter", "pallas") for stage in ("dense", "middle")]
    + [("--remat", v, "train", f"remat[{v}]")
       for v in ("none", "seams", "full")]
    + [("--host-targets", None, "train", "host-precomputed targets"),
       ("--host-voxelize", None, "train", "voxelizer[host]"),
       ("--batch", "24", "infer", "[vfe_fused, dense_build, middle[conv3d]]"),
       ("--repeats", "5", "targets", "on-device target assignment only"),
       ("--device", "cpu", "vfe", "[vfe_fused]")])


@pytest.mark.parametrize("flag,value,stage,path", FLAG_PATHS,
                         ids=lambda x: str(x))
def test_every_flag_resolves_to_the_ports_path(flag, value, stage, path):
    """Each choice of bench.py's flags (and --device) is accepted, goes
    through resolve_plan, and the label names the path the port runs."""
    argv = ["--stage", stage, flag] + ([] if value is None else [value])
    assert path in _label(argv)
    config = bench.stage_config(bench.parse_args(argv))
    if flag == "--middle-backend":
        assert config.data.middle_backend == value
    if flag == "--vfe-backend" and stage == "train":
        assert config.data.train_vfe_backend == (
            "planar" if value == "planar" else "auto")


def test_every_stage_has_its_label():
    for stage in bench.STAGE_NAMES:
        assert _label(["--stage", stage]).startswith(
            "KITTI frames/sec/chip (Car, ")


@pytest.mark.parametrize("argv,error", [
    # the resolver's refusal: the planar table voxelizes on the device
    (["--stage", "train", "--host-voxelize", "--vfe-backend", "planar"],
     ValueError),
    (["--middle-backend", "nope"], SystemExit),
    (["--stage", "nope"], SystemExit),
    (["--batch", "0"], SystemExit),
    (["--device", "tpu"], SystemExit)])
def test_refusals_raise(argv, error):
    with pytest.raises(error):
        bench.stage_config(bench.parse_args(argv))


def test_cuda_without_a_card_raises():
    """--device cuda (the default) needs a card: main and make_stage_fn
    raise before building anything, as make_inference_fn does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--stage", "vfe"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.make_stage_fn("infer", get_config("Car"), device="cuda")
