"""The port's train slice against the JAX package on the CPU: the config
copy, the train-knob resolver, train-mode VFE with flax BatchNorm, target
assignment, the RPN loss, clipping and the LR schedule, one whole train
step in float64 and the eval step in float32. Inputs are made with numpy
from a seed at the tiny grid; both packages get the same weights through
convert.from_jax_variables."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import (TINY, configs, init_scale_biases,
                                jax_variables, merged, step_batch,
                                torch_model)

from voxelnet_tpu.ops import losses as jax_losses
from voxelnet_tpu.ops import targets as jax_targets
from voxelnet_tpu.ops.anchors import anchors_flat as jax_anchors_flat
from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.config import (TRAIN_VFE_BACKENDS,
                                       VOXELIZER_BACKENDS, get_config,
                                       resolve_plan)
from voxelnet_tpu_torch.ops import losses, targets
from voxelnet_tpu_torch.ops.anchors import anchors_flat
from voxelnet_tpu_torch.training import optim
from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                    make_eval_step,
                                                    make_train_step)

STEPS_PER_EPOCH = 10


def _assert_no_ties(cfg, batch):
    """Each valid GT's best anchor IoU leads the next by > 1e-5: at an
    exact tie the forced positive depends on the last bit of the IoU,
    which even the JAX package's jitted and eager runs break differently."""
    obj = cfg.object
    su = torch.from_numpy(targets.anchor_standup_np(obj))
    from voxelnet_tpu_torch.ops import iou

    overlaps = iou.standup_iou(su[None], targets.gt_standup(
        torch.from_numpy(batch["gt_boxes"])))                 # (B, A, G)
    top2 = overlaps.topk(2, dim=1).values                     # (B, 2, G)
    gap = (top2[:, 0] - top2[:, 1])[torch.from_numpy(batch["gt_mask"])]
    assert float(gap.min()) > 1e-5, gap


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# --- config copy and resolver ---------------------------------------------

@pytest.mark.parametrize("class_name", ["Car", "Pedestrian", "Cyclist"])
@pytest.mark.parametrize("overrides", [{}, TINY, merged(
    TINY, train={"remat": "seams", "yaw_encoding": "sin"},
    compat={"buggy_smooth_l1": True})], ids=["preset", "tiny", "knobs"])
def test_config_copy_equals_original(class_name, overrides):
    jcfg, tcfg = configs(class_name, overrides)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.object.grid_size == jcfg.object.grid_size
    assert tcfg.object.num_anchors == jcfg.object.num_anchors


def test_resolver_maps_train_knobs_to_one_path():
    """Every value the JAX package accepts for the train-table knobs
    resolves to the port's one run-copy path (the default plan)."""
    want = resolve_plan(get_config("Car"), train=True)
    for value in TRAIN_VFE_BACKENDS:
        cfg = get_config("Car", data={"train_vfe_backend": value})
        assert resolve_plan(cfg, train=True) == want
    for value in VOXELIZER_BACKENDS:
        cfg = get_config("Car", data={"voxelizer_backend": value})
        assert resolve_plan(cfg, train=True) == want
    f64 = get_config("Car", train={"compute_dtype": "float64"})
    assert resolve_plan(f64, train=True).dtype == "float64"


@pytest.mark.parametrize("overrides,match", [
    ({"train": {"remat": "seam"}}, "remat"),
    ({"train": {"remat": "all"}}, "remat"),
    ({"data": {"train_vfe_backend": "nope"}}, "train_vfe_backend"),
    ({"data": {"voxelizer_backend": "nope"}}, "voxelizer_backend"),
])
def test_resolver_refuses_train_knobs(overrides, match):
    cfg = get_config("Car", **overrides)
    with pytest.raises(ValueError, match=match):
        resolve_plan(cfg, train=True)
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, device="cpu")


def test_remat_is_refused_only_for_training():
    """An unknown train.remat is the train step's error; the inference
    resolver does not read it, and the JAX package's values all train."""
    cfg = get_config("Car", train={"remat": "nope"})
    assert resolve_plan(cfg) == resolve_plan(get_config("Car"))
    for value in ("none", "seams", "full"):
        cfg = get_config("Car", train={"remat": value})
        assert resolve_plan(cfg, train=True) == resolve_plan(cfg)


# remat cases train on a 10 x 32 x 32 grid (a quarter of TINY's cells)
# with two torch threads: the test runner's workers share the cores
REMAT = merged(TINY, object={"x_min": 3.2, "x_max": 9.6, "y_min": -3.2,
                             "y_max": 3.2})


def _remat_step(remat):
    from voxelnet_tpu_torch.models.init import randomize_bn_
    from voxelnet_tpu_torch.models.voxelnet import build_model

    cfg = get_config("Car", **merged(REMAT, train={"remat": remat}))
    model = randomize_bn_(build_model(cfg, seed=17),
                          torch.Generator().manual_seed(18))
    before = model.state_dict()["middle.ConvBlock3D_0.BatchNorm_0."
                                "running_mean"].clone()
    state = create_train_state(cfg, model, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, metrics = make_train_step(cfg, device="cpu")(
            state, step_batch(cfg, seed=17, n=1200))
    finally:
        torch.set_num_threads(threads)
    return ({k: float(v) for k, v in metrics.items()},
            state.model.state_dict(), before)


@pytest.fixture(scope="module")
def no_remat_step():
    """(metrics, state_dict, running mean before) of one step at remat
    'none'."""
    return _remat_step("none")


@pytest.mark.parametrize("remat", ["seams", "full"])
def test_remat_matches_no_remat(no_remat_step, remat):
    """train.remat recomputes the dense grid + middle and the RPN (seams)
    or the whole forward (full) in backward: the same metrics, updated
    weights and BN running stats, bit for bit, as 'none' (the recompute
    must not move the running stats a second time)."""
    want, want_sd, before = no_remat_step
    got, got_sd, _ = _remat_step(remat)
    assert got == want
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    # the step moved the running stats
    key = "middle.ConvBlock3D_0.BatchNorm_0.running_mean"
    assert not torch.equal(want_sd[key], before)


def test_cuda_step_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(get_config("Car", **TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(get_config("Car", **TINY))


# --- modules ----------------------------------------------------------------

def test_train_mode_vfe_matches_flax():
    """Outputs and updated batch_stats of flax
    FeatureLearningNet.apply(train=True, mutable=['batch_stats']) at f32:
    masked batch statistics, flax's E[x^2] - E[x]^2 variance, its biased
    running-variance update. Tolerances: f32 sums in another order."""
    from voxelnet_tpu.models.vfe import FeatureLearningNet
    from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec,
                                                 voxelize_table)

    jcfg, tcfg = configs()
    variables = jax_variables(jcfg, seed=7)
    batch = step_batch(tcfg, seed=7)
    vox = voxelize_table(torch.from_numpy(batch["points"]),
                         torch.from_numpy(batch["num_points"]),
                         VoxelGridSpec.from_object_config(tcfg.object),
                         tcfg.data.max_voxels)
    feats, counts = vox.features.numpy(), vox.counts.numpy()
    want, upd = FeatureLearningNet(dtype=jnp.float32).apply(
        {"params": variables["params"]["feature_net"],
         "batch_stats": variables["batch_stats"]["feature_net"]},
        feats, counts, True, mutable=["batch_stats"])

    model = torch_model(tcfg, variables).train()
    got = model.feature_net.table(vox.features, vox.counts, torch.float32)
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    got_stats = convert.to_jax_variables(model.state_dict())["batch_stats"]
    want_stats = _leaves(upd["batch_stats"])
    for path, leaf in _leaves(got_stats["feature_net"]).items():
        np.testing.assert_allclose(leaf, want_stats[path], rtol=1e-5,
                                   atol=1e-6, err_msg=path)
    old = _leaves(variables["batch_stats"]["feature_net"])
    assert all(np.abs(want_stats[p] - old[p]).max() > 1e-4 for p in old)


@pytest.mark.parametrize("buggy", [False, True], ids=["standup", "buggy"])
@pytest.mark.parametrize("yaw_mode", ["delta", "sin"])
def test_targets_match_jax(yaw_mode, buggy):
    """Device and host assignment and the map layout, against JAX's
    (vmapped) assign_targets, assign_targets_np and targets_to_maps."""
    overrides = merged(TINY, compat={"buggy_anchor_standup": buggy},
                       train={"yaw_encoding": yaw_mode})
    jcfg, tcfg = configs(overrides=overrides)
    obj = tcfg.object
    rng = np.random.default_rng(5)
    G = 8
    gt = np.zeros((2, G, 7), np.float32)
    gt[..., 0] = rng.uniform(1, 12, (2, G))
    gt[..., 1] = rng.uniform(-5, 5, (2, G))
    gt[..., 2] = -1.0
    gt[..., 3:6] = [1.56, 1.6, 3.9]
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (2, G))
    gt_mask = np.zeros((2, G), bool)
    gt_mask[0, :5] = True
    gt_mask[1, :2] = True

    anchors = jax_anchors_flat(jcfg.object)
    np.testing.assert_array_equal(anchors_flat(obj), anchors)
    standup = jax_targets.anchor_standup_np(jcfg.object, buggy=buggy)
    np.testing.assert_array_equal(
        targets.anchor_standup_np(obj, buggy=buggy), standup)
    kw = dict(pos_iou=obj.rpn_pos_iou, neg_iou=obj.rpn_neg_iou,
              anchor_h=obj.anchor_h, yaw_mode=yaw_mode)

    def one(b, m):
        return jax_targets.targets_to_maps(
            jax_targets.assign_targets(b, m, jnp.asarray(anchors),
                                       jnp.asarray(standup), **kw),
            (obj.feature_height, obj.feature_width))

    want = jax.vmap(one)(jnp.asarray(gt), jnp.asarray(gt_mask))
    got = targets.targets_to_maps(
        targets.assign_targets(torch.from_numpy(gt),
                               torch.from_numpy(gt_mask),
                               torch.from_numpy(anchors),
                               torch.from_numpy(standup), **kw),
        (obj.feature_height, obj.feature_width))
    host = targets.TargetPrecomputer(tcfg)({"gt_boxes": gt,
                                            "gt_mask": gt_mask})
    want_host = jax_targets.TargetPrecomputer(jcfg)({"gt_boxes": gt,
                                                     "gt_mask": gt_mask})
    for i, key in enumerate(("target_pos", "target_neg", "target_reg")):
        w = np.asarray(want[i])
        assert got[i].shape == w.shape
        if key == "target_reg":
            # encode's f32 divides and logs, in another library
            np.testing.assert_allclose(got[i].numpy(), w, rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got[i].numpy(), w)
        np.testing.assert_array_equal(host[key], want_host[key])
    # the reference's zero-area standup boxes overlap nothing
    assert np.asarray(want[0]).sum() >= (0 if buggy else 7)
    assert np.asarray(want[1]).sum() > 0


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("buggy", [False, True])
def test_rpn_loss_matches_jax(from_logits, buggy):
    rng = np.random.default_rng(int(from_logits) + 2 * int(buggy))
    shape = (2, 8, 8, 2)
    cls = rng.normal(0, 2, shape).astype(np.float32)
    if not from_logits:
        cls = 1 / (1 + np.exp(-cls))
    reg = rng.normal(0, 0.3, (2, 8, 8, 14)).astype(np.float32)
    pos = (rng.random(shape) < 0.1).astype(np.float32)
    neg = ((rng.random(shape) < 0.7) & (pos == 0)).astype(np.float32)
    reg_t = (rng.normal(0, 0.3, (2, 8, 8, 14))
             * np.repeat(pos, 7, -1)).astype(np.float32)
    kw = dict(alpha=1.5, beta=1.0, sigma=3.0, from_logits=from_logits,
              buggy_smooth_l1=buggy)
    want = jax_losses.rpn_loss(*(jnp.asarray(x) for x in
                                 (cls, reg, pos, neg, reg_t)), **kw)
    got = losses.rpn_loss(*(torch.from_numpy(x) for x in
                            (cls, reg, pos, neg, reg_t)), **kw)
    for name in losses.RPNLoss._fields:
        # f32 sums over 256 / 1792 terms in another order
        assert float(getattr(got, name)) == pytest.approx(
            float(getattr(want, name)), rel=2e-6), name


def test_clip_and_schedule_match_optax():
    """optax's clip_by_global_norm (pass below the limit, (g / n) * limit
    above it) and piecewise schedule (drop at count >= boundary), on
    gradients whose norm is below and above the limit, across the
    boundary."""
    from voxelnet_tpu.training.optim import make_lr_schedule, make_optimizer

    cfg = get_config("Car", **TINY)
    jcfg, _ = configs()
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    boundary = cfg.train.lr_scheduler_step * STEPS_PER_EPOCH
    jsched = make_lr_schedule(jcfg, STEPS_PER_EPOCH)
    sched = optim.make_lr_schedule(cfg, STEPS_PER_EPOCH)
    for count in (0, boundary - 1, boundary, boundary + 1, 5 * boundary):
        assert sched(count) == float(jsched(count)), count
    assert sched(boundary - 1) == pytest.approx(0.01)
    assert sched(boundary) == pytest.approx(0.001)

    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    sgd = optim.ClippedSGD(cfg, STEPS_PER_EPOCH)
    for scale, count in ((1e-2, 0), (1e3, 0), (1e3, boundary)):
        grads = [rng.normal(0, scale, s).astype(np.float32) for s in shapes]
        params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
        # the chain's only array leaf is the schedule's update count
        jstate = jax.tree.map(lambda x: jnp.asarray(count, x.dtype),
                              tx.init(params))
        updates, _ = tx.update(grads, jstate, params)
        want = optax.apply_updates(params, updates)
        tparams = [torch.from_numpy(p.copy()) for p in params]
        norm, state = sgd.apply_(tparams, [torch.from_numpy(g)
                                           for g in grads],
                                 optim.OptState(count=count))
        assert state.count == count + 1
        assert float(norm) == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-6)
        assert (float(norm) > cfg.train.gradient_clip) == (scale > 1)
        for t, w in zip(tparams, want):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


# --- whole steps ------------------------------------------------------------

# the tiny grid with 2048 voxel slots (5% of its cells, the occupancy a
# Car frame's ~14k voxels give after the first conv spreads them): on a
# grid that is nearly all padding the reference's f32 batch statistics,
# summed in sequence by XLA, drift off the exact ones (4e-6 on a mean of
# 0.1 at 256 slots, against 1e-8 for torch's pairwise sums), and train-mode
# BN divides that drift by batch stds near 0.01
F64 = merged(TINY, train={"compute_dtype": "float64"},
             data={"max_voxels": 2048, "max_points": 8192})


def run_jax_f64_step(overrides):
    """One JAX make_train_step at float64 (x64 on for its trace and run)
    from random variables for the config of `overrides`: (variables,
    batch, new params, new batch_stats, metrics), all numpy."""
    from voxelnet_tpu.training.optim import make_optimizer
    from voxelnet_tpu.training.train_step import TrainState
    from voxelnet_tpu.training.train_step import \
        make_train_step as jax_make_train_step

    jcfg, _ = configs(overrides=overrides)
    variables = init_scale_biases(jax_variables(jcfg, seed=21), 21)
    batch = step_batch(jcfg, seed=21, n=8000)
    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    jax.config.update("jax_enable_x64", True)
    try:
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        step = jax_make_train_step(jcfg, tx, donate=False)
        new, metrics = step(state, batch)
        out = (jax.tree.map(np.asarray, new.params),
               jax.tree.map(np.asarray, new.batch_stats),
               {k: float(v) for k, v in metrics.items()})
    finally:
        jax.config.update("jax_enable_x64", False)
    return (variables, batch) + out


@pytest.fixture(scope="module")
def jax_f64_step():
    return run_jax_f64_step(F64)


def check_f64_step(jax_step, overrides):
    """The port's step at float64 from JAX's variables and batch against
    JAX's step (run_jax_f64_step), with the tolerances of
    test_one_train_step_matches_jax_in_float64."""
    variables, batch, want_params, want_stats, want = jax_step
    _, tcfg = configs(overrides=overrides)
    _assert_no_ties(tcfg, batch)
    state = create_train_state(tcfg, torch_model(tcfg, variables),
                               device="cpu")
    step = make_train_step(tcfg, device="cpu",
                           steps_per_epoch=STEPS_PER_EPOCH)
    state, metrics = step(state, batch)

    assert set(metrics) == set(want)
    assert state.step == 1 and state.opt_state.count == 1
    assert float(metrics["loss"]) == pytest.approx(want["loss"], rel=5e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                        rel=5e-3)
    for name in ("cls_loss", "reg_loss", "cls_pos_loss", "cls_neg_loss"):
        assert float(metrics[name]) == pytest.approx(want[name], rel=5e-5)
    assert int(metrics["voxels_clipped"]) == want["voxels_clipped"] == 2
    # the clip was active: the step moved every tensor
    assert want["grad_norm"] > tcfg.train.gradient_clip

    got = convert.to_jax_variables(state.model.state_dict())
    before = _leaves(variables["params"])
    got_p, want_p = _leaves(got["params"]), _leaves(want_params)
    assert got_p.keys() == want_p.keys()
    for path, leaf in want_p.items():
        np.testing.assert_allclose(got_p[path], leaf, rtol=0, atol=2e-4,
                                   err_msg=path)
    # the clipped step is small (lr * 5 / |g|), and f32 params drop the
    # moves under half an ulp: most tensors, not all, change
    moved = sum(np.abs(got_p[p] - before[p]).max() > 0 for p in want_p)
    assert moved > 0.7 * len(want_p)
    # each leaf's move against JAX's: the weights' atol above is larger
    # than most moves, so only this check sees a wrong direction. The
    # floor covers the conv biases ahead of a BN, whose gradient is 0 up
    # to rounding; a move reversed in any other leaf (norms >= 7e-6 here)
    # is over the bound
    for path, leaf in want_p.items():
        dg = got_p[path].astype(np.float64) - before[path]
        dw = leaf.astype(np.float64) - before[path]
        assert (np.linalg.norm(dg - dw)
                <= 0.1 * np.linalg.norm(dw) + 1e-6), path
    got_s, want_s = _leaves(got["batch_stats"]), _leaves(want_stats)
    assert got_s.keys() == want_s.keys()
    for path, leaf in want_s.items():
        np.testing.assert_allclose(got_s[path], leaf, rtol=0, atol=2e-5,
                                   err_msg=path)


def test_one_train_step_matches_jax_in_float64(jax_f64_step):
    """Loss, grad_norm, every updated param and every batch_stat (flax's
    biased running variance) after one step. In f64 flax's dtype=float32
    BatchNorms take f32 statistics and return f32; the port's keep f64
    statistics and return f32, so the stacks agree to f32 rounding of
    those statistics, not to f64's.

    Tolerances, with the gaps measured on these inputs: loss 5e-5
    relative (2.5e-6) and weights 2e-4 absolute (9.6e-5), as in
    test_parity_torch.py's one-step test; batch_stats 2e-5 absolute
    (4.2e-6). The grad norm, 5e-3 relative (4.7e-4; 2.1e-3 with the
    port's statistics in f32 too): per tensor the gradients differ by a
    few % in one direction, because units of this piecewise-linear net
    whose inputs sit within the statistics' f32 rounding of a ReLU
    boundary flip; the norm is dominated by the few largest tensors. Each
    leaf's update, new minus old, 10% of its L2 norm (5.5% at most)."""
    check_f64_step(jax_f64_step, F64)


def test_eval_step_matches_jax():
    """make_eval_step at f32: metrics, probabilities and regression maps
    (running-stat BN) against JAX's; f32 convs in another summation
    order."""
    from voxelnet_tpu.training.train_step import TrainState
    from voxelnet_tpu.training.train_step import \
        make_eval_step as jax_make_eval_step

    jcfg, tcfg = configs()
    variables = jax_variables(jcfg, seed=9)
    batch = step_batch(jcfg, seed=9)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=())
    want, wprobs, wreg = jax_make_eval_step(jcfg)(state, batch)
    tstate = create_train_state(tcfg, torch_model(tcfg, variables),
                                device="cpu")
    got, probs, reg = make_eval_step(tcfg, device="cpu")(tstate, batch)
    assert set(got) == set(want)
    for name in got:
        assert float(got[name]) == pytest.approx(float(want[name]),
                                                 rel=1e-5), name
    np.testing.assert_allclose(probs.numpy(), np.asarray(wprobs), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(reg.numpy(), np.asarray(wreg), rtol=0,
                               atol=1e-4 * float(np.asarray(wreg).std()))


def test_host_inputs_give_the_same_step():
    """The step on host voxel buffers and target maps, and on int16
    wire-format points, equals the step on f32 points with device targets
    (the same model copy each time). The maps are the device assignment's:
    the host twin (TargetPrecomputer, held to JAX's above) computes IoU in
    f64 and may break a near-tie of the forced positive otherwise, as the
    JAX package's two paths do."""
    from voxelnet_tpu_torch.ops.anchors import anchors_flat
    from voxelnet_tpu_torch.ops.voxelize import (POINT_I16_SCALES,
                                                 VoxelGridSpec,
                                                 voxelize_table)

    jcfg, tcfg = configs()
    variables = jax_variables(jcfg, seed=13)
    batch = step_batch(tcfg, seed=13)
    step = make_train_step(tcfg, device="cpu")

    def run(b):
        state = create_train_state(tcfg, torch_model(tcfg, variables),
                                   device="cpu")
        _, metrics = step(state, b)
        return metrics, convert.to_jax_variables(state.model.state_dict())

    want, want_vars = run(batch)
    vox = voxelize_table(torch.from_numpy(batch["points"]),
                         torch.from_numpy(batch["num_points"]),
                         VoxelGridSpec.from_object_config(tcfg.object),
                         tcfg.data.max_voxels)
    obj = tcfg.object
    maps = targets.targets_to_maps(targets.assign_targets(
        torch.from_numpy(batch["gt_boxes"]), torch.from_numpy(
            batch["gt_mask"]), torch.from_numpy(anchors_flat(obj)),
        torch.from_numpy(targets.anchor_standup_np(obj)),
        pos_iou=obj.rpn_pos_iou, neg_iou=obj.rpn_neg_iou,
        anchor_h=obj.anchor_h), (obj.feature_height, obj.feature_width))
    host = {"voxel_features": vox.features.numpy(),
            "voxel_coords": vox.coords.numpy(),
            "voxel_counts": vox.counts.numpy(),
            **{k: m.numpy() for k, m in zip(
                ("target_pos", "target_neg", "target_reg"), maps)}}
    got, got_vars = run(host)
    assert "voxels_clipped" not in got
    for name in got:
        assert float(got[name]) == float(want[name]), name
    for path, leaf in _leaves(want_vars).items():
        np.testing.assert_array_equal(_leaves(got_vars)[path], leaf,
                                      err_msg=path)

    # int16 wire format: exact on points already on the 5 mm grid
    scales = np.asarray(POINT_I16_SCALES, np.float32)
    q = np.rint(batch["points"] / scales).astype(np.int16)
    on_grid = dict(batch, points=q.astype(np.float32) * scales)
    want_q, _ = run(on_grid)
    got_q, _ = run(dict(batch, points=q))
    for name in want_q:
        assert float(got_q[name]) == float(want_q[name]), name
