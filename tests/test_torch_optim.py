"""The port's choice of optimizer against optax and the JAX train step on
the CPU: momentum SGD with a 10x LR drop against `optax.chain(
clip_by_global_norm, sgd(piecewise_constant_schedule, momentum))`, three
f64 momentum steps against JAX's `make_train_step(cfg, tx)`, and the
momentum trace through a checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import (TINY, configs, init_scale_biases,
                                jax_variables, merged, step_batch,
                                torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.training import optim
from voxelnet_tpu_torch.training.checkpoint import CheckpointManager
from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

MOMENTUM = 0.9


def _trace(state):
    """The trace leaves of an optax chain's TraceState."""
    found = [s for s in jax.tree.leaves(
        state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(found) == 1
    return found[0].trace


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_piecewise_schedule_matches_optax():
    bounds = {3: 0.1, 7: 0.5, 9: 0.0}
    want = optax.piecewise_constant_schedule(0.005, bounds)
    got = optim.piecewise_constant_schedule(0.005, bounds)
    for count in range(12):
        assert got(count) == float(want(count)), count
    assert optim.piecewise_constant_schedule(0.005)(10**6) == float(
        np.float32(0.005))
    with pytest.raises(ValueError, match="non-negative"):
        optim.piecewise_constant_schedule(1.0, {2: -1.0})


def test_momentum_sgd_with_drop_matches_optax():
    """Six updates that cross the drop at count 3, on gradients whose norm
    is below the clip (5) and above it, in turn: parameters and traces at
    rtol 1e-6 (as test_clip_and_schedule_match_optax); the count moves once
    per update."""
    cfg = get_config("Car", **TINY)
    lr, boundary = 0.005, 3
    tx = optax.chain(optax.clip_by_global_norm(cfg.train.gradient_clip),
                     optax.sgd(optax.piecewise_constant_schedule(
                         lr, {boundary: 0.1}), momentum=MOMENTUM))
    sgd = optim.ClippedSGD(cfg, momentum=MOMENTUM,
                           schedule=optim.piecewise_constant_schedule(
                               lr, {boundary: 0.1}))
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jstate = tx.init(params)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    state = sgd.init(tparams)
    assert state.count == 0 and all(not t.any() for t in state.trace)
    norms = []
    for i in range(6):
        scale = 1e-2 if i % 2 == 0 else 1e3
        grads = [rng.normal(0, scale, s).astype(np.float32) for s in shapes]
        updates, jstate = tx.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        norm, state = sgd.apply_(tparams, [torch.from_numpy(g)
                                           for g in grads], state)
        assert state.count == i + 1
        norms.append(float(norm))
        assert float(norm) == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-6)
        for t, w in zip(tparams, params):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        for t, w in zip(state.trace, _trace(jstate)):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    assert min(norms[1::2]) > 5 > max(norms[::2])


def test_optimizer_state_must_fit():
    cfg = get_config("Car", **TINY)
    p = [torch.zeros(3)]
    plain = optim.make_optimizer(cfg, 10)
    assert plain.init(p) == optim.OptState(count=0, trace=None)
    with pytest.raises(ValueError, match="momentum"):
        plain.apply_(p, [torch.ones(3)],
                     optim.ClippedSGD(cfg, momentum=0.9).init(p))


# --- three f64 train steps with momentum -------------------------------------

# test_torch_train.py's f64 step at a quarter of its grid (10 x 32 x 32,
# 512 voxel slots: the same 5% of the cells) and lr 1e-4: an f64 JAX step
# at the full tiny grid takes ~20 s on the CPU
F64 = merged(TINY, object={"x_min": 3.2, "x_max": 9.6, "y_min": -3.2,
                           "y_max": 3.2},
             train={"compute_dtype": "float64", "lr": 1e-4},
             data={"max_voxels": 512, "max_points": 2048})
STEPS, BOUNDARY = 3, 2


def _schedule():
    return {BOUNDARY: 0.1}


@pytest.fixture(scope="module")
def jax_momentum_steps():
    """Three JAX make_train_step(cfg, tx) calls at x64, tx the momentum
    chain with its drop after step 2, on one batch: the variables, the
    batch and, after each step, (params, batch_stats, trace, metrics)."""
    from voxelnet_tpu.training.train_step import TrainState
    from voxelnet_tpu.training.train_step import \
        make_train_step as jax_make_train_step

    jcfg, _ = configs(overrides=F64)
    variables = init_scale_biases(jax_variables(jcfg, seed=21), 21)
    batch = step_batch(jcfg, seed=21, n=2000)
    tx = optax.chain(
        optax.clip_by_global_norm(jcfg.train.gradient_clip),
        optax.sgd(optax.piecewise_constant_schedule(jcfg.train.lr,
                                                    _schedule()),
                  momentum=MOMENTUM))
    jax.config.update("jax_enable_x64", True)
    try:
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        step = jax_make_train_step(jcfg, tx, donate=False)
        out = []
        for _ in range(STEPS):
            state, metrics = step(state, batch)
            out.append((jax.tree.map(np.asarray, state.params),
                        jax.tree.map(np.asarray, state.batch_stats),
                        jax.tree.map(np.asarray, _trace(state.opt_state)),
                        {k: float(v) for k, v in metrics.items()}))
    finally:
        jax.config.update("jax_enable_x64", False)
    return variables, batch, out


def _port_trace(model, jax_trace) -> tuple:
    """A JAX params-shaped trace -> the port's, in parameter order."""
    sd = convert.from_jax_variables({"params": jax_trace})
    return tuple(sd[name].clone() for name, _ in model.named_parameters())


def test_momentum_train_steps_match_jax_in_float64(jax_momentum_steps):
    """Each of three momentum steps, the port started from JAX's state
    before it (weights, BN stats, trace and update count; the first from
    the random variables and a zero trace), at the tolerances of
    test_one_train_step_matches_jax_in_float64: loss and its parts 5e-5
    relative, grad norm 5e-3 relative, weights 2e-4 absolute, batch_stats
    2e-5 absolute, each leaf's update within 10% of JAX's (+1e-6), and so
    each trace leaf. The step after the drop moves by a tenth of the LR.
    Each step starts from JAX's state: a chained run carries step 1's
    f32-BN differences (a few % of a tensor's gradient, see that test)
    into step 2's loss (1e-4 relative at this grid)."""
    variables, batch, want_steps = jax_momentum_steps
    _, tcfg = configs(overrides=F64)
    sgd = optim.ClippedSGD(tcfg, momentum=MOMENTUM,
                           schedule=optim.piecewise_constant_schedule(
                               tcfg.train.lr, _schedule()))
    step = make_train_step(tcfg, device="cpu", optimizer=sgd)
    start = (variables, None)
    for i, (want_params, want_stats, want_trace, want) in enumerate(
            want_steps):
        start_vars, start_trace = start
        state = create_train_state(tcfg, torch_model(tcfg, start_vars),
                                   device="cpu", optimizer=sgd)
        if start_trace is not None:
            state.opt_state = optim.OptState(
                count=i, trace=_port_trace(state.model, start_trace))
        before = _leaves(start_vars["params"])
        state, metrics = step(state, batch)
        assert state.opt_state.count == i + 1
        assert set(metrics) == set(want)
        for name in ("loss", "cls_loss", "reg_loss", "cls_pos_loss",
                     "cls_neg_loss"):
            assert float(metrics[name]) == pytest.approx(
                want[name], rel=5e-5), (i, name)
        assert float(metrics["grad_norm"]) == pytest.approx(
            want["grad_norm"], rel=5e-3), i
        assert want["grad_norm"] > tcfg.train.gradient_clip
        got = convert.to_jax_variables(state.model.state_dict())
        got_p, want_p = _leaves(got["params"]), _leaves(want_params)
        assert got_p.keys() == want_p.keys()
        moves = []
        for path, leaf in want_p.items():
            np.testing.assert_allclose(got_p[path], leaf, rtol=0, atol=2e-4,
                                       err_msg=f"step {i + 1} {path}")
            dg, dw = got_p[path] - before[path], leaf - before[path]
            assert (np.linalg.norm(dg - dw)
                    <= 0.1 * np.linalg.norm(dw) + 1e-6), (i, path)
            moves.append(np.linalg.norm(dw))
        got_t = _leaves(convert.to_jax_variables(dict(zip(
            [n for n, _ in state.model.named_parameters()],
            state.opt_state.trace)))["params"])
        for path, leaf in _leaves(want_trace).items():
            assert (np.linalg.norm(got_t[path] - leaf)
                    <= 0.1 * np.linalg.norm(leaf) + 1e-6), (i, path)
        got_s, want_s = _leaves(got["batch_stats"]), _leaves(want_stats)
        for path, leaf in want_s.items():
            np.testing.assert_allclose(got_s[path], leaf, rtol=0, atol=2e-5,
                                       err_msg=f"step {i + 1} {path}")
        if i == BOUNDARY:       # the first update at a tenth of the LR
            assert max(moves) < 0.5 * max_moves
        max_moves = max(moves)
        start = ({"params": want_params, "batch_stats": want_stats},
                 want_trace)


# --- the trace through a checkpoint ------------------------------------------

def _momentum_run(cfg, tmp_path):
    sgd = optim.ClippedSGD(cfg, momentum=MOMENTUM)
    batch = step_batch(cfg, seed=5)
    step = make_train_step(cfg, device="cpu", optimizer=sgd)
    state = create_train_state(cfg, seed=5, device="cpu", optimizer=sgd)
    state, _ = step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), config=cfg)
    mgr.save(1, state)
    return sgd, step, state, mgr, batch


def test_checkpoint_carries_the_momentum_trace(tmp_path):
    """A restored state takes the same next step as the one saved: every
    parameter, BN stat and trace bit-equal."""
    cfg = get_config("Car", **TINY)
    sgd, step, state, mgr, batch = _momentum_run(cfg, tmp_path)
    restored = mgr.restore(create_train_state(cfg, seed=9, device="cpu",
                                              optimizer=sgd))
    assert restored.step == 1 and restored.opt_state.count == 1
    for a, b in zip(restored.opt_state.trace, state.opt_state.trace):
        assert torch.equal(a, b)
    assert any(t.abs().max() > 0 for t in state.opt_state.trace)
    state, want = step(state, batch)
    restored, got = step(restored, batch)
    assert float(got["loss"]) == float(want["loss"])
    for (k, a), b in zip(restored.model.state_dict().items(),
                         state.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(restored.opt_state.trace, state.opt_state.trace):
        assert torch.equal(a, b)


def test_checkpoint_of_another_optimizer_is_refused(tmp_path):
    """A momentum checkpoint into a state without a trace, and a plain
    one into a state with a trace."""
    cfg = get_config("Car", **TINY)
    _, _, _, mgr, _ = _momentum_run(cfg, tmp_path)
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore(create_train_state(cfg, device="cpu"))
    plain = CheckpointManager(str(tmp_path / "plain"), config=cfg)
    plain.save(0, create_train_state(cfg, device="cpu"))
    with pytest.raises(ValueError, match="does not fit"):
        plain.restore(create_train_state(
            cfg, device="cpu",
            optimizer=optim.ClippedSGD(cfg, momentum=MOMENTUM)))
