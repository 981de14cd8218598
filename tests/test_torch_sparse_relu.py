"""The ReLU that `sparse1`'s block 1 runs in the sparse conv's store where
its BatchNorm is folded away (kernels/sparse_conv.py `relu=True`), against
JAX's `sparse_conv3x3` followed by `jax.nn.relu` and against the port's
unfused path; and the paths that keep the ReLU pass of their own (train
mode, the eval step, `data.fold_bn='off'`). On the CPU the wrappers run
their plain versions; tests/test_torch_cuda.py holds the CUDA kernel to
them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sparse1 import (BLOCKS, COUT, MIDDLE_GRID, SPARSE1, D, H, W,
                                _jax, _table, _weights)
from torch_port_helpers import merged, random_points, step_batch

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.kernels import sparse_conv as sc
from voxelnet_tpu_torch.models import middle as middle_mod
from voxelnet_tpu_torch.models.sparse_conv import sparse_conv3x3
from voxelnet_tpu_torch.models.voxelnet import (build_model,
                                                make_inference_fn,
                                                prepare_for_inference)
from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                    make_eval_step,
                                                    make_train_step)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test runner's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(feat, coords, counts, weight, bias, stride_d, pad_d, w_window=None,
          relu=False):
    c, n = torch.from_numpy(coords), torch.from_numpy(counts)
    return sparse_conv3x3(feat, c, n, sc.occupancy_map(c, n, (D, H, W)),
                          weight, bias, stride_d, pad_d, w_window, relu)


@BLOCKS
@pytest.mark.parametrize("w_window", [None, (2, 5)], ids=["full", "window"])
def test_sparse_conv_relu_matches_jax(stride_d, pad_d, w_window):
    """sparse_conv_plain(..., relu=True) against JAX's sparse_conv3x3
    followed by jax.nn.relu, and bit-equal to the ReLU of its own unfused
    output."""
    feat, coords, counts = _table(seed=12)
    kernel, bias, weight = _weights(13)
    want = np.asarray(jax.nn.relu(_jax(
        jnp.asarray(feat), coords, counts, jnp.asarray(kernel),
        jnp.asarray(bias), stride_d, pad_d, w_window)))
    tf, tw, tb = (torch.from_numpy(a) for a in (feat, weight, bias))
    got = _port(tf, coords, counts, tw, tb, stride_d, pad_d, w_window, True)
    wloc = W if w_window is None else w_window[1]
    assert got.shape == want.shape == (3, (D + 2 * pad_d - 3) // stride_d
                                       + 1, H, wloc, COUT)
    # test_sparse_conv_matches_jax's tolerance: the same f32 sums after a
    # product that rounds differently in XLA and torch
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got.numpy() == 0).mean() > 0.2
    unfused = _port(tf, coords, counts, tw, tb, stride_d, pad_d, w_window)
    assert torch.equal(got, torch.relu(unfused))
    # the plain version itself, on the product the port computes
    c, n = torch.from_numpy(coords), torch.from_numpy(counts)
    vals = (tf * (n > 0)[..., None]) @ tw.permute(1, 2, 3, 4, 0).reshape(
        tf.shape[-1], -1)
    plain = sc.sparse_conv_plain(vals.view(3, -1, 27, COUT), c, n, tb,
                                 (D, H, W), stride_d, pad_d, w_window, True)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_relu_is_the_relu_after_the_cast(dtype):
    """The ReLU runs on the value in vals' type: equal to torch.relu of the
    unfused output in that type, at every site."""
    feat, coords, counts = _table(seed=14)
    kernel, bias, weight = _weights(15)
    tf = torch.from_numpy(feat).to(dtype)
    tw, tb = torch.from_numpy(weight), torch.from_numpy(bias)
    got = _port(tf, coords, counts, tw, tb, 2, 1, relu=True)
    want = torch.relu(_port(tf, coords, counts, tw, tb, 2, 1))
    assert got.dtype == dtype and torch.equal(got, want)


@BLOCKS
def test_relu_gradients_match_the_unfused_path(stride_d, pad_d):
    """Gradients through the fused ReLU equal those through torch.relu of
    the unfused output, and JAX's grad of relu(sparse_conv3x3)."""
    feat, coords, counts = _table(seed=16)
    kernel, bias, weight = _weights(17)
    do = (D + 2 * pad_d - 3) // stride_d + 1
    cot = np.random.default_rng(18).normal(size=(3, do, H, W, COUT)).astype(
        np.float32)
    grads = []
    for fused in (True, False):
        f, w, b = (torch.from_numpy(a).requires_grad_()
                   for a in (feat, weight, bias))
        out = _port(f, coords, counts, w, b, stride_d, pad_d, relu=fused)
        if not fused:
            out = torch.relu(out)
        (out * torch.from_numpy(cot)).sum().backward()
        grads.append((f.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)

    def loss(f, k, b):
        return (jax.nn.relu(_jax(f, coords, counts, k, b, stride_d, pad_d))
                * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(kernel), jnp.asarray(bias))
    # test_sparse_conv_grads_match_jax's tolerances
    np.testing.assert_allclose(grads[0][0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        grads[0][1].numpy(),
        np.moveaxis(np.asarray(want[1]), (-1, -2), (0, 1)), rtol=1e-5,
        atol=1e-4)
    np.testing.assert_allclose(grads[0][2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-4)


@pytest.fixture
def spy(monkeypatch):
    """Records the `relu` of every sparse_conv3x3 call of the middle and
    the outputs' shapes of every bn_relu call."""
    calls = {"relu": [], "bn_relu": []}
    unspied = middle_mod.bn_relu

    def conv(*args, relu=False, **kw):
        calls["relu"].append(relu)
        return sparse_conv3x3(*args, relu=relu, **kw)

    def bn_relu(bn, y, dtype):
        calls["bn_relu"].append(tuple(y.shape))
        return unspied(bn, y, dtype)

    monkeypatch.setattr(middle_mod, "sparse_conv3x3", conv)
    monkeypatch.setattr(middle_mod, "bn_relu", bn_relu)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_folded_from_table_fuses_the_relu(spy, dtype):
    """The folded inference copy's block 1 passes relu=True and runs no
    bn_relu; its output, and the whole middle's, equal the unfused path
    (sparse conv, then bn_relu without a BN)."""
    cfg = get_config("Car", **SPARSE1)
    net = prepare_for_inference(build_model(cfg, seed=19), True, dtype,
                                "sparse1")
    block = net.middle.ConvBlock3D_0
    assert block.BatchNorm_0 is None
    feat, coords, counts = _table(MIDDLE_GRID, c=128, k=600, seed=20)
    tf = torch.from_numpy(feat).to(dtype)
    c, n = torch.from_numpy(coords), torch.from_numpy(counts)
    occ = sc.occupancy_map(c, n, MIDDLE_GRID)
    conv = block.Conv_0
    with torch.inference_mode():
        got = block.from_table(tf, c, n, occ)
        assert spy == {"relu": [True], "bn_relu": []}
        y = sparse_conv3x3(tf, c, n, occ, conv.weight, conv.bias,
                           conv.stride[0], conv.padding[0])
        want = middle_mod.bn_relu(None, y.permute(0, 4, 1, 2, 3), dtype)
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want)
        bev = net.middle.from_table(tf, c, n, occ)
        x = want
        for b in (net.middle.ConvBlock3D_1, net.middle.ConvBlock3D_2):
            x = b(x)
        assert torch.equal(bev, middle_mod._bev(x))


def test_train_eval_and_unfolded_paths_keep_the_relu_pass(spy):
    """Train mode (the train step), the eval step (running-stat BN) and
    data.fold_bn='off' inference never pass relu=True and run bn_relu on
    block 1's output; folded inference passes it and does not."""
    tiny = merged(SPARSE1, rpn={"score_thres": 0.0})
    cfg = get_config("Car", **tiny)
    model = build_model(cfg, seed=21)
    batch = step_batch(cfg, seed=21, n=1200)
    state = create_train_state(cfg, model, device="cpu")
    state, metrics = make_train_step(cfg, device="cpu")(state, batch)
    assert np.isfinite([float(v) for v in metrics.values()]).all()
    make_eval_step(cfg, device="cpu")(state, batch)
    points, num = random_points(np.random.default_rng(21), cfg, 2, 1200)
    make_inference_fn(get_config("Car", **merged(
        tiny, data={"fold_bn": "off"})), "cpu")(model, points, num)
    # step, eval step, unfolded inference: one block-1 call each, each
    # followed by bn_relu on its output (and blocks 2-3's)
    assert spy["relu"] == [False] * 3
    assert len(spy["bn_relu"]) == 9
    spy["relu"].clear()
    spy["bn_relu"].clear()
    make_inference_fn(cfg, "cpu")(model, points, num)
    assert spy["relu"] == [True] and len(spy["bn_relu"]) == 2
