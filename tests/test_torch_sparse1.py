"""The port's `sparse1` middle (block 1 computed from the voxel table:
models/sparse_conv.py over kernels/sparse_conv.py) against the JAX
package's `sparse_conv3x3`, `MiddleLayers(backend='sparse1')` and
`make_inference_fn`, and against the port's own conv3d path. On the CPU
the kernel wrappers run their plain versions; tests/test_torch_cuda.py
holds the CUDA kernels to those on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, configs, jax_variables, merged,
                                random_points, torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch.config import get_config, resolve_plan
from voxelnet_tpu_torch.kernels.sparse_conv import occupancy_map
from voxelnet_tpu_torch.models.sparse_conv import sparse_conv3x3


# small grid of the conv tests: odd sizes, so no axis hides another
D, H, W, C, COUT, K = 6, 5, 9, 16, 8, 64
SPARSE1 = merged(TINY, data={"middle_backend": "sparse1"})


def _table(grid=(D, H, W), c=C, k=K, seed=0):
    """(feat (3, k, c), coords, counts) numpy, f32 / int32: frame 0 holds
    a voxel on every face of the grid and a run of random ones, frame 1
    random ones, frame 2 none. Padding rows (count 0) trail with garbage
    coords, in and out of the grid, and nonzero features."""
    d, h, w = grid
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(3, k, c)).astype(np.float32)
    coords = rng.integers(-3, max(grid) + 3, (3, k, 3)).astype(np.int32)
    counts = np.zeros((3, k), np.int32)
    faces = [(0, 1, 1), (d - 1, 2, 3), (1, 0, 2), (2, h - 1, 4),
             (3, 2, 0), (4, 3, w - 1), (0, 0, 0), (d - 1, h - 1, w - 1)]
    for b, n in ((0, k // 2), (1, k // 3)):
        lin = rng.choice(d * h * w, size=n, replace=False)
        if b == 0:
            face_lin = [(z * h + y) * w + x for z, y, x in faces]
            lin = np.unique(np.concatenate([face_lin, lin]))[:n]
        lin.sort()
        coords[b, :n] = np.stack([lin // (h * w), (lin // w) % h, lin % w],
                                 axis=1)
        counts[b, :n] = rng.integers(1, 36, n)
    return feat, coords, counts


def _weights(seed, c=C, cout=COUT):
    """JAX kernel (3, 3, 3, c, cout) and bias, f32 numpy, and the torch
    Conv3d weight (cout, c, 3, 3, 3) of the same kernel."""
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(3, 3, 3, c, cout)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    weight = np.ascontiguousarray(np.moveaxis(kernel, (-1, -2), (0, 1)))
    return kernel, bias, weight


def _port(feat, coords, counts, weight, bias, stride_d, pad_d, grid=(D, H, W),
          w_window=None):
    c, n = torch.from_numpy(coords), torch.from_numpy(counts)
    return sparse_conv3x3(feat, c, n, occupancy_map(c, n, grid), weight, bias,
                          stride_d, pad_d, w_window)


def _jax(feat, coords, counts, kernel, bias, stride_d, pad_d, w_window=None):
    from voxelnet_tpu.models.sparse_conv import sparse_conv3x3 as jax_conv

    return jax_conv(feat, jnp.asarray(coords), jnp.asarray(counts), kernel,
                    bias, (D, H, W), stride_d, pad_d, w_window=w_window)


BLOCKS = pytest.mark.parametrize("stride_d,pad_d", [(2, 1), (1, 0)],
                                 ids=["block1", "block2"])


@BLOCKS
def test_sparse_conv_matches_jax(stride_d, pad_d):
    feat, coords, counts = _table()
    kernel, bias, weight = _weights(1)
    want = np.asarray(_jax(jnp.asarray(feat), coords, counts,
                           jnp.asarray(kernel), jnp.asarray(bias), stride_d,
                           pad_d))
    got = _port(torch.from_numpy(feat), coords, counts,
                torch.from_numpy(weight), torch.from_numpy(bias), stride_d,
                pad_d).numpy()
    assert got.shape == want.shape == (3, (D + 2 * pad_d - 3) // stride_d
                                       + 1, H, W, COUT)
    # the same f32 sums in the same order after the product, whose 16-term
    # dot products round differently in XLA and torch: measured 3.8e-6 on
    # outputs of size ~5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the frame without a voxel is the bias, exactly
    assert (got[2] == bias).all()


@BLOCKS
def test_sparse_conv_grads_match_jax(stride_d, pad_d):
    """d(sum(out * cot)) / d(feat, weight, bias) against jax.grad."""
    feat, coords, counts = _table(seed=2)
    kernel, bias, weight = _weights(3)
    do = (D + 2 * pad_d - 3) // stride_d + 1
    cot = np.random.default_rng(4).normal(size=(3, do, H, W, COUT)).astype(
        np.float32)

    def loss(f, k, b):
        return (_jax(f, coords, counts, k, b, stride_d, pad_d) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(kernel), jnp.asarray(bias))
    f, w, b = (torch.from_numpy(a).requires_grad_()
               for a in (feat, weight, bias))
    (_port(f, coords, counts, w, b, stride_d, pad_d)
     * torch.from_numpy(cot)).sum().backward()
    # f32 products and sums of up to 27 * 3 * 64 terms in two orders:
    # measured up to 1.9e-6 of gradients of size ~30
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        w.grad.numpy(), np.moveaxis(np.asarray(want[1]), (-1, -2), (0, 1)),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-4)
    # padding rows get no gradient
    assert (f.grad.numpy()[counts == 0] == 0).all()


def test_w_window_partition_matches_jax():
    """Windows that cover W, uneven ones included: each equal to JAX's
    window, and together equal to the full output."""
    feat, coords, counts = _table(seed=5)
    kernel, bias, weight = _weights(6)
    tf, tw, tb = (torch.from_numpy(a) for a in (feat, weight, bias))
    full = _port(tf, coords, counts, tw, tb, 2, 1).numpy()
    parts = []
    for x0, wloc in ((0, 4), (4, 2), (6, 3)):
        got = _port(tf, coords, counts, tw, tb, 2, 1,
                    w_window=(x0, wloc)).numpy()
        want = np.asarray(_jax(jnp.asarray(feat), coords, counts,
                               jnp.asarray(kernel), jnp.asarray(bias), 2, 1,
                               w_window=(x0, wloc)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        parts.append(got)
    # the port's windows are the port's full output, bit for bit
    np.testing.assert_array_equal(np.concatenate(parts, axis=3), full)


# the middle tests' grid
MIDDLE_GRID = (10, 12, 14)


@pytest.fixture(scope="module")
def middle_case():
    """JAX variables of the tiny Car config with sparse1, and a voxel
    table of 128 channels on MIDDLE_GRID."""
    jcfg, tcfg = configs(overrides=SPARSE1)
    variables = jax_variables(jcfg, seed=7)
    return tcfg, variables, _table(MIDDLE_GRID, c=128, k=600, seed=8)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_middle_matches_jax(middle_case, train):
    """MiddleLayers(backend='sparse1') in eval mode (running-stat BN) and
    train mode (batch statistics, running stats moved) against JAX's, and
    against the port's own run in f64."""
    from voxelnet_tpu.models.middle import MiddleLayers as JaxMiddle

    tcfg, variables, (feat, coords, counts) = middle_case
    mid = {"params": variables["params"]["middle"],
           "batch_stats": variables["batch_stats"]["middle"]}
    jmid = JaxMiddle(dtype=jnp.float32, backend="sparse1",
                     depth_in=MIDDLE_GRID[0], grid_hw=MIDDLE_GRID[1:])
    table = (jnp.asarray(feat), jnp.asarray(coords), jnp.asarray(counts))
    if train:
        want, new = jmid.apply(mid, table, True, mutable=["batch_stats"])
    else:
        want = jmid.apply(mid, table, False)
    c, n = torch.from_numpy(coords), torch.from_numpy(counts)
    occ = occupancy_map(c, n, MIDDLE_GRID)
    got = {}
    for dtype in (torch.float32, torch.float64):
        middle = torch_model(tcfg, variables).to(dtype).middle.train(train)
        with torch.no_grad():
            out = middle.from_table(torch.from_numpy(feat).to(dtype), c, n,
                                    occ)
        got[dtype] = out.permute(0, 2, 3, 1).numpy()
    assert got[torch.float32].shape == (3, *MIDDLE_GRID[1:], 128)
    # eval: f32 through three convs in two summation orders, measured
    # 2.5e-7 on activations that spread by 0.09. Train: XLA:CPU sums flax's
    # f32 BN statistics in sequence, 1.1e-4 off the f64 result (the port's
    # f32 run: 7e-6) on activations that spread by 0.63
    atol = 2e-4 if train else 2e-6
    np.testing.assert_allclose(got[torch.float32], np.asarray(want),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got[torch.float32], got[torch.float64],
                               rtol=0, atol=2e-5 if train else 2e-6)
    if train:
        stats = new["batch_stats"]
        for i in range(3):
            bn = getattr(middle, f"ConvBlock3D_{i}").BatchNorm_0
            for leaf, buf in (("mean", bn.running_mean),
                              ("var", bn.running_var)):
                np.testing.assert_allclose(
                    buf.numpy(), np.asarray(stats[f"ConvBlock3D_{i}"][
                        "BatchNorm_0"][leaf]), rtol=1e-5, atol=1e-6)


def test_inference_matches_jax():
    """make_inference_fn with sparse1 (fused VFE -> occupancy map ->
    sparse block 1) against JAX's with sparse1 (its fused VFE in interpret
    mode), detections compared by score and box (top-k ties)."""
    from voxelnet_tpu.models.voxelnet import make_inference_fn as jax_fn
    from voxelnet_tpu_torch.models.voxelnet import make_inference_fn

    overrides = merged(SPARSE1, data={"vfe_backend": "fused"},
                       rpn={"score_thres": 0.0})
    jcfg, tcfg = configs(overrides=overrides)
    variables = jax_variables(jcfg, seed=9)
    rng = np.random.default_rng(9)
    points, num = random_points(rng, jcfg, 2, 1800)
    num[1] = 900
    want = jax.jit(jax_fn(jcfg, platform="cpu"))(variables, points, num)
    got = make_inference_fn(tcfg, "cpu")(torch_model(tcfg, variables),
                                         points, num)
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    assert got.valid.sum() >= 20
    for b in range(2):
        wv, gv = np.asarray(want.valid[b]), got.valid[b].numpy()
        w_scores = np.asarray(want.scores[b])[wv]
        g_scores = got.scores[b].numpy()[gv]
        wo, go = np.argsort(-w_scores), np.argsort(-g_scores)
        # f32 after the bf16 VFE output, as test_torch_slice.py's conv3d
        # slice: held to the same 1e-6 on scores and 1e-4 m on boxes
        np.testing.assert_allclose(g_scores[go], w_scores[wo], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy()[gv][go],
                                   np.asarray(want.boxes[b])[wv][wo],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plain_matches_conv3d_path(dtype):
    """The sparse block 1 (the plain versions) against the port's Conv3d of
    the dense grid from the same table and weights: the same convolution.

    f32: 1e-5. bf16: the sparse path rounds each of the 27 offset terms to
    bf16 (JAX's `vals` in feat.dtype) and their f32 sum + bias once; the
    Conv3d rounds its f32 sum once and adds the bias in bf16. Where the
    terms cancel, one ulp of the output is no bound; one half-ulp (2**-8
    relative) per rounding is: |got - want| <= 2**-8 * (sum|terms| + |conv|
    + 2 |out|) <= 2**-6 * m, m = sum_o |term_o| + |bias|, i.e. two bf16 ulps
    of m. Measured: at most 1.0 ulp of m, 15% of elements not bit-equal."""
    from voxelnet_tpu_torch.kernels.sparse_conv import sparse_conv_plain
    from voxelnet_tpu_torch.models.scatter import scatter_to_dense_streamed
    from voxelnet_tpu_torch.models.sparse_conv import weight_matrix

    grid = (10, 16, 12)
    feat, coords, counts = _table(grid, c=128, k=200, seed=10)
    kernel, bias, weight = _weights(11, c=128, cout=64)
    weight, bias = torch.from_numpy(weight) * 0.2, torch.from_numpy(bias)
    tf = torch.from_numpy(feat).to(dtype)
    c, n = torch.from_numpy(coords), torch.from_numpy(counts)
    live = torch.where((n > 0)[..., None], tf, 0)
    with torch.no_grad():
        got = sparse_conv3x3(tf, c, n, occupancy_map(c, n, grid), weight,
                             bias, 2, 1)
        dense = scatter_to_dense_streamed(live, c, n, grid)
        want = torch.nn.functional.conv3d(
            dense.permute(0, 4, 1, 2, 3), weight.to(dtype), bias.to(dtype),
            (2, 1, 1), (1, 1, 1)).permute(0, 2, 3, 4, 1)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    if dtype == torch.float32:
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
        return
    terms = (live @ weight_matrix(weight.to(dtype))).view(3, 200, 27, 64)
    m = sparse_conv_plain(terms.abs().float(), c, n, bias.abs(), grid, 2,
                          1).double()
    assert ((g - w).abs() <= 2.0 ** -6 * m).all()
    assert 0 < (g != w).double().mean() < 0.3


def test_resolver_picks_the_table_path_only_for_sparse1():
    """'sparse1' selects the table path; 'auto' and every other accepted
    value keep conv3d, the JAX resolver's answer off the TPU."""
    from voxelnet_tpu_torch.config import MIDDLE_BACKENDS
    from voxelnet_tpu_torch.models.voxelnet import VoxelNet

    for value in MIDDLE_BACKENDS:
        cfg = get_config("Car", **merged(TINY, data={"middle_backend":
                                                     value}))
        want = "sparse1" if value == "sparse1" else "conv3d"
        assert resolve_plan(cfg).middle == want
        assert resolve_plan(cfg, train=True).middle == want
        assert VoxelNet(cfg).middle_path == want
    assert resolve_plan(get_config("Car")).middle == "conv3d"


def test_one_parameter_tree_for_both_paths():
    """JAX's sparse1 and conv3d trees are identical, and so are the port's
    state_dicts: convert.py and the checkpoints need no change. A conv3d
    model's weights load strictly into a sparse1 one and back."""
    from voxelnet_tpu_torch.models.voxelnet import VoxelNet

    jcfg, tcfg = configs(overrides=SPARSE1)
    jdense, tdense = configs()
    shapes = [jax.tree.map(np.shape, jax_variables(cfg)) for cfg in
              (jcfg, jdense)]
    assert shapes[0] == shapes[1]
    sparse, dense = VoxelNet(tcfg), VoxelNet(tdense)
    assert ({k: v.shape for k, v in sparse.state_dict().items()}
            == {k: v.shape for k, v in dense.state_dict().items()})
    sparse.load_state_dict(dense.state_dict())
    dense.load_state_dict(sparse.state_dict())
    # and a JAX sparse1 tree through the weight bridge
    torch_model(tcfg, jax_variables(jcfg, seed=1))


@pytest.mark.parametrize("axis,value", [(0, -1), (1, H), (2, W)],
                         ids=["z_below", "y_past", "x_past"])
def test_occupancy_map_refuses_live_voxels_outside_the_grid(axis, value):
    """A live row outside the grid raises, also where its flat index lands
    inside the grid (y or x past its axis); a padding row there does not.
    The row is the frame's last live one, so that as padding it trails."""
    _, coords, counts = _table(seed=3)
    last = int((counts[1] > 0).sum()) - 1
    coords[1, last, axis] = value
    with pytest.raises(ValueError, match="outside the grid"):
        occupancy_map(torch.from_numpy(coords), torch.from_numpy(counts),
                      (D, H, W))
    counts[1, last] = 0
    occ = occupancy_map(torch.from_numpy(coords), torch.from_numpy(counts),
                        (D, H, W))
    assert int((occ[1] >= 0).sum()) == int((counts[1] > 0).sum())


@pytest.mark.parametrize("fault", ["swap", "duplicate", "padding_first"])
def test_occupancy_map_refuses_live_voxels_out_of_order(fault):
    """Live rows of a frame whose cell ids do not ascend strictly, or a
    live row after a padding row, raise (the order the kernel needs and
    every voxelizer gives); the trailing padding rows' garbage coords, in
    and out of the grid, do not. A live row outside the grid is named
    first."""
    _, coords, counts = _table(seed=3)
    live = int((counts[1] > 0).sum())
    pad = coords[1, live:]
    assert ((pad < 0) | (pad >= np.asarray([D, H, W]))).any()
    before = occupancy_map(torch.from_numpy(coords), torch.from_numpy(counts),
                           (D, H, W))
    assert int((before[1] >= 0).sum()) == live
    if fault == "swap":
        coords[1, [3, 4]] = coords[1, [4, 3]]
    elif fault == "duplicate":
        coords[1, 4] = coords[1, 3]
    else:
        counts[1, 3] = 0
    with pytest.raises(ValueError, match="strictly ascending"):
        occupancy_map(torch.from_numpy(coords), torch.from_numpy(counts),
                      (D, H, W))
    coords[1, 0, 1] = H
    with pytest.raises(ValueError, match="outside the grid"):
        occupancy_map(torch.from_numpy(coords), torch.from_numpy(counts),
                      (D, H, W))
