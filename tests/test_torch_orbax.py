"""The Orbax reader of the port (voxelnet_tpu_torch/tools/orbax_to_npz.py)
on checkpoints the JAX package writes on the CPU: a `save_single`
variables dir, and a `CheckpointManager` TrainState step written from
params placed on a 2-device mesh. The converted .npz loads to exactly
`convert.from_jax_variables` of the JAX `load_variables` tree, carries the
decode knobs of `--class-name`/`--cfg` or of the experiment's
config.yaml, and serves a tiny-grid inference equal to JAX's (scores
within 1e-6, boxes within 1e-4 m, as tests/test_torch_slice.py)."""

import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import (TINY, configs, jax_variables, merged,
                                random_points)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.tools import orbax_to_npz

OVERRIDES = merged(TINY, rpn={"score_thres": 0.0},
                   train={"yaw_encoding": "sin"})


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """(JAX config, variables, exp dir with config.yaml and a
    CheckpointManager step 3, save_single dir)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from voxelnet_tpu.training import checkpoint as jax_ckpt
    from voxelnet_tpu.training.train_step import TrainState

    root = tmp_path_factory.mktemp("orbax")
    jcfg, _ = configs(overrides=OVERRIDES)
    variables = jax_variables(jcfg, seed=21)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    on_mesh = jax.device_put(variables, NamedSharding(mesh, PartitionSpec()))
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.sgd(0.01, momentum=0.9))
    state = TrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                       params=on_mesh["params"],
                       batch_stats=on_mesh["batch_stats"],
                       opt_state=tx.init(on_mesh["params"]))
    exp = root / "exp"
    mgr = jax_ckpt.CheckpointManager(str(exp / "checkpoints"))
    mgr.save(3, state, {"val_loss": 1.5})
    mgr.close()
    (exp / "config.yaml").write_text(jcfg.dump_yaml())
    single = str(root / "single")
    jax_ckpt.save_single(single, variables)
    return jcfg, variables, str(exp), single


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("layout", ["step", "root", "single"])
def test_npz_is_the_jax_load_variables_tree(jax_checkpoints, tmp_path,
                                            layout):
    from voxelnet_tpu.training.checkpoint import load_variables

    _, variables, exp, single = jax_checkpoints
    src = {"step": os.path.join(exp, "checkpoints", "3"),
           "root": os.path.join(exp, "checkpoints"), "single": single}[layout]
    dst = str(tmp_path / "w.npz")
    orbax_to_npz.main([src, dst, "--class-name", "Car"])
    got = convert.load_npz(dst)
    want = load_variables(src)
    got_flat = dict(_flat({"params": got["params"],
                           "batch_stats": got["batch_stats"]}))
    want_flat = dict(_flat(want))
    assert got_flat.keys() == want_flat.keys() and len(got_flat) > 50
    for key, w in want_flat.items():
        assert got_flat[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got_flat[key], w, err_msg=key)
    np.testing.assert_array_equal(
        got_flat["params/rpn/prob_conv/kernel"],
        variables["params"]["rpn"]["prob_conv"]["kernel"])
    sd_got = convert.from_jax_variables(got)
    sd_want = convert.from_jax_variables(want)
    assert sd_got.keys() == sd_want.keys()
    assert all(torch.equal(sd_got[k], sd_want[k]) for k in sd_want)
    assert got["meta"]["yaw_encoding"] == "delta"      # --class-name Car


def test_decode_knobs_from_the_experiment(jax_checkpoints, tmp_path,
                                          capsys):
    """Without --cfg / --class-name the knobs are the exp dir's
    config.yaml's (yaw_encoding 'sin'); a save_single dir has none, and
    the .npz loads with load_npz's warning."""
    jcfg, _, exp, single = jax_checkpoints
    _, cfg = configs(overrides=OVERRIDES)
    dst = str(tmp_path / "w.npz")
    orbax_to_npz.main([os.path.join(exp, "checkpoints"), dst])
    assert capsys.readouterr().out == dst + "\n"
    meta = convert.load_npz(dst, cfg)["meta"]
    assert meta == json.loads(json.dumps(convert.decode_knobs(
        jcfg.to_dict())))
    assert meta["yaw_encoding"] == "sin" and meta["object"]["x_max"] == 12.8
    orbax_to_npz.main([single, dst])
    with pytest.warns(UserWarning, match="no decode knobs"):
        convert.load_npz(dst, cfg)


def test_converted_weights_serve_jax_inference(jax_checkpoints, tmp_path):
    from voxelnet_tpu.models.voxelnet import make_inference_fn as jax_fn
    from voxelnet_tpu_torch.cli.predict import load_model
    from voxelnet_tpu_torch.models.voxelnet import make_inference_fn

    jcfg, variables, exp, _ = jax_checkpoints
    _, cfg = configs(overrides=OVERRIDES)
    dst = str(tmp_path / "w.npz")
    orbax_to_npz.convert_checkpoint(os.path.join(exp, "checkpoints", "3"),
                                    dst)
    model = load_model(cfg, dst, seed=0, device="cpu")
    points, num = random_points(np.random.default_rng(3), jcfg, 2, 1800)
    want = jax.jit(jax_fn(jcfg, platform="cpu"))(variables, points, num)
    got = make_inference_fn(cfg, "cpu")(model, points, num)
    assert got.valid.sum() >= 20
    for b in range(2):
        wv, gv = np.asarray(want.valid[b]), got.valid[b].numpy()
        assert wv.sum() == gv.sum()
        w_scores = np.asarray(want.scores[b])[wv]
        g_scores = got.scores[b].numpy()[gv]
        wo, go = np.argsort(-w_scores), np.argsort(-g_scores)
        np.testing.assert_allclose(g_scores[go], w_scores[wo], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy()[gv][go],
                                   np.asarray(want.boxes[b])[wv][wo],
                                   rtol=0, atol=1e-4)


def test_without_orbax_the_reader_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(ImportError, match="orbax.checkpoint"):
        orbax_to_npz.read_variables(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        orbax_to_npz.item_dir(str(tmp_path))
