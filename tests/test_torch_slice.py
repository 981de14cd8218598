"""The port's inference slice as a whole (models/voxelnet.py
make_inference_fn) against the JAX inference graph with both Pallas kernels
in interpret mode, plus its config resolver, its CLI staging and its
independence from JAX."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, configs, jax_variables, merged,
                                random_points, torch_model)
from torch_port_helpers import two_torch_threads  # noqa: F401 (autouse)

from voxelnet_tpu_torch.config import (BEV_FOLDS, DENSE_BUILDS,
                                       MIDDLE_BACKENDS, VFE_BACKENDS,
                                       get_config, resolve_plan)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_whole_slice_matches_jax():
    from voxelnet_tpu.models.voxelnet import make_inference_fn as jax_fn
    from voxelnet_tpu_torch.models.voxelnet import make_inference_fn

    overrides = merged(TINY, data={"vfe_backend": "fused",
                                   "dense_build": "pallas"},
                       rpn={"score_thres": 0.0})
    jcfg, tcfg = configs(overrides=overrides)
    variables = jax_variables(jcfg, seed=11)
    rng = np.random.default_rng(11)
    points, num = random_points(rng, jcfg, 2, 1800)
    num[1] = 900
    want = jax.jit(jax_fn(jcfg, platform="cpu"))(variables, points, num)
    got = make_inference_fn(tcfg, "cpu")(torch_model(tcfg, variables),
                                         points, num)

    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    assert got.valid.sum() >= 20
    for b in range(2):
        wv = np.asarray(want.valid[b])
        gv = got.valid[b].numpy()
        w_scores = np.asarray(want.scores[b])[wv]
        g_scores = got.scores[b].numpy()[gv]
        wo, go = np.argsort(-w_scores), np.argsort(-g_scores)
        # f32 end to end (bf16 only at the VFE output, as in JAX): scores
        # differ by up to 6e-8 and boxes by up to 1e-6 m (measured), where
        # the scores themselves spread by ~1.6e-4
        np.testing.assert_allclose(g_scores[go], w_scores[wo], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy()[gv][go],
                                   np.asarray(want.boxes[b])[wv][wo],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("key,values", [
    ("middle_backend", MIDDLE_BACKENDS), ("bev_fold", BEV_FOLDS),
    ("vfe_backend", VFE_BACKENDS), ("dense_build", DENSE_BUILDS)])
def test_resolver_maps_every_lowering_to_one_path(key, values):
    """Every value the JAX package accepts for a lowering knob resolves to
    the port's one path: the same plan as the defaults, but for
    middle_backend='sparse1', which differs in the middle alone
    (tests/test_torch_sparse1.py)."""
    want = resolve_plan(get_config("Car"))
    assert want == (True, "bfloat16", 1, 0, "conv3d")
    for value in values:
        got = resolve_plan(get_config("Car", data={key: value}))
        assert got == (want._replace(middle="sparse1") if value == "sparse1"
                       else want)
    assert resolve_plan(get_config("Car", data={"fold_bn": "off"})) == (
        False, "bfloat16", 1, 0, "conv3d")


@pytest.mark.parametrize("overrides,match", [
    # the fused kernel has only the masked max: an explicit request for it
    # with the reference's ghost-activation VFE is refused, as in JAX
    ({"compat": {"bn_over_padding": True}, "data": {"vfe_backend": "fused"}},
     "bn_over_padding"),
    ({"system": {"num_data_shards": 4}}, "no torch.distributed process"),
    ({"data": {"middle_backend": "nope"}}, "middle_backend"),
    ({"data": {"bev_fold": "nope"}}, "bev_fold"),
    ({"train": {"compute_dtype": "float16"}}, "compute_dtype"),
])
def test_resolver_refuses(overrides, match):
    with pytest.raises(ValueError, match=match):
        resolve_plan(get_config("Car", **overrides))


@pytest.mark.parametrize("middle", ["conv3d", "sparse1"])
def test_resolver_accepts_a_model_axis(monkeypatch, middle):
    """`system.num_model_shards: 2` (spatial W-sharding) resolves under a
    2-process group, for both middles: rank 1 is model index 1 of the one
    model group, data index 0, and the data group is itself alone. The
    groups are made (here a stand-in for torch's new_group) in the same
    order on every rank: data groups, then model groups."""
    from voxelnet_tpu_torch.parallel import distributed, mesh

    made = []
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    monkeypatch.setattr(distributed, "_handles", {})
    monkeypatch.setattr(distributed.dist, "new_group",
                        lambda ranks: made.append(ranks))
    cfg = get_config("Car", system={"num_model_shards": 2},
                     data={"middle_backend": middle})
    assert resolve_plan(cfg, train=True) == (True, "bfloat16", 2, 1, middle)
    got = mesh.process_mesh(cfg.system)
    assert got[:5] == (2, 1, 2, 0, 1)
    assert got.data_group == ("data", (1,))
    assert got.model_group == ("model", (0, 1))
    assert got.process_shard() is None
    assert got.local_num_real(3, 4) == 3
    assert made == [[0, 1]]     # once: groups of one need no torch group


def test_stage_points_matches_jax_pipeline():
    from voxelnet_tpu.ops.voxelize import VoxelGridSpec, in_grid_mask, pad_points
    from voxelnet_tpu_torch.cli.predict import stage_points
    from voxelnet_tpu_torch.data.sample import sample_frames

    jcfg, tcfg = configs()
    frames = [f[:20000] for f in sample_frames()]
    points, num = stage_points(frames, tcfg, np.random.default_rng(0))
    spec = VoxelGridSpec.from_object_config(jcfg.object)
    rng = np.random.default_rng(0)
    for i, f in enumerate(frames):
        want, n = pad_points(f[in_grid_mask(f, spec)], jcfg.data.max_points,
                             rng=rng, shuffle=True)
        np.testing.assert_array_equal(points[i], want)
        assert num[i] == n


def test_port_imports_no_jax():
    """The package, its CLIs, its train step, trainer, checkpoints,
    evaluator, dataset, data parallelism, viz, data tools, reference API
    and Orbax converter, the benchmark and the chip smoke script load
    without JAX, flax, optax or orbax and without any module of the
    JAX package, under its name or loaded from a file under voxelnet_tpu/,
    with yaml and cv2 unimportable (the card's machine has neither).
    conftest.py has imported JAX here, so check in a subprocess."""
    code = ("import os, sys, runpy\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('yaml', 'cv2'):\n"
            "            raise ImportError(f'{name} is blocked')\n"
            "sys.meta_path.insert(0, Block())\n"
            "import voxelnet_tpu_torch.cli.predict\n"
            "import voxelnet_tpu_torch.cli.train\n"
            "import voxelnet_tpu_torch.cli.eval\n"
            "import voxelnet_tpu_torch.convert\n"
            "import voxelnet_tpu_torch.data.dataset\n"
            "import voxelnet_tpu_torch.data.pipeline\n"
            "import voxelnet_tpu_torch.training.train_step\n"
            "import voxelnet_tpu_torch.training.trainer\n"
            "import voxelnet_tpu_torch.training.checkpoint\n"
            "import voxelnet_tpu_torch.training.evaluate\n"
            "import voxelnet_tpu_torch.parallel.distributed\n"
            "import voxelnet_tpu_torch.parallel.mesh\n"
            "import voxelnet_tpu_torch.parallel.spatial\n"
            "import voxelnet_tpu_torch.native\n"
            "import voxelnet_tpu_torch.tools.synthetic_smoke\n"
            "import voxelnet_tpu_torch.tools.dump_report\n"
            "import voxelnet_tpu_torch.tools.orbax_to_npz\n"
            "import voxelnet_tpu_torch.reference_api\n"
            "import voxelnet_tpu_torch.utils.viz\n"
            "import voxelnet_tpu_torch.utils.raw_drive\n"
            "import voxelnet_tpu_torch.data.raw_to_kitti\n"
            "import voxelnet_tpu_torch.data.preprocess\n"
            "import voxelnet_tpu_torch.data.split\n"
            "import voxelnet_tpu_torch.bench\n"
            "import voxelnet_tpu_torch.tools.card\n"
            "import voxelnet_tpu_torch.tools.profile_step\n"
            "import voxelnet_tpu_torch.graft_entry\n"
            "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
            "from voxelnet_tpu_torch.config import get_config\n"
            "get_config('Car').dump_yaml()\n"
            "ref = os.path.join(os.path.realpath('voxelnet_tpu'), '')\n"
            "def from_ref(mod):\n"
            "    f = getattr(mod, '__file__', None)\n"
            "    return bool(f) and os.path.realpath(f).startswith(ref)\n"
            "bad = [m for m, mod in list(sys.modules.items())\n"
            "       if m.split('.')[0] in ('jax', 'flax', 'jaxlib', 'optax',\n"
            "                              'orbax', 'yaml', 'cv2',\n"
            "                              'voxelnet_tpu')\n"
            "       or from_ref(mod)]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_predict_cli_on_cpu(monkeypatch, tmp_path, capsys):
    """The CLI end to end at the tiny grid, with weights from a JAX
    variables .npz; `--device cuda` without a card refuses to run."""
    from voxelnet_tpu_torch import convert
    from voxelnet_tpu_torch.cli import predict

    jcfg, tcfg = configs(overrides=merged(TINY, rpn={"score_thres": 0.0}))
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, jax_variables(jcfg, seed=5))
    monkeypatch.setattr(predict, "get_config", lambda name: tcfg)
    predict.main(["--pcl", "sample:1", "--device", "cpu", "--weights",
                  path])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "sample:1: 20 detections"
    assert len(out) == 21 and out[1].startswith("  score=")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            predict.main(["--pcl", "sample:0", "--device", "cuda"])
