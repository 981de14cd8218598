"""Repairs of the port, each held on the CPU: the .npz weight bridge keeps
the decode knobs and refuses a yaw encoding that differs from the running
config's (in `convert.load_npz` and `cli.predict --weights`);
`distributed.initialize` without a device and without a card raises
instead of picking the CPU. (`compat.raster_collision` without cv2, once
refused here, runs on the numpy rasterizer: tests/test_torch_viz.py.)"""

import pytest
import torch
from torch_port_helpers import TINY, configs, jax_variables, merged

from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.parallel import distributed

SIN = merged(TINY, train={"yaw_encoding": "sin"})


@pytest.fixture(scope="module")
def variables():
    jcfg, _ = configs()
    return jax_variables(jcfg, seed=4)


def test_npz_keeps_its_decode_knobs(tmp_path, variables):
    cfg = get_config("Car", **SIN)
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, variables, cfg)
    back = convert.load_npz(path, cfg)
    assert back["meta"] == convert.decode_knobs(cfg.to_dict())
    assert back["meta"]["yaw_encoding"] == "sin"
    assert back["meta"]["object"]["x_max"] == 12.8
    state = convert.from_jax_variables(back)
    assert state.keys() == convert.from_jax_variables(variables).keys()


def test_npz_of_another_yaw_encoding_is_refused(tmp_path, monkeypatch,
                                                variables):
    from voxelnet_tpu_torch.cli import predict

    path = str(tmp_path / "w.npz")
    convert.save_npz(path, variables, get_config("Car", **SIN))
    delta = get_config("Car", **TINY)
    with pytest.raises(ValueError, match="yaw_encoding='sin'"):
        convert.load_npz(path, delta)
    monkeypatch.setattr(predict, "get_config", lambda name: delta)
    with pytest.raises(ValueError, match="decode wrong"):
        predict.main(["--pcl", "sample:0", "--device", "cpu", "--weights",
                      path])


def test_npz_without_knobs_warns(tmp_path, variables):
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, variables)
    assert convert.load_npz(path)["meta"] is None
    with pytest.warns(UserWarning, match="no decode knobs.*decode wrong"):
        convert.load_npz(path, get_config("Car", **TINY))


def test_initialize_without_a_card_needs_an_explicit_device(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init = "file://" + str(tmp_path / "rendezvous")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.initialize(init, 1, 0)
        assert not distributed.is_initialized()
    finally:
        distributed.shutdown()
