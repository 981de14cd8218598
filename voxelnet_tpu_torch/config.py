"""Configuration for the PyTorch port: the JAX package's own config, loaded
by file path, plus the port's backend resolver.

`voxelnet_tpu/config.py` imports only numpy (and yaml lazily), but importing
it through its package would run `voxelnet_tpu/__init__.py`, which a future
change may point at JAX modules. Loading the file by path keeps one config
for both packages without that risk. Overrides go through
`get_config(class_name, **overrides)`; `merge_from_file` needs pyyaml.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import NamedTuple

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "voxelnet_tpu", "config.py")
_NAME = "voxelnet_tpu_torch._reference_config"


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _SRC)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves string annotations through sys.modules
    sys.modules[_NAME] = mod
    spec.loader.exec_module(mod)
    return mod


_cfg = _load()
VoxelNetConfig = _cfg.VoxelNetConfig
ObjectConfig = _cfg.ObjectConfig
get_config = _cfg.get_config

MIDDLE_BACKENDS = ("auto", "conv3d", "folded2d", "tap2d", "sparse1",
                   "sparsebwd", "wpack", "wpack2")
BEV_FOLDS = ("auto", "transpose", "dsplit")
VFE_BACKENDS = ("auto", "xla", "fused")
DENSE_BUILDS = ("auto", "scatter", "pallas")
FOLD_BN = ("auto", "on", "off")


class Plan(NamedTuple):
    """What a config selects on the port's single inference path: the
    Conv3D middle (nn.Conv3d), the depth->BEV fold as a reshape of NCDHW,
    the fused VFE kernel and the streaming dense-grid kernel."""

    fold_bn: bool    # data.fold_bn: 'off' keeps the separate BN ops
    dtype: str       # train.compute_dtype


def _check(name: str, value: str, allowed: tuple[str, ...]) -> None:
    if value not in allowed:
        raise ValueError(f"data.{name}={value!r} — expected one of {allowed}")


def resolve_plan(config: VoxelNetConfig) -> Plan:
    """Map every accepted value of the JAX package's lowering knobs onto
    the port's one path.

    The JAX lowerings (`wpack2`, `folded2d`, `tap2d`, `dsplit`, ...) are
    the same math in TPU-friendly layouts; the port runs NCDHW convs, where
    the depth->BEV fold is a reshape. Raises where the port cannot give the
    configured semantics: the reference's ghost-activation VFE
    (`compat.bn_over_padding`, which the fused kernel does not implement,
    as `models/voxelnet.py::resolve_vfe_backend` refuses it too) and any
    mesh sharding (the port runs on one device).
    """
    data = config.data
    _check("middle_backend", data.middle_backend, MIDDLE_BACKENDS)
    _check("bev_fold", data.bev_fold, BEV_FOLDS)
    _check("vfe_backend", data.vfe_backend, VFE_BACKENDS)
    _check("dense_build", data.dense_build, DENSE_BUILDS)
    _check("fold_bn", data.fold_bn, FOLD_BN)
    if config.compat.bn_over_padding:
        raise ValueError(
            "compat.bn_over_padding (reference ghost-activation VFE) is not "
            "implemented by the fused VFE kernel")
    sys_cfg = config.system
    shards = (sys_cfg.num_data_shards * sys_cfg.num_model_shards
              * sys_cfg.num_dcn_shards)
    if shards > 1:
        raise ValueError(
            f"the port runs on one device; got {shards} mesh shards "
            "(system.num_data_shards/num_model_shards/num_dcn_shards)")
    if config.train.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(
            f"train.compute_dtype={config.train.compute_dtype!r} — expected "
            "'bfloat16' or 'float32'")
    return Plan(fold_bn=data.fold_bn != "off",
                dtype=config.train.compute_dtype)
