"""Weight bridge between the JAX package's variables and the port's
state_dict.

The port's modules carry the flax module names, so a flax path
`params/<a>/<b>/<leaf>` maps to the torch key `<a>.<b>.<leaf'>`. Layouts:

  Dense kernel (cin, cout)              -> Linear weight .T
  Conv kernel HWIO / DHWIO              -> OIHW / OIDHW
  ConvTranspose kernel (kh, kw, ci, co) -> (ci, co, kh, kw), taps flipped
  BatchNorm scale / bias                -> weight / bias
  batch_stats mean / var                -> running_mean / running_var

Trees are nested dicts of numpy arrays; `save_npz`/`load_npz` store them
flattened under 'params/...' and 'batch_stats/...' keys, and the decode
knobs of the config the weights were trained with under 'meta/decode' (a
JSON string): `train.yaw_encoding` with the `object` and `rpn` settings
that decoding reads, as the port's checkpoints store them. A model trained
with `yaw_encoding='sin'` decodes wrong yaws under 'delta', so `load_npz`
refuses such a file when given the running config, and warns on a file
written without the knobs.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

META_KEY = "meta/decode"

_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_BN_PARAMS = {"scale": "weight", "bias": "bias"}


def _is_bn(module_name: str) -> bool:
    return module_name == "bn" or module_name.startswith("BatchNorm")


def _kernel_to_torch(kernel: np.ndarray, module_name: str) -> np.ndarray:
    if kernel.ndim == 2:
        return kernel.T
    if module_name.startswith("ConvTranspose"):
        return kernel[::-1, ::-1].transpose(2, 3, 0, 1)
    return np.moveaxis(kernel, (-1, -2), (0, 1))


def _kernel_to_jax(weight: np.ndarray, module_name: str) -> np.ndarray:
    if weight.ndim == 2:
        return weight.T
    if module_name.startswith("ConvTranspose"):
        return weight.transpose(2, 3, 0, 1)[::-1, ::-1]
    return np.moveaxis(weight, (0, 1), (-1, -2))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _insert(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} (numpy leaves) -> state_dict."""
    state = {}
    for path, leaf in _flatten(variables["params"]):
        mod, name = path[:-1], path[-1]
        arr = np.asarray(leaf, np.float32)
        if _is_bn(mod[-1]):
            name = _BN_PARAMS[name]
        elif name == "kernel":
            arr, name = _kernel_to_torch(arr, mod[-1]), "weight"
        state[".".join(mod + (name,))] = torch.from_numpy(
            np.ascontiguousarray(arr))
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        mod = ".".join(path[:-1])
        state[f"{mod}.{_BN_STATS[path[-1]]}"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaf, np.float32)))
        state[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return state


def to_jax_variables(state_dict) -> dict:
    """state_dict -> {'params': ..., 'batch_stats': ...} of numpy arrays."""
    out: dict = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _BN_STATS.items()}
    params = {v: k for k, v in _BN_PARAMS.items()}
    for key, tensor in state_dict.items():
        *mod, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        arr = tensor.detach().cpu().to(torch.float32).numpy()
        if name in stats:
            _insert(out["batch_stats"], (*mod, stats[name]), arr)
        elif _is_bn(mod[-1]):
            _insert(out["params"], (*mod, params[name]), arr)
        elif name == "weight":
            _insert(out["params"], (*mod, "kernel"),
                    np.ascontiguousarray(_kernel_to_jax(arr, mod[-1])))
        else:
            _insert(out["params"], (*mod, name), arr)
    return out


def decode_knobs(config_dict: dict) -> dict:
    """The settings of a config (as `to_dict()`) that decoding reads."""
    return {"yaw_encoding": config_dict["train"]["yaw_encoding"],
            "object": config_dict["object"], "rpn": config_dict["rpn"]}


def check_decode(knobs: dict, config, where: str) -> None:
    """Refuse weights whose yaw encoding differs from `config`'s: their
    regression maps would decode wrong."""
    want = config.train.yaw_encoding
    got = knobs["yaw_encoding"]
    if got != want:
        raise ValueError(
            f"{where} was trained with train.yaw_encoding={got!r}, the "
            f"running config has {want!r}: its regression maps would decode "
            "wrong")


def save_npz(path: str, variables, config=None) -> None:
    """Write `variables` flat; with `config`, its decode knobs too."""
    flat = {}
    for col in ("params", "batch_stats"):
        for p, leaf in _flatten(variables.get(col, {})):
            flat["/".join((col,) + p)] = np.asarray(leaf, np.float32)
    if config is not None:
        flat[META_KEY] = np.asarray(json.dumps(decode_knobs(
            config.to_dict())))
    np.savez(path, **flat)


def load_npz(path: str, config=None) -> dict:
    """-> {'params', 'batch_stats', 'meta'}: 'meta' holds the decode knobs
    the file was saved with, or None for a file written without them.
    With `config` (the running config): a file whose yaw encoding differs
    is refused, and a file without knobs loads with a warning."""
    out: dict = {"params": {}, "batch_stats": {}, "meta": None}
    with np.load(path) as z:
        for key in z.files:
            if key == META_KEY:
                out["meta"] = json.loads(str(z[key]))
            else:
                _insert(out, tuple(key.split("/")), z[key])
    if config is not None:
        if out["meta"] is None:
            warnings.warn(
                f"{path} holds no decode knobs (written without a config): "
                "its train.yaw_encoding cannot be checked, and weights "
                "trained with another encoding than the running config's "
                f"({config.train.yaw_encoding!r}) decode wrong yaws",
                stacklevel=2)
        else:
            check_decode(out["meta"], config, path)
    return out
