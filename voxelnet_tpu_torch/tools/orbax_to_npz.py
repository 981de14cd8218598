"""Convert a checkpoint of the JAX package (Orbax) into the .npz of JAX
variables that the port reads (`convert.load_npz`, `cli.predict
--weights`), with the decode knobs of the config it was trained with.

    python -m voxelnet_tpu_torch.tools.orbax_to_npz SRC DST
        [--class-name Car] [--cfg YAML]

SRC is any layout the JAX package's `training/checkpoint.py::
load_variables` reads: a `save_single` variables dir, a
`CheckpointManager` step dir (`.../checkpoints/<step>`, the TrainState
under `default/`) or its root (`.../checkpoints`, the latest step). The
tree to restore is built from the checkpoint's own metadata, as numpy
arrays of its shapes and dtypes, so a checkpoint written under a device
mesh restores too; only `params` and `batch_stats` are kept.

The decode knobs (`train.yaw_encoding`, `object`, `rpn`) come from
`--class-name` and `--cfg` (a YAML override file merged over the class's
preset) when either is given; else from the `config.yaml` of the JAX
experiment dir above SRC (its `object`, `rpn` and `train` sections),
when the port's YAML-subset reader can read them; else the .npz is
written without knobs, and `load_npz` warns when it loads it.

Needs `orbax.checkpoint` (imported here, when a checkpoint is read; it
imports JAX). Neither is on the card's machine: convert where the JAX
package runs, then serve the .npz on the card with `cli.predict
--weights DST`. Nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from voxelnet_tpu_torch import convert
from voxelnet_tpu_torch.config import VoxelNetConfig, get_config
from voxelnet_tpu_torch.utils import yaml_subset


def item_dir(path: str) -> str:
    """The Orbax item dir of SRC, as the JAX `load_variables` finds it."""
    p = os.path.abspath(path)
    if os.path.isdir(os.path.join(p, "default")):
        return os.path.join(p, "default")
    if os.path.exists(os.path.join(p, "_METADATA")):
        return p
    steps = (sorted(int(d) for d in os.listdir(p) if d.isdigit())
             if os.path.isdir(p) else [])
    if not steps:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    return os.path.join(p, str(steps[-1]), "default")


def _numpy_target(meta):
    """A restore target of numpy zeros shaped like the metadata tree."""
    if isinstance(meta, dict):
        return {k: _numpy_target(v) for k, v in meta.items()}
    if isinstance(meta, (list, tuple)):
        return type(meta)(_numpy_target(v) for v in meta)
    if meta is None:
        return None
    return np.zeros(meta.shape, meta.dtype)


def read_variables(path: str) -> dict:
    """{'params', 'batch_stats'} (numpy) of an Orbax checkpoint at SRC."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "reading an Orbax checkpoint needs orbax.checkpoint, which does "
            "not import here: convert where the JAX package runs, and carry "
            "the .npz") from e
    p = item_dir(path)
    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(p).item_metadata
    tree = getattr(meta, "tree", meta)
    raw = ckptr.restore(p, _numpy_target(dict(tree)))
    if "params" not in raw:
        raise ValueError(f"{p} holds no 'params' tree: {sorted(raw)}")
    return {"params": raw["params"], "batch_stats": raw.get("batch_stats",
                                                            {})}


_KNOB_SECTIONS = ("object", "rpn", "train")


def _sections(text: str, names) -> str:
    """The top-level blocks `names` of a YAML mapping's text."""
    out, keep = [], False
    for line in text.splitlines(keepends=True):
        if line[:1] not in ("", " ", "\t", "#", "\n"):
            keep = line.split(":", 1)[0] in names
        if keep:
            out.append(line)
    return "".join(out)


def exp_config(path: str) -> VoxelNetConfig | None:
    """The config of the JAX experiment dir above SRC (its config.yaml,
    one or two levels up from a checkpoints root or step dir), read for
    its decode knobs: the `object`, `rpn` and `train` sections, by the
    YAML-subset reader (the `calib` section's nested lists are outside
    the subset). None when there is no such file or the reader cannot
    read those sections."""
    p = os.path.abspath(path)
    for d in (p, os.path.dirname(p), os.path.dirname(os.path.dirname(p))):
        f = os.path.join(d, "config.yaml")
        if os.path.exists(f):
            with open(f) as fh:
                text = _sections(fh.read(), _KNOB_SECTIONS)
            try:
                tree = yaml_subset.load(text) or {}
                name = tree.get("object", {}).get("name", "Car")
                return VoxelNetConfig.from_dict(
                    dict(get_config(name).to_dict(), **tree))
            except (ValueError, KeyError, TypeError) as e:
                print(f"{f}: not read ({e}); writing without decode knobs")
                return None
    return None


def convert_checkpoint(src: str, dst: str,
                       config: VoxelNetConfig | None = None) -> dict:
    """SRC (Orbax) -> DST (.npz with `config`'s decode knobs, or the exp
    dir's, or none) -> the variables written."""
    variables = read_variables(src)
    config = config if config is not None else exp_config(src)
    convert.save_npz(dst, variables, config)
    return variables


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="Orbax checkpoint dir of the JAX package")
    ap.add_argument("dst", help=".npz to write")
    ap.add_argument("--class-name", default=None,
                    choices=("Car", "Pedestrian", "Cyclist"),
                    help="decode knobs of this class's preset")
    ap.add_argument("--cfg", default=None,
                    help="YAML override file merged over the preset "
                         "(--class-name, default Car) for the knobs")
    args = ap.parse_args(argv)
    config = None
    if args.class_name or args.cfg:
        config = get_config(args.class_name or "Car")
        if args.cfg:
            config = config.merge_from_file(args.cfg)
    convert_checkpoint(args.src, args.dst, config)
    print(args.dst)


if __name__ == "__main__":
    main()
