"""The initial weights of the JAX learning run
(`scripts/train_synthetic_smoke.py`: `create_train_state(cfg, tx,
jax.random.key(0))` under the script's config) as an .npz of JAX
variables with the run's decode knobs, which the port's learning run reads
with `--init-weights`, so that both start from the very same weights.

    python tests/torch_jax_init.py OUT.npz [--class-name Car] [--cfg YAML]
        [--key 0]

Needs JAX (it runs where the JAX package runs); the .npz it writes needs
only numpy to read. `--cfg` merges a YAML override file over the script's
config in both packages (small grids for the CPU tests); `--key N` draws
the init from `jax.random.key(N)` in place of the script's key(0), for the
spread over JAX's own init draws.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def jax_script_config(class_name: str = "Car", cfg_file: str | None = None,
                      score_thres: float = 0.5, yaw_encoding: str = "delta"):
    """The JAX script's config, then `cfg_file`'s overrides."""
    from voxelnet_tpu.config import get_config

    cfg = get_config(
        class_name,
        data={"max_points": 16384, "max_voxels": 8192, "max_gt_boxes": 8},
        rpn={"score_thres": score_thres},
        train={"yaw_encoding": yaw_encoding},
    )
    return cfg.merge_from_file(cfg_file) if cfg_file else cfg


def jax_script_state(jax_cfg, lr: float = 0.005, key: int = 0):
    """(TrainState, tx) of the JAX script at step 0: key(0) (or `key`),
    clip + SGD with momentum 0.9."""
    import jax
    import optax

    from voxelnet_tpu.training import create_train_state

    tx = optax.chain(optax.clip_by_global_norm(jax_cfg.train.gradient_clip),
                     optax.sgd(lr, momentum=0.9))
    return create_train_state(jax_cfg, tx, jax.random.key(key)), tx


def save_state_npz(path: str, state, class_name: str = "Car",
                   cfg_file: str | None = None) -> None:
    """Write a JAX TrainState's variables to `path` with the decode knobs
    of the port's learning-run config for the same flags."""
    import jax
    import numpy as np

    from voxelnet_tpu_torch import convert
    from voxelnet_tpu_torch.tools import synthetic_smoke

    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    convert.save_npz(path, variables,
                     synthetic_smoke.make_config(class_name,
                                                 cfg_file=cfg_file))


def write_init_npz(path: str, class_name: str = "Car",
                   cfg_file: str | None = None, key: int = 0) -> None:
    """Write the JAX script's initial variables (see save_state_npz)."""
    state, _ = jax_script_state(jax_script_config(class_name, cfg_file),
                                key=key)
    save_state_npz(path, state, class_name, cfg_file)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--class-name", default="Car",
                    choices=("Car", "Pedestrian", "Cyclist"))
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--key", type=int, default=0)
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_init_npz(args.out, args.class_name, args.cfg, args.key)
    print(args.out)


if __name__ == "__main__":
    main()
