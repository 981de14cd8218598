"""Per-epoch checkpoints with resume, as `voxelnet_tpu/training/checkpoint.py`
(`CheckpointManager`, `load_variables`) without Orbax.

Layout: `<dir>/<step>/state.pt` and `<dir>/<step>/metrics.json`. A step dir
is written under a temporary name and renamed into place with `os.replace`,
so a killed run leaves no half checkpoint. `state.pt` (torch.save) holds
CPU copies of the model's state_dict (parameters and BN running stats),
the optimizer's update count and its momentum trace (None without
momentum), the train step, the metrics, the whole config dict, and the
decode knobs: `train.yaw_encoding` with the `object` and
`rpn` settings that decoding reads. The JAX package does not store them;
here `restore` and `load_variables` refuse a checkpoint whose yaw encoding
differs from the running config, whose decode would misread the
regression maps. `restore` also refuses an optimizer state that does not
fit the running optimizer: a momentum trace for an optimizer without
momentum, or the reverse.

Retention is Orbax's, as the JAX manager configures it (`max_to_keep=keep`,
`best_fn` = the `val_loss` metric or +inf, `best_mode='min'`): after each
save, when more than `keep` steps exist, only the `keep` best by val_loss
stay (on ties the later steps); steps saved without metrics always stay.

Several processes (parallel/distributed.py) share one directory: rank 0
writes each step and applies retention, then every rank waits at a
barrier, so none reads or restores a step before it is complete. Every
rank restores from the directory itself.
"""

from __future__ import annotations

import json
import math
import os
import shutil

import torch

from voxelnet_tpu_torch.convert import check_decode, decode_knobs
from voxelnet_tpu_torch.parallel import distributed
from voxelnet_tpu_torch.training.optim import OptState

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
_TMP_PREFIX = ".tmp-"


def _load(step_dir: str) -> dict:
    return torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                      weights_only=True)


def _val_loss(metrics: dict) -> float:
    return metrics.get("val_loss", math.inf)


class CheckpointManager:
    """Checkpoints of one run under `directory`; `config` is the running
    config (saved with each step, checked on restore)."""

    def __init__(self, directory: str, keep: int = 1000, *, config):
        self._dir = os.path.abspath(directory)
        self._keep = keep
        self._config = config
        os.makedirs(self._dir, exist_ok=True)
        if distributed.is_main():
            for name in os.listdir(self._dir):
                if name.startswith(_TMP_PREFIX):    # left by a killed save
                    shutil.rmtree(os.path.join(self._dir, name))

    def _steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self._dir) if d.isdigit())

    def _metrics(self, step: int) -> dict | None:
        path = os.path.join(self._dir, str(step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _by_quality(self) -> tuple[list[int], list[int]]:
        """(steps without metrics, steps with metrics worst to best): the
        order of Orbax's _sort_checkpoints_by_metrics (a stable sort)."""
        infos = [(s, self._metrics(s)) for s in self._steps()]
        without = [s for s, m in infos if m is None]
        with_metrics = sorted(((s, m) for s, m in infos if m is not None),
                              key=lambda sm: _val_loss(sm[1]), reverse=True)
        return without, [s for s, _ in with_metrics]

    def save(self, step: int, state, metrics: dict | None = None) -> None:
        """Write `state` (training/train_step.TrainState) as step `step`
        with `metrics`, then drop the steps retention no longer keeps: on
        rank 0, then a barrier of every rank."""
        if distributed.is_main():
            self._save(step, state, metrics)
        distributed.barrier()

    def _save(self, step: int, state, metrics: dict | None) -> None:
        final = os.path.join(self._dir, str(step))
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} exists in "
                                  f"{self._dir}")
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        config_dict = self._config.to_dict()
        payload = {
            "model": {k: v.detach().to("cpu", copy=True)
                      for k, v in state.model.state_dict().items()},
            "opt_count": int(state.opt_state.count),
            "opt_trace": (None if state.opt_state.trace is None else
                          [t.detach().to("cpu", copy=True)
                           for t in state.opt_state.trace]),
            "step": int(state.step),
            "metrics": metrics,
            "config": config_dict,
            "decode": decode_knobs(config_dict),
        }
        tmp = os.path.join(self._dir, f"{_TMP_PREFIX}{step}-{os.getpid()}")
        os.makedirs(tmp)
        try:
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump(metrics, f)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._remove_old()

    def _remove_old(self) -> None:
        """Orbax's BestN preservation policy (n = keep)."""
        without, ranked = self._by_quality()
        if len(without) + len(ranked) <= self._keep:
            return
        keep = set(without) | set(ranked[len(ranked) - self._keep:])
        for step in without + ranked:
            if step not in keep:
                shutil.rmtree(os.path.join(self._dir, str(step)))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        """The step with the least val_loss (the latest among ties); None
        when no step has metrics."""
        _, ranked = self._by_quality()
        return ranked[-1] if ranked else None

    def best_metric(self, key: str = "val_loss") -> float | None:
        """The best step's `key`, so a resumed trainer keeps its best val
        loss across the resume."""
        best = self.best_step()
        if best is None:
            return None
        v = self._metrics(best).get(key)
        return None if v is None else float(v)

    def restore(self, state, step: int | None = None):
        """Load step `step` (default the latest) into `state` in place:
        the model's parameters and buffers (on their device), the train
        step, the optimizer count and its momentum trace. Returns
        `state`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        step_dir = os.path.join(self._dir, str(step))
        saved = _load(step_dir)
        check_decode(saved["decode"], self._config, step_dir)
        trace = _fitting_trace(saved.get("opt_trace"), state.opt_state,
                               step_dir)
        state.model.load_state_dict(saved["model"])
        state.step = saved["step"]
        state.opt_state = OptState(count=saved["opt_count"], trace=trace)
        return state


def _fitting_trace(saved, running: OptState, where: str):
    """The saved momentum trace copied into the running one's tensors (in
    place, on their device), or None; raises when the saved optimizer
    state does not fit the running optimizer's."""
    if (saved is None) != (running.trace is None):
        has = "no momentum trace" if saved is None else "a momentum trace"
        raise ValueError(
            f"{where} holds {has}, the running optimizer has "
            f"{'one' if running.trace is not None else 'no momentum'}: its "
            "optimizer state does not fit")
    if saved is None:
        return None
    if len(saved) != len(running.trace) or any(
            s.shape != t.shape for s, t in zip(saved, running.trace)):
        raise ValueError(f"{where}: its momentum trace does not fit the "
                         "running model's parameters")
    for s, t in zip(saved, running.trace):
        t.copy_(s)
    return running.trace


def load_variables(path: str, config) -> dict[str, torch.Tensor]:
    """The model state_dict (CPU tensors) of a checkpoint step dir
    (`.../checkpoints/<step>`) or of a checkpoints root (its latest step),
    refused when its yaw encoding differs from `config`'s."""
    p = os.path.abspath(path)
    if not os.path.exists(os.path.join(p, STATE_FILE)):
        steps = (sorted(int(d) for d in os.listdir(p) if d.isdigit())
                 if os.path.isdir(p) else [])
        if not steps:
            raise FileNotFoundError(f"no checkpoint found under {path}")
        p = os.path.join(p, str(steps[-1]))
    saved = _load(p)
    check_decode(saved["decode"], config, p)
    return saved["model"]
