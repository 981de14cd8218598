"""Training on one's own drives: one caller, closed loop. Each call
uploads one batch of the pool (points and GT boxes) from pinned host
memory and runs one step of the program's `make_train_step` on the state
of `create_train_state` with `make_optimizer`'s optimizer.

Set-up builds that one state and drives it through its first three
steps by the window's own call, on pool batches 0-2 (rows that all
differ), keeping the parameters before and after the first step and
after the third; the window goes on from the fourth. After the window
the reference follows the same three steps from the same weights.

Mix parameters: batch, pool_batches, rotation_deg, flip, drop, frames
(as offline_infer), steps_per_epoch (the optimizer's schedule),
trace_calls.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmarks.harness import core, frames, judge, weights
from benchmarks.reference import train as ref_train

CHECKED_STEPS = 3


class Driver:
    train = True

    def __init__(self, cell: core.Cell):
        from voxelnet_tpu_torch.models.voxelnet import VoxelNet
        from voxelnet_tpu_torch.training.optim import make_optimizer
        from voxelnet_tpu_torch.training.train_step import (
            TRAIN_STAGES, create_train_state, make_train_step)

        phase = core.Phases()
        self.cell, mix, dev = cell, cell.mix, cell.device
        self.stages = TRAIN_STAGES
        self.frames_per_call = mix["batch"]
        rng = np.random.default_rng([cell.seed, 1])
        sweeps = frames.load_sweeps(os.path.join(cell.root, mix["frames"]))
        self.pool = [batch + frames.gt_boxes(cell.cfg, cell.labels,
                                             mix["batch"], rng)
                     for batch in frames.batch_pool(sweeps, cell.cfg, mix,
                                                    rng)]
        keys = ("points", "num_points", "gt_boxes", "gt_mask")
        self.pinned = [{k: (torch.from_numpy(a).pin_memory()
                            if dev.type == "cuda" else torch.from_numpy(a))
                        for k, a in zip(keys, batch)} for batch in self.pool]
        phase("inputs")
        config = core.port_config(cell.cfg)
        model = VoxelNet(config)
        model.load_state_dict(weights.make_params(cell.cfg, cell.seed, dev))
        optimizer = make_optimizer(config, mix["steps_per_epoch"])
        self.lr = optimizer.schedule(0)
        self.state = create_train_state(config, model, device=dev,
                                        optimizer=optimizer)
        self.step = make_train_step(config, dev, optimizer=optimizer)
        self.losses: list = []
        self.metrics: list = []
        # the leaves, and the batch-norms' running statistics that the
        # step moves
        self.names = [n for n, _ in self.state.model.named_parameters()] + [
            n for n, _ in self.state.model.named_buffers()
            if n.endswith(judge.STATS)]
        phase("weights and program")
        snaps = {"p0": self.params()}
        for i in range(CHECKED_STEPS):
            self.call(i)
            snaps[f"p{i + 1}"] = self.params()
        self.checked = {"losses": [{k: float(m[k]) for k in judge.TERMS}
                                   for m in self.metrics],
                        "p0": snaps["p0"], "p1": snaps["p1"],
                        "p3": snaps[f"p{CHECKED_STEPS}"]}
        self.losses = []
        self.next_call = CHECKED_STEPS
        phase("first steps")
        phase.report()

    def params(self) -> dict:
        state = self.state.model.state_dict()
        return {n: state[n].detach().clone() for n in self.names}

    def pool_index(self, i: int) -> int:
        return i % len(self.pool)

    def call(self, i: int, marks=None):
        dev = self.cell.device
        batch = {k: t.to(dev, non_blocking=True)
                 for k, t in self.pinned[self.pool_index(i)].items()}
        self.state, metrics = self.step(self.state, batch, marks)
        self.losses.append(metrics["loss"])
        if i < CHECKED_STEPS:
            self.metrics.append(metrics)

    def finish(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def end_to_end(self, elapsed: float) -> dict:
        return {"train_fps": len(self.losses) * self.frames_per_call
                / elapsed}

    def release(self):
        del self.state, self.step
        self.losses = []
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> dict:
        """The reference's first three steps from the same weights on the
        same batches -> judge.train_numbers."""
        cell, dev = self.cell, self.cell.device
        params = weights.make_params(cell.cfg, cell.seed, dev)
        names = self.names
        ref = {"losses": [], "p0": {n: params[n].clone() for n in names}}
        for i in range(CHECKED_STEPS):
            ref["losses"].append(ref_train.step(
                cell.cfg, params, *self.pool[i], self.lr, dev))
            if i == 0:
                ref["p1"] = {n: params[n].clone() for n in names}
        ref["p3"] = {n: params[n] for n in names}
        return judge.train_numbers(self.checked, ref, self.lr)
