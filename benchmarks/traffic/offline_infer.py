"""Offline labelling of recorded drives: one caller, closed loop. Each
call uploads one batch of the pool from pinned host memory, runs the
program's `make_inference_fn` and copies the detections to the host.

Mix parameters: batch, pool_batches, rotation_deg, flip, drop (the
pool, see harness/frames.py), frames (the sweeps' directory in the
checkout), gate_candidates (anchors over the score gate in the first
batch's median frame, set by the score head's bias), warmup_calls,
trace_calls, check_calls (calls of the window judged against the
reference).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmarks.harness import core, frames, judge, weights
from benchmarks.reference import detect
from benchmarks.reference import net as ref


class Driver:
    train = False

    def __init__(self, cell: core.Cell):
        from voxelnet_tpu_torch.models.voxelnet import (STAGES, VoxelNet,
                                                        make_inference_fn)

        phase = core.Phases()
        self.cell, mix, dev = cell, cell.mix, cell.device
        self.stages = STAGES
        self.frames_per_call = mix["batch"]
        rng = np.random.default_rng([cell.seed, 1])
        sweeps = frames.load_sweeps(os.path.join(cell.root, mix["frames"]))
        self.pool = frames.batch_pool(sweeps, cell.cfg, mix, rng)
        self.pinned = [tuple(torch.from_numpy(a).pin_memory()
                             if dev.type == "cuda" else torch.from_numpy(a)
                             for a in batch) for batch in self.pool]
        phase("inputs")
        params = weights.make_params(cell.cfg, cell.seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phase("weights")
        t0 = time.perf_counter()
        self.gate_count, _ = weights.calibrate(
            cell.cfg, params, *self.pool[0], cell.seed,
            {"candidates": mix["gate_candidates"]}, dev)
        # the reference's pass that sets the weights' statistics: the
        # benchmark's own work, which set-up's time leaves out
        self.untimed_s = time.perf_counter() - t0
        # the reference's copy of the weights, kept off the card
        self.params = {k: v.cpu() for k, v in params.items()}
        phase("calibration (left out of setup_s)")
        config = core.port_config(cell.cfg)
        self.model = VoxelNet(config)
        self.model.load_state_dict(params)
        del params
        self.model = self.model.to(dev).eval()
        self.infer = make_inference_fn(config, dev)
        phase("program")
        self.outputs: list = []
        self.latency: list = []
        for i in range(mix["warmup_calls"]):
            self.call(i)
        self.outputs, self.latency = [], []
        self.next_call = 0
        phase("warm-up")
        phase.report()

    def pool_index(self, i: int) -> int:
        return i % len(self.pool)

    def call(self, i: int, marks=None):
        t0 = time.perf_counter()
        pts, num = self.pinned[self.pool_index(i)]
        dev = self.cell.device
        det = self.infer(self.model, pts.to(dev, non_blocking=True),
                         num.to(dev, non_blocking=True), marks)
        out = torch.cat([det.boxes, det.scores[..., None],
                         det.valid[..., None].to(det.scores.dtype)],
                        -1).cpu()
        self.latency.append(time.perf_counter() - t0)
        self.outputs.append((i, out))

    def finish(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def failed(self) -> int:
        return sum(int(not torch.isfinite(o).all()) for _, o in self.outputs)

    def end_to_end(self, elapsed: float) -> dict:
        return {"infer_fps": len(self.outputs) * self.frames_per_call
                / elapsed,
                "infer_p95_ms": 1e3 * float(np.percentile(self.latency, 95))}

    def release(self):
        del self.model, self.infer
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> dict:
        """The sampled calls' detections against the reference's maps of
        the same batches, frame by frame -> the widest gaps and the NMS
        faults summed over the frames."""
        cell, dev = self.cell, self.cell.device
        pick = core.sample_calls(len(self.outputs), cell.mix["check_calls"],
                                 cell.seed)
        params = {k: v.to(dev) for k, v in self.params.items()}
        anc = detect.anchors(cell.cfg, dev)
        worst = {"reg_gap": 0.0, "logit_gap": 0.0, "nms_faults": 0}
        implied, want = [], []
        for j in pick:
            i, out = self.outputs[j]
            pts, num = self.pool[self.pool_index(i)]
            cls, reg = ref.maps(cell.cfg, params, pts, num, dev)
            B = cls.shape[0]
            for b in range(B):
                got = judge.detections_numbers(
                    out[b].to(dev), reg[b].reshape(-1, 7),
                    cls[b].reshape(-1), anc, cell.cfg)
                worst = {"reg_gap": max(worst["reg_gap"], got["reg_gap"]),
                         "logit_gap": max(worst["logit_gap"],
                                          got["logit_gap"]),
                         "nms_faults": worst["nms_faults"]
                         + got["nms_faults"]}
                implied.append(got["implied"])
                want.append(got["want"])
        worst["reg_scale_gap"] = judge.reg_scale_gap(torch.cat(implied),
                                                     torch.cat(want))
        return worst
