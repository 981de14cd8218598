#!/usr/bin/env python3
"""Readings behind the limits of `benchmarks/limits/<workload>.json`, on
the card, in one process per cell (the benchmark's own runs never run
this):

    python3 benchmarks/calibrate.py --workload car-infer-b8 \\
        --seeds 101 102 ... --control-seeds 201 202 203 --calls 16

For each --seeds seed: the cell's set-up, --calls calls of its window
(inference) or its three checked steps (training), and the comparison,
as a run makes them -> the program's numbers. For each --control-seeds
seed the control, the reference put in the program's place and computed
in the next precision below the configuration's bfloat16 (float8: e4m3
values, e5m2 gradients, one scale a tensor, `reference.net.fp8`), read
by the same comparison; for an inference cell also a planted decoding
fault (centre offsets scaled by the anchor's length, not its diagonal),
for a training cell its faults 'half of the batch left out, the mean
over the rest' and 'a step that changes nothing', planted in the
reference. One JSON line a reading; with --diagnose also each training
leaf's direction gaps, and the reference in bfloat16 and in float8 with
float32 gradients beside the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_outputs(cell, params, batch, quant, decode=None):
    """The reference in the program's place: its maps with `quant`, its
    decode (or `decode`) and NMS -> (B, post_topk, 9) rows as a call's
    output."""
    import torch

    from benchmarks.reference import detect
    from benchmarks.reference import net as ref

    cfg, dev = cell.cfg, cell.device
    cls, reg = ref.maps(cfg, params, *batch, dev, quant=quant)
    B = cls.shape[0]
    anc = detect.anchors(cfg, dev)
    scores = torch.sigmoid(cls.reshape(B, -1))
    boxes = (decode or detect.decode)(reg.reshape(B, -1, 7), anc, cfg)
    post = cfg["rpn"]["nms_post_topk"]
    out = torch.zeros((B, post, 9), device=dev)
    for b in range(B):
        kb, ks, _ = detect.nms(boxes[b], scores[b], cfg)
        n = len(ks)
        out[b, :n, :7], out[b, :n, 7], out[b, :n, 8] = kb, ks, 1.0
    return out.cpu()


def decode_by_length(deltas, anc, cfg):
    """A decoding fault: the centre offsets scaled by the anchor's length
    and not by its bird's-eye diagonal."""
    import torch

    from benchmarks.reference import detect

    boxes = detect.decode(deltas, anc, cfg)
    diag = torch.sqrt(anc[:, 4] ** 2 + anc[:, 5] ** 2)
    scale = (anc[:, 5] / diag)[:, None]
    xy = anc[:, :2] + (boxes[..., :2] - anc[:, :2]) * scale
    return torch.cat([xy, boxes[..., 2:]], -1)


def fp8_forward(x):
    """float8 e4m3 values with float32 gradients (a diagnostic)."""
    from benchmarks.reference import net as ref

    return x + (ref.fp8(x.detach()) - x).detach()


def reference_steps(cell, driver, quant=None, frames=None,
                    lr=None) -> dict:
    from benchmarks.harness import weights
    from benchmarks.reference import train as ref_train

    params = weights.make_params(cell.cfg, cell.seed, cell.device)
    names = driver.names
    got = {"losses": [], "p0": {n: params[n].clone() for n in names}}
    for i in range(3):
        got["losses"].append(ref_train.step(
            cell.cfg, params, *driver.pool[i],
            driver.lr if lr is None else lr, cell.device,
            quant=quant, frames=frames))
        if i == 0:
            got["p1"] = {n: params[n].clone() for n in names}
    got["p3"] = {n: params[n] for n in names}
    return got


def diagnose_maps(cell, driver) -> dict:
    """The program's maps (make_maps_fn on the set-up's model) and the
    reference's, f32 and with bf16 inputs and weights, on pool batch 0
    -> quantiles of their differences."""
    import torch

    from benchmarks.harness import core
    from benchmarks.reference import net as ref
    from voxelnet_tpu_torch.models.voxelnet import make_maps_fn

    dev = cell.device
    pts, num = driver.pool[0]
    fn = make_maps_fn(core.port_config(cell.cfg), dev)
    prog = fn(driver.model, torch.from_numpy(pts).to(dev),
              torch.from_numpy(num).to(dev))
    params = {k: v.to(dev) for k, v in driver.params.items()}
    f32 = ref.maps(cell.cfg, params, pts, num, dev)
    b16 = ref.maps(cell.cfg, params, pts, num, dev, quant=ref.bf16)
    out = {}
    for name, a, b in (("prog-f32", prog, f32), ("bf16-f32", b16, f32),
                       ("prog-bf16", prog, b16)):
        for i, head in enumerate(("cls", "reg")):
            d = (a[i].float() - b[i]).abs().flatten()
            q = torch.quantile(d[:: max(1, len(d) // 1_000_000)],
                               torch.tensor([0.5, 0.99, 0.9999],
                                            device=dev))
            out[f"{name}.{head}"] = [float(x) for x in q] + [
                float(d.max()), float(b[i].std())]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=16)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--diagnose", action="store_true",
                    help="print the maps' differences (inference) or each "
                         "leaf's direction gaps (training) beside each "
                         "reading")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmarks.harness import core, judge
    from benchmarks.reference import net as ref

    def emit(**kw):
        print(json.dumps(dict(workload=args.workload, **kw)), flush=True)

    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            cell = core.load_cell(ROOT, args.workload, seed, args.device)
            gen = core.load_module(os.path.join(
                ROOT, "benchmarks", "traffic", f"{cell.mix['kind']}.py"),
                f"bench_traffic_{cell.mix['kind']}")
            driver = gen.Driver(cell)
            if kind == "program" and args.diagnose and not driver.train:
                emit(kind="maps", seed=seed, numbers=diagnose_maps(cell,
                                                                   driver))
            if kind == "program" and not driver.train:
                for i in range(args.calls):
                    driver.call(i)
                driver.release()
                emit(kind=kind, seed=seed, gate=driver.gate_count,
                     numbers=driver.judge())
            elif kind == "program":
                driver.release()
                want = reference_steps(cell, driver)
                emit(kind=kind, seed=seed, numbers=judge.train_numbers(
                    driver.checked, want, driver.lr, leaves=args.diagnose))
            elif not driver.train:
                driver.release()
                params = {k: v.to(cell.device)
                          for k, v in driver.params.items()}
                for name, kw in (("control", {"quant": ref.fp8}),
                                 ("decode_by_length",
                                  {"quant": None,
                                   "decode": decode_by_length})):
                    driver.outputs = [
                        (i, control_outputs(cell, params, driver.pool[i],
                                            **kw))
                        for i in range(cell.mix["check_calls"])]
                    emit(kind=name, seed=seed, numbers=driver.judge())
            else:
                driver.release()
                full = reference_steps(cell, driver)
                for name, kw in (("control", {"quant": ref.fp8}),
                                 ("half_batch", {"frames": list(range(
                                     driver.frames_per_call // 2))}),
                                 ("unchanged", {"lr": 0.0}),
                                 ("bf16_reference", {"quant": ref.bf16}),
                                 ("fp8_forward", {"quant": fp8_forward})):
                    if (name in ("bf16_reference", "fp8_forward")
                            and not args.diagnose):
                        continue
                    got = reference_steps(cell, driver, **kw)
                    emit(kind=name, seed=seed, numbers=judge.train_numbers(
                        got, full, driver.lr, leaves=args.diagnose))
            del driver
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
