"""Weights from the seed, made on the device in one draw.

Every float parameter and buffer of `reference.net.param_specs` is a
slice of one uniform draw from a `torch.Generator` on the device, mapped
per leaf onto its range: weights He-uniform (+-sqrt(6 / fan_in)), biases
+-1/sqrt(fan_in), batch-norm scales U(0.5, 1.5), shifts and running
means U(-0.1, 0.1), running variances U(0.5, 1.5). The inference mixes
then `calibrate` the running statistics to the activations of the first
batch (so that the folded batch-norm keeps them near unit scale, as a
trained net's does) and shift the score head's bias so that the scores
cross the score gate where the mix asks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.reference import net as ref

# the regression head below He's scale, by delta (dx, dy, dz, dh, dw, dl,
# dyaw; both anchors of a cell): sizes spread by a few tenths, as a
# trained head's do (at He's scale their exp() decodes boxes tens of
# metres long), and centres and yaws stay within 0.1 m and 0.4 rad of the
# anchor's (the largest deltas read about 20 times the gain), which names
# the anchor a detection came from (harness/judge.py)
REG_GAIN = (0.001, 0.001, 0.2, 0.2, 0.2, 0.2, 0.02) * 2
# batch-norm leaves by kind -> (a, b): value = a * u + b, u ~ U(0, 1)
_AFFINE = {"bn_weight": (1.0, 0.5), "bn_bias": (0.2, -0.1),
           "bn_mean": (0.2, -0.1), "bn_var": (1.0, 0.5)}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make_params(cfg: dict, seed: int, device) -> dict:
    """name -> tensor on `device` (f32; int64 for the BN step counters)."""
    specs = ref.param_specs(cfg)
    floats = [(n, s) for n, s in specs.items() if s[1] != "bn_count"]
    sizes = [math.prod(shape) for _, (shape, _, _) in floats]
    a, b = [], []
    for name, (_, kind, fan) in floats:
        if kind == "weight":
            bound = ref.fan_scale(fan)
            a.append(2 * bound), b.append(-bound)
        elif kind == "bias":
            bound = 1.0 / math.sqrt(fan)
            a.append(2 * bound), b.append(-bound)
        else:
            a.append(_AFFINE[kind][0]), b.append(_AFFINE[kind][1])
    g = generator(seed, device)
    u = torch.rand(sum(sizes), generator=g, device=device)
    reps = torch.tensor(sizes, device=device)
    u = (u * torch.tensor(a, device=device).repeat_interleave(reps)
         + torch.tensor(b, device=device).repeat_interleave(reps))
    params = {}
    for (name, (shape, _, _)), leaf in zip(floats, u.split(sizes)):
        # a leaf of its own: views of one buffer share a version counter,
        # which autograd reads
        params[name] = leaf.view(shape).clone()
    gain = torch.tensor(REG_GAIN, device=device)
    params["rpn.reg_conv.weight"] *= gain[:, None, None, None]
    params["rpn.reg_conv.bias"] *= gain
    for name, (_, kind, _) in specs.items():
        if kind == "bn_count":
            params[name] = torch.zeros((), dtype=torch.int64, device=device)
    return {name: params[name] for name in specs}


def calibrate(cfg: dict, params: dict, points: np.ndarray,
              num_points: np.ndarray, seed: int, gate: dict, device):
    """Set every running statistic from the batch's own, perturbed (see
    reference.net.BN 'calibrate'), then add one shift to the score head's
    bias so that the median frame of the batch has gate['candidates']
    anchors over rpn.score_thres. -> the median frame's count of anchors
    over the gate at that shift, as the float32 reference reads it."""
    noise = generator(seed + 1, device)
    with torch.no_grad():
        cls, _ = ref.maps(cfg, params, points, num_points, device,
                          bn_mode="calibrate", noise=noise)
        logits = cls.reshape(cls.shape[0], -1)
        k = gate["candidates"]
        kth = logits.topk(k, dim=1).values[:, -1]
        thres = cfg["rpn"]["score_thres"]
        target = math.log(thres / (1 - thres))
        # just above the median frame's k-th logit's distance to the gate
        shift = target - float(kth.median()) + 1e-4
        params["rpn.prob_conv.bias"] += shift
        over = ((logits + shift) > target).sum(1)
    return int(over.median()), shift
