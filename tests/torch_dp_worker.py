"""Cases of the port's data-parallel tests (tests/test_torch_parallel.py),
and the worker process that runs them in a gloo process group.

    python tests/torch_dp_worker.py JOB RANK

JOB is a torch.save'd dict: `world`, `init` (a file:// rendezvous), and
`cases`, name -> (case, keyword arguments). The worker joins the group as
RANK on the CPU, runs every case on its contiguous rows of each global
input and saves name -> result to `<JOB>.out<RANK>`. A test runs the same
case functions in its own process, with no group, on the whole batch: the
one-process reference. Imports torch and the port only.
"""

from __future__ import annotations

import os
import sys

import torch

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.models.bn import flax_batch_norm
from voxelnet_tpu_torch.models.voxelnet import VoxelNet
from voxelnet_tpu_torch.parallel import distributed
from voxelnet_tpu_torch.training.optim import ClippedSGD, OptState
from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

TIMEOUT_S = 100.0


def rows(x, batch: int):
    """This process's contiguous rows of a global array of `batch` rows."""
    local = batch // distributed.world_size()
    lo = distributed.rank() * local
    return x[lo:lo + local]


def config(overrides: dict):
    """The Car config of `overrides`, its data axis the running world."""
    system = {"num_data_shards": distributed.world_size()}
    return get_config("Car", **dict(overrides, system=system))


def allreduce_case() -> dict:
    """x = rank + 1; y = all_reduce_sum(x^2) and the gradient of x from
    this rank's backward of y."""
    x = torch.tensor(distributed.rank() + 1.0, dtype=torch.float64,
                     requires_grad=True)
    y = distributed.all_reduce_sum(x * x)
    y.backward()
    return {"y": float(y), "grad": float(x.grad)}


def bn_case(x, w, bn_state, channel_dim, mask=None) -> dict:
    """flax_batch_norm in train mode on this process's rows of the f64 x
    (B, ..., C), and the backward of sum(y * w): y, x's gradient, the BN
    affine's gradient (this process's part of it) and the running stats."""
    b = x.shape[0]
    c = x.shape[channel_dim]
    bn = torch.nn.BatchNorm1d(c).double().train()
    bn.load_state_dict(bn_state, strict=False)
    xl = rows(x, b).clone().requires_grad_()
    y = flax_batch_norm(bn, xl, channel_dim,
                        None if mask is None else rows(mask, b))
    (y.double() * rows(w, b)).sum().backward()
    return {"y": y.detach(), "x_grad": xl.grad,
            "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def step_case(overrides, state_dict, batch, double=False,
              steps_per_epoch=10, momentum=None, steps=1) -> dict:
    """`steps` make_train_step calls on this process's rows of `batch`
    (numpy, global) from `state_dict` (the model in f64 when `double`):
    metrics of the last, the state_dict after them, and how many ranks
    disagree with rank 0 on it afterwards. With `momentum`, the optimizer
    keeps a trace, which starts as a resumed run's would, different on
    each rank until broadcast_state_ gives every rank rank 0's; the
    traces are returned and held bit-identical across ranks too."""
    cfg = config(overrides)
    model = VoxelNet(cfg)
    model.load_state_dict(state_dict)
    if double:
        model.double()
    optimizer = (None if momentum is None else
                 ClippedSGD(cfg, steps_per_epoch, momentum=momentum))
    state = create_train_state(cfg, model, device="cpu", optimizer=optimizer)
    if momentum is not None:
        gen = torch.Generator().manual_seed(100 + distributed.rank())
        state.opt_state = OptState(count=0, trace=tuple(
            1e-3 * torch.randn(t.shape, generator=gen, dtype=t.dtype)
            for t in state.opt_state.trace))
    distributed.broadcast_state_(state.model, state.opt_state)
    b = batch["points"].shape[0]
    local = {k: rows(v, b) for k, v in batch.items()}
    step = make_train_step(cfg, "cpu", steps_per_epoch, optimizer=optimizer)
    for _ in range(steps):
        state, metrics = step(state, local)
    trace = state.opt_state.trace
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "trace": None if trace is None else [t.clone() for t in trace],
            "disagree": distributed.ranks_disagree(state.model,
                                                   state.opt_state)}


def trainer_case(overrides, data, exp_dir, state_dict,
                 double=True) -> dict:
    """One Trainer run (every epoch of the config, label dumps on) from
    `state_dict` (the model in f64 when `double`): best val loss and step,
    the step count, the state_dict after it and the number of frames this
    process dumped a label file for, per epoch."""
    from voxelnet_tpu_torch.training.trainer import Trainer

    cfg = config(overrides)
    with Trainer(cfg, os.path.join(data, "training"),
                 os.path.join(data, "validation"), exp_dir=exp_dir,
                 device="cpu") as tr:
        tr.state.model.load_state_dict(state_dict)
        if double:
            tr.state.model.double()
        tr.train(print_interval=1000, summary_interval=1000,
                 val_interval=1000)
        return {"best_metric": tr.ckpt.best_metric(),
                "best_step": tr.ckpt.best_step(), "step": tr.state.step,
                "state": {k: v.detach().clone()
                          for k, v in tr.state.model.state_dict().items()},
                "dumped": tr.timings["val_dump_frames"],
                "disagree": distributed.ranks_disagree(tr.state.model)}


CASES = {"allreduce": allreduce_case, "bn": bn_case, "step": step_case,
         "trainer": trainer_case}


def run_cases(cases: dict) -> dict:
    return {name: CASES[case](**kw) for name, (case, kw) in cases.items()}


def main(job_path: str, rank: int) -> None:
    torch.set_num_threads(2)
    job = torch.load(job_path, weights_only=False)
    distributed.initialize(job["init"], job["world"], rank, device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        out = run_cases(job["cases"])
    finally:
        distributed.shutdown()
    torch.save(out, f"{job_path}.out{rank}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
