"""Cases of the port's data-parallel and spatial-sharding tests
(tests/test_torch_parallel.py, tests/test_torch_spatial.py), and the worker
process that runs them in a gloo process group.

    python tests/torch_dp_worker.py JOB RANK

JOB is a torch.save'd dict: `world`, `init` (a file:// rendezvous), and
`cases`, name -> (case, keyword arguments). The worker joins the group as
RANK on the CPU, runs every case on its contiguous rows of each global
input (the rows of its data index where a case has a model axis) and saves
name -> result to `<JOB>.out<RANK>`. A test runs the same case functions
in its own process, with no group, on the whole batch: the one-process
reference. Imports torch and the port only.
"""

from __future__ import annotations

import os
import sys

import torch
from torch.nn import functional as F

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.models.bn import flax_batch_norm
from voxelnet_tpu_torch.models.middle import ConvBlock3D
from voxelnet_tpu_torch.models.rpn import ConvBNReLU, DeconvBNReLU
from voxelnet_tpu_torch.models.voxelnet import VoxelNet
from voxelnet_tpu_torch.parallel import distributed, spatial
from voxelnet_tpu_torch.parallel.mesh import ProcessMesh, process_mesh
from voxelnet_tpu_torch.training.optim import ClippedSGD, OptState
from voxelnet_tpu_torch.training.train_step import (create_train_state,
                                                    make_eval_step,
                                                    make_train_step)

TIMEOUT_S = 100.0


def rows(x, batch: int, model: int = 1):
    """This process's contiguous rows of a global array of `batch` rows:
    the block of its data index (rank // model) of world // model."""
    local = batch // (distributed.world_size() // model)
    lo = distributed.rank() // model * local
    return x[lo:lo + local]


def config(overrides: dict, model: int = 1):
    """The Car config of `overrides`, its mesh the running world: `model`
    processes a model group, the rest data shards."""
    system = {"num_data_shards": distributed.world_size() // model,
              "num_model_shards": model}
    return get_config("Car", **dict(overrides, system=system))


def bn_case(x, w, bn_state, channel_dim, mask=None, relu=False) -> dict:
    """flax_batch_norm in train mode on this process's rows of the f64 x
    (B, ..., C), a ReLU after it where `relu`, and the backward of
    sum(y * w): y, x's gradient, the BN affine's gradient (this process's
    part of it) and the running stats."""
    b = x.shape[0]
    c = x.shape[channel_dim]
    bn = torch.nn.BatchNorm1d(c).double().train()
    bn.load_state_dict(bn_state, strict=False)
    xl = rows(x, b).clone().requires_grad_()
    y = flax_batch_norm(bn, xl, channel_dim,
                        None if mask is None else rows(mask, b), relu=relu)
    (y.double() * rows(w, b)).sum().backward()
    return {"y": y.detach(), "x_grad": xl.grad,
            "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def step_case(overrides, state_dict, batch, double=False,
              steps_per_epoch=10, momentum=None, steps=1, model=1,
              evaluate=False) -> dict:
    """`steps` make_train_step calls on this process's rows of `batch`
    (numpy, global) from `state_dict` (the model in f64 when `double`),
    under `model` processes a model group: metrics of the last, the
    state_dict after them, and how many ranks disagree with rank 0 on it
    afterwards. With `momentum`, the optimizer keeps a trace, which starts
    as a resumed run's would, different on each rank until
    broadcast_state_ gives every rank rank 0's; the traces are returned
    and held bit-identical across ranks too. With `evaluate`, the eval
    step runs first: its metrics, cls probabilities and reg maps, and
    the all-reduces of the train step by group. `update`: each
    parameter's change over the steps (lr times the clipped global
    gradient after one step), every gradient leaf to hold apart from the
    parameter's own size."""
    cfg = config(overrides, model)
    net = VoxelNet(cfg)
    net.load_state_dict(state_dict)
    if double:
        net.double()
    optimizer = (None if momentum is None else
                 ClippedSGD(cfg, steps_per_epoch, momentum=momentum))
    state = create_train_state(cfg, net, device="cpu", optimizer=optimizer)
    if momentum is not None:
        gen = torch.Generator().manual_seed(100 + distributed.rank())
        state.opt_state = OptState(count=0, trace=tuple(
            1e-3 * torch.randn(t.shape, generator=gen, dtype=t.dtype)
            for t in state.opt_state.trace))
    distributed.broadcast_state_(state.model, state.opt_state)
    b = batch["points"].shape[0]
    local = {k: rows(v, b, model) for k, v in batch.items()}
    out = {}
    if evaluate:
        metrics, probs, reg = make_eval_step(cfg, "cpu")(state, local)
        out.update(eval={k: float(v) for k, v in metrics.items()},
                   probs=probs, reg=reg)
    step = make_train_step(cfg, "cpu", steps_per_epoch, optimizer=optimizer)
    before = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    distributed.reset_counts()
    for _ in range(steps):
        state, metrics = step(state, local)
    trace = state.opt_state.trace
    return dict(out, metrics={k: float(v) for k, v in metrics.items()},
                state={k: v.detach().clone()
                       for k, v in state.model.state_dict().items()},
                update={k: p.detach() - before[k]
                        for k, p in state.model.named_parameters()},
                trace=None if trace is None else [t.clone() for t in trace],
                all_reduces={k: list(v) for k, v in
                             distributed.all_reduce_counts.items()},
                disagree=distributed.ranks_disagree(state.model,
                                                    state.opt_state))


def trainer_case(overrides, data, exp_dir, state_dict,
                 double=True, model=1) -> dict:
    """One Trainer run (every epoch of the config, label dumps on) from
    `state_dict` (the model in f64 when `double`), under `model` processes
    a model group: best val loss and step, the step count, the state_dict
    after it and the number of frames this process dumped a label file
    for, per epoch."""
    from voxelnet_tpu_torch.training.trainer import Trainer

    cfg = config(overrides, model)
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


def forward_case(overrides, state_dict, table, model=1) -> dict:
    """The model's eval-mode forward on this process's rows of the voxel
    table (features, coords, counts; numpy, global) from `state_dict`,
    under `model` processes a model group -> cls, reg (whole W)."""
    cfg = config(overrides, model)
    net = VoxelNet(cfg)
    net.load_state_dict(state_dict)
    b = table[0].shape[0]
    with torch.no_grad():
        cls, reg = net.eval()(*(torch.from_numpy(rows(t, b, model))
                                for t in table))
    return {"cls": cls, "reg": reg}


def loading_case(data, overrides, batch_size, model=1) -> dict:
    """The batches of one augmented, shuffled epoch of the train split
    under `data` that LazyBatchIterator loads for this process, under
    `model` processes a model group: tags and points each."""
    from voxelnet_tpu_torch.data.dataset import KITTIDataset
    from voxelnet_tpu_torch.data.pipeline import LazyBatchIterator

    cfg = config(overrides, model)
    ds = KITTIDataset(os.path.join(data, "training"), cfg, augment=True)
    ds.set_epoch(1)
    it = LazyBatchIterator(ds, batch_size, shuffle=True, seed=7, workers=2,
                           process_shard=process_mesh(
                               cfg.system).process_shard())
    try:
        return {"batches": [{"tags": list(b["tags"]), "points": b["points"]}
                            for b in it]}
    finally:
        it.close()


# --- the units of spatial sharding -------------------------------------------

class _SumGrad(torch.autograd.Function):
    """The identity; its backward sums the gradient over a group. Each
    member's backward reaches the whole input only through its own slab,
    so the sum is the whole gradient, on every member."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        distributed.all_reduce_in_place(grad, ctx.group)
        return grad, None


def equal_widths(width: int, num: int) -> tuple[int, ...]:
    """The widths of `spatial.slab`'s `num` slabs of `width` columns (in
    units of one column)."""
    return tuple(spatial.slab(width, num, i)[1] for i in range(num))


def slab_of(x, widths, index: int):
    """Slab `index` of the last axis of x cut into slabs of `widths`
    columns (which tile it)."""
    x0 = sum(widths[:index])
    return x[..., x0:x0 + widths[index]]


HALOS = ((1, 1), (1, 0), (0, 1), (2, 1))


def gradcheck_case(ranks, seed: int, widths=None) -> dict:
    """Over a group of `ranks` (every rank makes it; the others return
    {}), member m holding widths[m] columns (default 3 each; a width is 0
    or at least 2, the widest halo): for each halo of HALOS, halo_exchange's
    output on a slab of a whole f64 X (1, 2, 2, sum(widths)) against the
    slice of X zero-padded by the halo, and torch.autograd.gradcheck of
    X -> gather_w(sum over the taps s of the halo'd slab shifted by s,
    times random weights), the whole input reaching each member's slab
    through _SumGrad; then gradcheck of gather_w alone. -> name ->
    True/False."""
    group = distributed.make_group("units", ranks)
    if distributed.rank() not in ranks:
        return {}
    num, m = group.size, group.index()
    widths = widths or (3,) * num
    x0, width = sum(widths[:m]), sum(widths)
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn((1, 2, 2, width), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    out = {}
    for left, right in HALOS:
        taps = torch.randn((left + right + 1,) + X.shape, generator=gen,
                           dtype=torch.float64)
        x = slab_of(X.detach(), widths, m)
        ext = spatial.halo_exchange(x, left, right, group)
        want = F.pad(X.detach(), (left, right))[
            ..., x0:x0 + x.shape[-1] + left + right]
        out[f"halo{left}{right}-values"] = torch.equal(ext, want)

        def f(X, left=left, right=right, taps=taps):
            x = slab_of(_SumGrad.apply(X, group), widths, m)
            ext = spatial.halo_exchange(x, left, right, group)
            w = x.shape[-1]
            y = sum(ext[..., s:s + w] * slab_of(taps[s], widths, m)
                    for s in range(left + right + 1))
            return spatial.gather_w(y, x0, width, group)

        out[f"halo{left}{right}-gradcheck"] = torch.autograd.gradcheck(
            f, (X,), raise_exception=False)
    weight = torch.randn(X.shape, generator=gen, dtype=torch.float64)
    out["gather-gradcheck"] = torch.autograd.gradcheck(
        lambda X: spatial.gather_w(
            slab_of(_SumGrad.apply(X, group), widths, m)
            * slab_of(weight, widths, m), x0, width, group), (X,),
        raise_exception=False)
    return out


# conv kind -> (module, input shape (W last, divisible by 2, 3 and 4 into
# even slabs)); BN folded away, so each is its conv and ReLU
CONV_KINDS = {
    "middle-conv3d": (lambda: ConvBlock3D(3, 4, 2, 1), (1, 3, 4, 3, 24)),
    "rpn-k3s1": (lambda: ConvBNReLU(3, 4, 1), (2, 3, 3, 24)),
    "rpn-k3s2": (lambda: ConvBNReLU(3, 4, 2), (2, 3, 4, 24)),
    "deconv-k3s1": (lambda: DeconvBNReLU(3, 4, 3, 1), (2, 3, 3, 24)),
    "deconv-k2s2": (lambda: DeconvBNReLU(3, 4, 2, 2), (2, 3, 3, 24)),
    "deconv-k4s4": (lambda: DeconvBNReLU(3, 4, 4, 4), (2, 3, 3, 24)),
}


def conv_kind(name: str, seed: int):
    """The module of a CONV_KINDS entry, f64, weights drawn from `seed`,
    BN folded away (None), and its input and output cotangent's draws."""
    make, shape = CONV_KINDS[name]
    module = make().double()
    module.BatchNorm_0 = None
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype))
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    return module, x, gen


def conv_kind_grads(module, x, gen, mesh=None, widths=None,
                    index: int = 0) -> dict:
    """y = module(x) (x the whole input, or under `mesh` its slab `index`
    of slabs of `widths` columns; every output level scales the widths
    alike) and the backward of sum(y * g), g drawn from `gen` for the
    whole output and sliced alike: y, x's gradient, and the weight's and
    bias's gradients (this member's part of them)."""
    width = x.shape[-1]
    widths = widths or (width,)
    with torch.no_grad():
        out_shape = module(x).shape
    out_widths = tuple(w * out_shape[-1] // width for w in widths)
    x = slab_of(x, widths, index).clone().requires_grad_()
    y = module(x, mesh)
    g = torch.randn(out_shape, generator=gen, dtype=y.dtype)
    (y * slab_of(g, out_widths, index)).sum().backward()
    conv = next(c for c in module.children())
    return {"y": y.detach(), "x_grad": x.grad,
            "weight_grad": conv.weight.grad, "bias_grad": conv.bias.grad}


def conv_kinds_case(ranks, seed: int, widths=None) -> dict:
    """Each of CONV_KINDS on the slabs of a group of `ranks` (every rank
    makes it; the others return {}), member m holding widths[m] of the
    input's columns (default `slab`'s equal slabs): conv_kind_grads of
    this member."""
    group = distributed.make_group("kinds", ranks)
    if distributed.rank() not in ranks:
        return {}
    num, m = group.size, group.index()
    mesh = ProcessMesh(world_size=distributed.world_size(),
                       rank=distributed.rank(), num_model=num,
                       model_index=m, model_group=group)
    return {name: conv_kind_grads(*conv_kind(name, seed), mesh,
                                  widths or equal_widths(
                                      CONV_KINDS[name][1][-1], num), m)
            for name in CONV_KINDS}


CASES = {"bn": bn_case, "step": step_case,
         "trainer": trainer_case, "forward": forward_case,
         "loading": loading_case, "gradcheck": gradcheck_case,
         "conv_kinds": conv_kinds_case}


def run_cases(cases: dict) -> dict:
    return {name: CASES[case](**kw) for name, (case, kw) in cases.items()}


def main(job_path: str, rank: int) -> None:
    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(job["threads"])
    distributed.initialize(job["init"], job["world"], rank, device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        out = run_cases(job["cases"])
    finally:
        distributed.shutdown()
    torch.save(out, f"{job_path}.out{rank}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
