"""Train and eval steps, as `voxelnet_tpu/training/train_step.py`
(`make_train_step`, `make_eval_step`).

One train step does, on one device: voxelize (sort + run analysis, the
run-copy table kernel, finalize), the VFE on the table in train mode with
mask-aware flax BatchNorm, the dense grid (kernel forward, row-gather
backward), the Conv3D middle and RPN in train mode, target assignment on
the device, the RPN loss, backward, and the optimizer's update
(training/optim.py: clip by global norm, SGD with or without momentum, as
the optax transform the JAX step takes). It returns the JAX step's
metrics. The model's parameters and BN running stats are updated in place
(the JAX step returns new arrays).

Several processes (parallel/distributed.py) each run the step on their
own rows of the global batch, with the JAX sharded step's semantics: BN
statistics over the global batch (models/bn.py), the global gradient as
the SUM of the processes' gradients (the loss is a sum over frames), one
all-reduce of one flat buffer of all of them before the clip, and metrics
summed over the global batch (one more all-reduce of the metric vector).
Every process then holds the same gradient and takes the same update.
Under a 'model' axis (parallel/mesh.py) the processes of a model group
hold the same rows and each computes the gradient of its W slab (the
heads' maps are gathered whole, so each computes the whole, same loss):
the gradient still sums over the world, but the metrics sum over the
data group only, or they would count each frame once per slab.

A batch is a dict of numpy arrays or tensors with the JAX step's keys:
`points` (B, N, 4) f32 or int16 wire format with `num_points` (B,), or
host voxel buffers `voxel_features`/`voxel_coords`/`voxel_counts`; and
`gt_boxes` (B, G, 7) with `gt_mask` (B, G), or host target maps
`target_pos`/`target_neg`/`target_reg` (ops/targets.TargetPrecomputer).
"""

from __future__ import annotations

import dataclasses

import torch

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.config import VoxelNetConfig, resolve_plan
from voxelnet_tpu_torch.models.voxelnet import VoxelNet, build_model
from voxelnet_tpu_torch.ops import losses, targets as targets_ops
from voxelnet_tpu_torch.ops.anchors import anchors_flat
from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec,
                                             dequantize_points_i16,
                                             voxelize_table)
from voxelnet_tpu_torch.parallel import distributed
from voxelnet_tpu_torch.parallel.mesh import process_mesh
from voxelnet_tpu_torch.tracing import mark, stage
from voxelnet_tpu_torch.training.optim import (ClippedSGD, OptState,
                                               make_optimizer)


TRAIN_STAGES = ("voxelize", "targets", "forward", "loss", "backward",
                "all_reduce", "update")
LOSS_METRICS = ("loss", "cls_loss", "reg_loss", "cls_pos_loss",
                "cls_neg_loss")
EVAL_METRICS = ("loss", "cls_loss", "reg_loss")


@dataclasses.dataclass
class TrainState:
    step: int
    model: VoxelNet
    opt_state: OptState


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device")
    return device


def create_train_state(config: VoxelNetConfig, model: VoxelNet | None = None,
                       seed: int = 0, device="cuda", *,
                       optimizer: ClippedSGD | None = None) -> TrainState:
    """A state at step 0: `model` (or a random init from `seed`, see
    models/init.py) moved to `device`, and the fresh state of `optimizer`
    (default make_optimizer's: no momentum trace)."""
    model = build_model(config, seed=seed) if model is None else model
    model = model.to(_device(device))
    optimizer = optimizer or make_optimizer(config, 1)
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(list(model.parameters())))


class _Inputs:
    """Turns a batch into device tensors: the voxel table and the target
    maps."""

    def __init__(self, config: VoxelNetConfig, device: torch.device):
        obj = config.object
        self.config = config
        self.device = device
        self.spec = VoxelGridSpec.from_object_config(obj)
        self.anchors = torch.from_numpy(anchors_flat(obj)).to(device)
        self.standup = torch.from_numpy(targets_ops.anchor_standup_np(
            obj, buggy=config.compat.buggy_anchor_standup)).to(device)

    def tensor(self, batch, key, dtype=None):
        return torch.as_tensor(batch[key], dtype=dtype, device=self.device)

    def voxels(self, batch):
        """-> (features, coords, counts, voxels_clipped or None)."""
        if "voxel_features" in batch:
            return (self.tensor(batch, "voxel_features", torch.float32),
                    self.tensor(batch, "voxel_coords", torch.int32),
                    self.tensor(batch, "voxel_counts", torch.int32), None)
        max_voxels = self.config.data.max_voxels
        vox = voxelize_table(
            dequantize_points_i16(self.tensor(batch, "points")),
            self.tensor(batch, "num_points", torch.int32), self.spec,
            max_voxels)
        clipped = (vox.num_voxels_raw > max_voxels).sum()
        return vox.features, vox.coords, vox.counts, clipped

    def targets(self, batch):
        """-> (pos, neg, reg) target maps."""
        if "target_pos" in batch:
            return tuple(self.tensor(batch, k, torch.float32) for k in
                         ("target_pos", "target_neg", "target_reg"))
        obj = self.config.object
        assign = targets_ops.assign_targets(
            self.tensor(batch, "gt_boxes", torch.float32),
            self.tensor(batch, "gt_mask", torch.bool), self.anchors,
            self.standup, pos_iou=obj.rpn_pos_iou, neg_iou=obj.rpn_neg_iou,
            anchor_h=obj.anchor_h,
            iou_plus_one=self.config.compat.iou_plus_one,
            yaw_mode=self.config.train.yaw_encoding)
        return targets_ops.targets_to_maps(
            assign, (obj.feature_height, obj.feature_width))


def _loss_frames(config: VoxelNetConfig, cls_logits, reg,
                 maps) -> losses.RPNLoss:
    tcfg = config.train
    return losses.rpn_loss_frames(
        cls_logits, reg, *maps, alpha=tcfg.alpha, beta=tcfg.beta,
        sigma=tcfg.sigma, from_logits=True,
        buggy_smooth_l1=config.compat.buggy_smooth_l1)


def _global_metrics(frames: losses.RPNLoss, names: tuple[str, ...],
                    extra: dict, group) -> dict:
    """The loss terms `names` and the `extra` counts, summed over the
    global batch: one stacked f64 vector, one all-reduce over `group` (the
    data group; None: the world). Loss terms come back as f32 0-d
    tensors, counts as int64."""
    vec = torch.stack([losses.sum_frames(getattr(frames, n)) for n in names]
                      + [v.to(torch.float64) for v in extra.values()])
    vec = distributed.all_reduce_([vec], group)[0]
    metrics = dict(zip(names, vec[:len(names)].to(torch.float32).unbind()))
    metrics.update(zip(extra, vec[len(names):].to(torch.int64).unbind()))
    return metrics


def make_train_step(config: VoxelNetConfig, device="cuda",
                    steps_per_epoch: int = 1, *,
                    optimizer: ClippedSGD | None = None):
    """-> fn(state, batch, marks=None) -> (state, metrics): one step of
    `optimizer` (default make_optimizer(config, steps_per_epoch); the
    state's opt_state must come from the same optimizer, see
    create_train_state) on `device` (the card unless the caller asks for
    "cpu"). Metrics are
    0-d tensors over the global batch: loss, cls_loss, reg_loss,
    cls_pos_loss, cls_neg_loss, grad_norm (of the global gradient, before
    the clip), and voxels_clipped (frames whose occupied voxels exceed
    max_voxels) when the step voxelizes. `marks`: a list that receives
    (stage, CUDA event or host time) at the start and after each stage of
    TRAIN_STAGES ("all_reduce": the gradient's, nothing in one process);
    passing one also records the step's spans (tracing.py)."""
    resolve_plan(config, train=True)
    data_group = process_mesh(config.system).data_group
    device = _device(device)
    inputs = _Inputs(config, device)
    optimizer = optimizer or make_optimizer(config, steps_per_epoch)

    def step(state: TrainState, batch,
             marks: list | None = None) -> tuple[TrainState, dict]:
        with tracing.call("train", marks, device):
            model = state.model.train()
            mark(marks, "start", device)
            with stage(marks, "voxelize"):
                features, coords, counts, clipped = inputs.voxels(batch)
            with stage(marks, "targets"):
                maps = inputs.targets(batch)
            with stage(marks, "forward"):
                cls_logits, reg = model(features, coords, counts)
            with stage(marks, "loss"):
                frames = _loss_frames(config, cls_logits, reg, maps)
            with stage(marks, "backward"):
                params = list(model.parameters())
                grads = torch.autograd.grad(frames.loss.sum(), params)
            with stage(marks, "all_reduce"):
                grads = distributed.all_reduce_(grads)
            with stage(marks, "update"):
                grad_norm, state.opt_state = optimizer.apply_(
                    params, grads, state.opt_state)
            state.step += 1
            with torch.no_grad():
                metrics = _global_metrics(
                    frames, LOSS_METRICS,
                    {} if clipped is None else {"voxels_clipped": clipped},
                    data_group)
            metrics["grad_norm"] = grad_norm
        return state, metrics

    return step


def make_eval_step(config: VoxelNetConfig, device="cuda"):
    """-> fn(state, batch) -> (metrics {loss, cls_loss, reg_loss} over
    the global batch, cls probabilities (B, H', W', 2), reg (B, H', W',
    14) of this process's rows), the model in eval mode (running BN
    stats: no collective in the forward), no gradients."""
    resolve_plan(config)
    data_group = process_mesh(config.system).data_group
    device = _device(device)
    inputs = _Inputs(config, device)

    @torch.no_grad()
    def step(state: TrainState, batch):
        model = state.model.eval()
        features, coords, counts, _ = inputs.voxels(batch)
        maps = inputs.targets(batch)
        cls_logits, reg = model(features, coords, counts)
        frames = _loss_frames(config, cls_logits, reg, maps)
        metrics = _global_metrics(frames, EVAL_METRICS, {}, data_group)
        return metrics, torch.sigmoid(cls_logits), reg

    return step
