"""The VoxelNet detector and its single-path inference function.

Counterpart of `voxelnet_tpu/models/voxelnet.py` (`VoxelNet`,
`make_inference_fn`). Inference runs, in order: sort + run analysis
(ops/voxelize.prepare), the fused voxel-table + VFE kernel (with
`compat.bn_over_padding`: the run-copy table kernel and the table VFE in
eval mode, as the JAX resolver takes its XLA path), the streaming
dense-grid kernel, the Conv3D middle stack, the RPN, sigmoid + anchor
decode, and score gate + top-k + rotated-BEV NMS. `VoxelNet.forward` is
the flax module's `__call__` on an explicit voxel table, in whatever mode
the module is in: the train and eval steps (training/train_step.py) run it.

Under `system.num_model_shards = M > 1` (the JAX model's `spatial_shard`
and `num_model`) the M processes of a model group (parallel/mesh.py) hold
the same rows: each runs the VFE and the voxel table whole, then only its
W slab (`w_window`: uneven where the RPN's units do not divide evenly,
empty for the last ranks where there are fewer units than ranks) of the
dense grid (or of sparse1's block 1), the middle and the RPN, with halo
exchanges between neighbours, and gathers the heads' maps whole
(parallel/spatial.py); decode, NMS, targets and the loss run replicated.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import weakref
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from voxelnet_tpu_torch import tracing
from voxelnet_tpu_torch.config import (VoxelNetConfig, middle_path,
                                       resolve_plan)
from voxelnet_tpu_torch.kernels.sparse_conv import occupancy_map
from voxelnet_tpu_torch.models.bn import running_stats_frozen
from voxelnet_tpu_torch.models.bn_fold import fold_bn_
from voxelnet_tpu_torch.models.init import init_
from voxelnet_tpu_torch.models.middle import MiddleLayers, depth_out
from voxelnet_tpu_torch.models.rpn import RPN
from voxelnet_tpu_torch.models.scatter import scatter_to_dense_streamed
from voxelnet_tpu_torch.models.vfe import FeatureLearningNet
from voxelnet_tpu_torch.ops import box_coding, nms
from voxelnet_tpu_torch.ops.anchors import anchors_flat
from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec, prepare,
                                             voxelize_table)
from voxelnet_tpu_torch.parallel.mesh import ProcessMesh, process_mesh
from voxelnet_tpu_torch.parallel.spatial import slab
from voxelnet_tpu_torch.tracing import mark, stage

STAGES = ("prepare", "vfe", "dense", "middle", "rpn", "decode", "nms")


def model_mesh(config: VoxelNetConfig) -> ProcessMesh | None:
    """The process mesh of a config with a model axis, None without one
    (then nothing is sharded spatially)."""
    if config.system.num_model_shards == 1:
        return None
    return process_mesh(config.system)


class VoxelNet(nn.Module):
    """Parameter tree of the flax VoxelNet: feature_net, middle, rpn. With
    a model axis in `config.system`, the running process group's mesh is
    read when the module is built (and must be up)."""

    def __init__(self, config: VoxelNetConfig):
        super().__init__()
        self.mesh = model_mesh(config)
        self.window = w_window(config, self.mesh)
        obj = config.object
        self.grid_dzyx = tuple(obj.grid_size)
        self.compute_dtype = getattr(torch, config.train.compute_dtype)
        self.feature_net = FeatureLearningNet(
            obj.points_per_voxel, config.compat.bn_over_padding)
        self.middle = MiddleLayers(cin=128)
        self.rpn = RPN(cin=64 * depth_out(obj.depth),
                       block1_stride=config.rpn.block1_stride)
        self.remat = config.train.remat
        self.middle_path = middle_path(config.data.middle_backend)

    def forward(self, features: torch.Tensor, coords: torch.Tensor,
                counts: torch.Tensor):
        """features (B, K, T, 7) f32, coords (B, K, 3), counts (B, K) in
        the voxelizer's order -> (cls logits (B, H', W', 2) f32, reg
        (B, H', W', 14) f32): table VFE, dense grid (kernel forward, row
        gather backward) and Conv3D middle, or under 'sparse1' the
        occupancy map and block 1 from the table (kernel forward, gather
        kernel backward) and Conv3D blocks 2-3, then the RPN, in the
        compute dtype.

        With gradients on, `train.remat` (the JAX package's seams,
        `voxelnet_tpu/models/voxelnet.py:110-112, 157-159`) recomputes in
        backward what it does not keep: 'seams' keeps the voxelwise table
        and the BEV map and recomputes the dense grid (or occupancy map) +
        middle and the RPN; 'full' recomputes the whole forward."""
        if self.remat == "full" and torch.is_grad_enabled():
            return _recomputed(self._forward, features, coords, counts)
        return self._forward(features, coords, counts)

    def _forward(self, features, coords, counts):
        seams = self.remat == "seams" and torch.is_grad_enabled()
        mesh = self.mesh
        voxelwise = self.feature_net.table(
            features, counts, self.compute_dtype,
            None if mesh is None else mesh.data_group)
        columns = rpn_columns(self.grid_dzyx, self.window)
        if seams:
            bev = _recomputed(self._middle, voxelwise, coords, counts)
            return _recomputed(self.rpn, bev, mesh, *columns)
        return self.rpn(self._middle(voxelwise, coords, counts), mesh,
                        *columns)

    def _middle(self, voxelwise, coords, counts):
        mesh, window = self.mesh, self.window
        if self.middle_path == "sparse1":
            occ = window_occupancy(coords, counts, self.grid_dzyx, window)
            return self.middle.from_table(voxelwise, coords, counts, occ,
                                          mesh, window)
        dense = scatter_to_dense_streamed(voxelwise, coords, counts,
                                          self.grid_dzyx, window)
        return self.middle(dense, mesh)


def w_window(config: VoxelNetConfig, mesh: ProcessMesh | None):
    """(x0, wloc) of this process's W slab of the grid under a model axis
    of `mesh`, in units of the RPN's rpn.block1_stride x 4 columns
    (parallel/spatial.py::slab; wloc 0 for a rank past the units), None
    without one."""
    if mesh is None:
        return None
    return slab(config.object.grid_size[2], mesh.num_model,
                mesh.model_index, 4 * config.rpn.block1_stride)


def rpn_columns(grid_dzyx, window) -> tuple:
    """RPN.forward's (x0, width) of the BEV map under a W window, () for
    the whole map."""
    return () if window is None else (window[0], grid_dzyx[2])


def window_occupancy(coords, counts, grid_dzyx, window):
    """sparse1's occupancy map of the whole grid (B, D, H, W); for an
    empty W window (x0, 0) the map's columns that it reads, (B, D, H, 0),
    with no kernel launched."""
    if window is not None and window[1] == 0:
        return counts.new_zeros((counts.shape[0],) + tuple(grid_dzyx[:2])
                                + (0,))
    return occupancy_map(coords, counts, grid_dzyx)


def _recomputed(fn, *args):
    """fn(*args) under torch.utils.checkpoint: its activations are
    recomputed in backward, with the BN running stats held still then (the
    forward already moved them)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          running_stats_frozen()))


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, post_topk, 7) lidar boxes
    scores: torch.Tensor   # (B, post_topk)
    valid: torch.Tensor    # (B, post_topk) bool


def build_model(config: VoxelNetConfig, seed: int = 0,
                device: torch.device | str = "cpu") -> VoxelNet:
    """Randomly initialized model (models/init.py) in eval mode."""
    model = VoxelNet(config)
    init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def prepare_for_inference(model: VoxelNet, fold_bn: bool,
                          dtype: torch.dtype,
                          middle: str = "conv3d") -> VoxelNet:
    """A copy of `model` for the inference path: eval mode, middle/RPN BNs
    folded into their convs when `fold_bn`, conv weights cast once to the
    compute dtype (the BNs that stay run in f32, the VFE parameters stay
    f32 for the kernel's fold), channels-last conv weights. Under
    middle='sparse1' block 1's weight is laid out in the product's order
    instead (its `weight_matrix` is then a view) and its bias stays f32,
    the type the sparse conv adds it in."""
    net = copy.deepcopy(model).eval()
    if fold_bn:
        fold_bn_(net)
    table_conv = net.middle.ConvBlock3D_0.Conv_0
    for m in itertools.chain(net.middle.modules(), net.rpn.modules()):
        if m is table_conv and middle == "sparse1":
            w = m.weight.data.to(dtype)
            m.weight.data = w.permute(1, 2, 3, 4, 0).contiguous().permute(
                4, 0, 1, 2, 3)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            fmt = (torch.channels_last_3d if m.weight.dim() == 5
                   else torch.channels_last)
            m.weight.data = m.weight.data.to(dtype).contiguous(
                memory_format=fmt)
            m.bias.data = m.bias.data.to(dtype)
    return net


def _versions(model: nn.Module) -> tuple[int, ...]:
    return tuple(t._version for t in itertools.chain(model.parameters(),
                                                     model.buffers()))


def make_maps_fn(config: VoxelNetConfig, device: torch.device | str = "cuda"):
    """-> fn(model, points (B, N, 4) f32, num_points (B,) i32, marks=None)
    -> (cls logits (B, H', W', 2), reg (B, H', W', 14)), on `device`: the
    inference graph up to the heads (voxelization, the VFE, the dense grid
    or sparse1's table, the middle, the RPN), with no decode or NMS.

    The model's weights are folded and cast at the first call with it and
    again only after a parameter or buffer changes in place. `marks`: a
    list that receives (stage, CUDA event or host time) after each stage
    of STAGES up to 'rpn'; passing one also records the call's spans
    (tracing.py). With a model axis in `config.system`, every
    process of a model group calls fn on the same points and each returns
    the maps of its W slab.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device")
    plan = resolve_plan(config)
    dtype = getattr(torch, plan.dtype)
    spec = VoxelGridSpec.from_object_config(config.object)
    obj = config.object
    max_voxels = config.data.max_voxels
    table_vfe = config.compat.bn_over_padding
    mesh = model_mesh(config)
    window = w_window(config, mesh)
    columns = rpn_columns(obj.grid_size, window)
    cache: dict = {}

    def prepared(model: VoxelNet) -> VoxelNet:
        if model.feature_net.bn_over_padding != table_vfe:
            raise ValueError(
                f"the model was built with compat.bn_over_padding="
                f"{model.feature_net.bn_over_padding}, the inference config "
                f"has {table_vfe}")
        versions = _versions(model)
        ref = cache.get("model")
        if ref is None or ref() is not model or cache["versions"] != versions:
            cache.update(model=weakref.ref(model), versions=versions,
                         net=prepare_for_inference(model, plan.fold_bn,
                                                   dtype, plan.middle))
        return cache["net"]

    def fn(model: VoxelNet, points, num_points, marks=None):
        with tracing.call("infer", marks, device):
            with torch.no_grad():
                net = prepared(model)
            with torch.inference_mode():
                return run(net, points, num_points, marks)

    def run(net: VoxelNet, points, num_points, marks):
        points = torch.as_tensor(points, dtype=torch.float32, device=device)
        num_points = torch.as_tensor(num_points, dtype=torch.int32,
                                     device=device)
        mark(marks, "start", device)
        with stage(marks, "prepare"):
            vox = (voxelize_table if table_vfe else prepare)(
                points, num_points, spec, max_voxels)
        with stage(marks, "vfe"):
            voxelwise = (net.feature_net.table(vox.features, vox.counts,
                                               dtype)
                         if table_vfe else net.feature_net(vox))
        coords, counts = vox.coords, vox.counts
        sparse1 = plan.middle == "sparse1"
        with stage(marks, "dense"):
            if sparse1:
                occ = window_occupancy(coords, counts, obj.grid_size, window)
            else:
                dense = scatter_to_dense_streamed(voxelwise, coords, counts,
                                                  obj.grid_size, window)
        with stage(marks, "middle"):
            bev = (net.middle.from_table(voxelwise.to(dtype), coords, counts,
                                         occ, mesh, window) if sparse1
                   else net.middle(dense.to(dtype), mesh))
        with stage(marks, "rpn"):
            return net.rpn(bev, mesh, *columns)

    return fn


def make_inference_fn(config: VoxelNetConfig,
                      device: torch.device | str = "cuda"):
    """-> fn(model, points (B, N, 4) f32, num_points (B,) i32,
    marks=None) -> Detections, all on `device`: make_maps_fn's maps, then
    the box decode and NMS.

    `marks`: a list that receives (stage, CUDA event or host time) after
    each stage of STAGES, for per-stage timing; passing one also records
    the call's spans and counters (tracing.py). With a model axis in
    `config.system`, every process of a model group calls fn on the same
    points; all return the same detections.
    """
    maps_fn = make_maps_fn(config, device)
    device = torch.device(device)
    anchors = torch.from_numpy(anchors_flat(config.object)).to(device)
    obj, rpn_cfg = config.object, config.rpn

    def fn(model: VoxelNet, points, num_points, marks=None) -> Detections:
        with tracing.call("infer", marks, device):
            cls_logits, reg = maps_fn(model, points, num_points, marks)
            with torch.inference_mode():
                b = cls_logits.shape[0]
                with stage(marks, "decode"):
                    probs = torch.sigmoid(cls_logits).reshape(b, -1)
                    boxes = box_coding.decode_deltas(
                        reg.reshape(b, -1, 7), anchors, obj.anchor_h,
                        yaw_mode=config.train.yaw_encoding)
                with stage(marks, "nms"):
                    res = nms.nms_bev(boxes, probs,
                                      score_thresh=rpn_cfg.score_thres,
                                      iou_thresh=rpn_cfg.nms_thres,
                                      pre_topk=rpn_cfg.nms_pre_topk,
                                      post_topk=rpn_cfg.nms_post_topk,
                                      mode=rpn_cfg.nms_mode)
        return Detections(res.boxes, res.scores, res.valid)

    return fn
