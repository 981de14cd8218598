"""Reference-named convenience API of the port: the public names of
`voxelnet_tpu/reference_api.py` (the symbols users of the PyTorch
reference know), backed by the port's modules, so switching costs one
import:

    from voxelnet_tpu_torch import reference_api as voxelnet

Functions that compute on a device take `device="cuda"` (the card) by
default, and raise without a card, saying to pass `device="cpu"`. Arrays
go in and come out as numpy, as in the JAX package.

| reference symbol (location)                         | backed by |
|------------------------------------------------------|-----------|
| get_cfg_defaults (config.py:125)                      | config.get_config |
| pcl_to_voxels (utils.py:10)                           | ops.voxelize.voxelize_np |
| generate_anchors (utils.py:104)                       | ops.anchors.generate_anchors |
| generate_targets (utils.py:376)                       | ops.targets (vectorized, on `device`) |
| deltas_to_boxes_3d (utils.py:476)                     | ops.box_coding.decode_deltas |
| nms (utils.py:492)                                    | ops.nms.nms_bev |
| smooth_L1_loss (loss.py:3)                            | ops.losses.smooth_l1 |
| label_to_gt_box_3d (utils.py:176)                     | utils.kitti.labels_to_gt_box3d |
| box3d_to_label (utils.py:817)                         | utils.kitti.boxes_to_label_lines |
| load_calib (utils.py:556)                             | utils.kitti.load_calib |
| camera_to_lidar_box / lidar_to_camera_box             | utils.geometry |
| center_to_corner_box3d / corner_to_standup_box2d ...  | utils.geometry |
| KITTIDataset / collate_fn (dataset.py:26/70)          | data.dataset |
| RPN3D (model.py:284)                                  | models.voxelnet.VoxelNet + make_inference_fn |

`RPN3D` is the port's `VoxelNet` module; `build_model(config, seed,
device)` gives one with random weights on `device`, `init_params(config,
seed)` its state_dict, and `make_inference_fn(config, device)` the jitted
JAX function's counterpart, `fn(model, points, num_points) -> Detections`.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.data.dataset import KITTIDataset, collate as collate_fn  # noqa: F401
from voxelnet_tpu_torch.models import voxelnet as _voxelnet
from voxelnet_tpu_torch.models.voxelnet import VoxelNet as RPN3D  # noqa: F401
from voxelnet_tpu_torch.ops import anchors as _anchors
from voxelnet_tpu_torch.ops import box_coding as _box_coding
from voxelnet_tpu_torch.ops import losses as _losses
from voxelnet_tpu_torch.ops import nms as _nms
from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, voxelize_np
from voxelnet_tpu_torch.utils.geometry import (  # noqa: F401
    camera_to_lidar_boxes as camera_to_lidar_box,
    center_to_corner_box2d as center_to_corner_box_2d,
    center_to_corner_box3d,
    corner_to_standup_box2d,
    lidar_to_camera_boxes as lidar_to_camera_box,
)
from voxelnet_tpu_torch.utils.kitti import (  # noqa: F401
    boxes_to_label_lines as box3d_to_label,
    labels_to_gt_box3d as label_to_gt_box_3d,
    load_calib,
)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA "
            "device: pass device='cpu' to run on the CPU")
    return device


def _tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype),
                           device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def get_cfg_defaults(class_name: str = "Car"):
    """Reference: voxelnet/config.py:125-129 (plus the class switch the
    reference bakes in at import time)."""
    return get_config(class_name)


def pcl_to_voxels(pcl: np.ndarray, target: str = "Car",
                  verbose: bool = False,
                  rng: np.random.Generator | None = None) -> dict:
    """Reference: voxelnet/utils.py:10-100. Same buffer names and
    semantics, ragged K (no padding). The points are shuffled first
    (data.shuffle_points) from `rng`, by default a fresh Generator."""
    cfg = get_config(target)
    spec = VoxelGridSpec.from_object_config(cfg.object)
    vox = voxelize_np(pcl, spec, shuffle=cfg.data.shuffle_points, rng=rng)
    out = {
        "feature_buffer": vox.features,
        "coordinate_buffer": vox.coords,
        "number_buffer": vox.counts.astype(np.int64),
    }
    if verbose:
        for k, v in out.items():
            print(f"{k} shape: {v.shape}")
    return out


def generate_anchors(class_name: str = "Car") -> np.ndarray:
    """Reference: voxelnet/utils.py:104-130."""
    return _anchors.generate_anchors(get_config(class_name).object)


def deltas_to_boxes_3d(deltas, anchors, class_name: str = "Car",
                       device="cuda") -> np.ndarray:
    """Reference: voxelnet/utils.py:476-489: (B, H', W', 14) deltas ->
    (B, A, 7) lidar boxes."""
    dev = _device(device)
    cfg = get_config(class_name)
    b = deltas.shape[0]
    out = _box_coding.decode_deltas(
        _tensor(deltas, dev).reshape(b, -1, 7),
        _tensor(anchors, dev).reshape(-1, 7),
        cfg.object.anchor_h)
    return _to_numpy(out)


def nms(boxes3d, scores, overlap: float = 0.1, top_k: int = 20,
        score_thresh: float = 0.0, mode: str = "rotated", device="cuda"):
    """Reference: voxelnet/utils.py:492-553 (score-sorted greedy NMS).

    Takes (N, 7) lidar boxes (not standup 2D like the reference — the
    rotated-BEV IoU runs on `device`). Returns (kept_boxes, kept_scores)
    in score order. Exact score ties may come in another order than the
    JAX package's (torch.topk on CUDA keeps no order among ties)."""
    dev = _device(device)
    res = _nms.nms_bev(
        _tensor(boxes3d, dev, np.float32)[None],
        _tensor(scores, dev, np.float32)[None],
        score_thresh=score_thresh, iou_thresh=overlap,
        pre_topk=min(512, len(scores)), post_topk=top_k, mode=mode)
    valid = _to_numpy(res.valid[0])
    return _to_numpy(res.boxes[0])[valid], _to_numpy(res.scores[0])[valid]


def smooth_L1_loss(deltas, targets, sigma: float = 3.0, device="cuda"):
    """Reference: voxelnet/loss.py:3-12 (corrected gating; the reference's
    formula bug is available via ops.losses.smooth_l1(buggy=True))."""
    dev = _device(device)
    return _to_numpy(_losses.smooth_l1(
        _tensor(deltas, dev), _tensor(targets, dev), sigma=sigma))


def generate_targets(labels, feature_map_shape, anchors,
                     cls_name: str = "Car", coordinate: str = "lidar",
                     device="cuda"):
    """Reference: voxelnet/utils.py:376-473.

    Same signature shape: per-batch label-line lists -> pos_equal_one /
    neg_equal_one (B, H', W', 2) and targets (B, H', W', 14), computed with
    the vectorized assignment on `device` (corrected anchor standup
    geometry)."""
    from voxelnet_tpu_torch.ops import targets as _targets
    from voxelnet_tpu_torch.utils import kitti

    dev = _device(device)
    obj = get_config(cls_name).object
    flat = _tensor(anchors, dev, np.float32).reshape(-1, 7)
    standup = _tensor(_targets.anchor_standup_np(obj), dev)

    gt_list = kitti.labels_to_gt_box3d(labels, cls_name, coordinate)
    pos_out, neg_out, tgt_out = [], [], []
    for gt in gt_list:
        boxes, mask = kitti.pad_gt_boxes(gt, max(len(gt), 1))
        assign = _targets.assign_targets(
            _tensor(boxes, dev)[None], _tensor(mask, dev)[None], flat,
            standup,
            pos_iou=obj.rpn_pos_iou, neg_iou=obj.rpn_neg_iou,
            anchor_h=obj.anchor_h)
        pos, neg, tgt = _targets.targets_to_maps(assign,
                                                 tuple(feature_map_shape))
        pos_out.append(_to_numpy(pos[0]))
        neg_out.append(_to_numpy(neg[0]))
        tgt_out.append(_to_numpy(tgt[0]))
    return np.stack(pos_out), np.stack(neg_out), np.stack(tgt_out)


def build_model(config, seed: int = 0, device="cuda") -> RPN3D:
    """A randomly initialized RPN3D (the port's VoxelNet) on `device`, in
    eval mode."""
    return _voxelnet.build_model(config, seed=seed, device=_device(device))


def init_params(config, seed: int = 0) -> dict:
    """The state_dict (CPU tensors) of a random init from `seed`: the
    port's counterpart of the JAX package's variables."""
    return _voxelnet.build_model(config, seed=seed).state_dict()


def make_inference_fn(config, device="cuda"):
    """-> fn(model, points (B, N, 4) f32, num_points (B,) i32) ->
    Detections (boxes, scores, valid), on `device`."""
    return _voxelnet.make_inference_fn(config, _device(device))
