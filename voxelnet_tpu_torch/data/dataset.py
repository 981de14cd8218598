"""KITTI dataset and static-shape batching: the port's copy of
`voxelnet_tpu/data/dataset.py`. For the same directory, config and seed
its examples and batches are bit-equal to the JAX package's. Each example
carries

  points     (N_max, 4) f32, or the int16 wire format  + num_points
  gt_boxes   (G_max, 7) lidar boxes + gt_mask
  label lines / tag / paths (host-side eval)

and, with `host_voxelize=True` (train.host_voxelize), the voxel table of
its capped points built on the host by `data.host_voxelizer`
(ops/voxelize.resolve_host_voxelizer: `voxelize_np` or its C++ twin):
voxel_features (K_max, T, 7), voxel_coords (K_max, 3), voxel_counts
(K_max,). Otherwise voxelization runs on the device
(training/train_step.py).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from voxelnet_tpu_torch.config import VoxelNetConfig
from voxelnet_tpu_torch.data import augment as augment_lib
from voxelnet_tpu_torch.ops import voxelize as voxelize_lib
from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec,
                                             resolve_host_voxelizer)
from voxelnet_tpu_torch.utils import kitti


@dataclass
class Example:
    tag: str
    points: np.ndarray       # (N_max, 4) f32, or int16 wire format when
                             # train.upload_points='i16q' (_emit_i16)
    num_points: np.int32
    gt_boxes: np.ndarray     # (G_max, 7) lidar
    gt_mask: np.ndarray      # (G_max,) bool
    label_lines: list[str]
    image_path: str | None = None
    points_clipped: bool = False   # raw N exceeded data.max_points
    gt_clipped: bool = False       # raw GT count exceeded data.max_gt_boxes
    # the host voxel table (host_voxelize=True only)
    voxel_features: np.ndarray | None = None   # (K_max, T, 7) f32
    voxel_coords: np.ndarray | None = None     # (K_max, 3) i32
    voxel_counts: np.ndarray | None = None     # (K_max,) i32


class KITTIDataset:
    """Index over a KITTI split dir with image_2/ velodyne/ label_2/."""

    def __init__(self, data_dir: str, config: VoxelNetConfig,
                 augment: bool = False, test: bool = False,
                 host_voxelize: bool = False, seed: int = 0):
        self.data_dir = data_dir
        self.config = config
        self.augment = augment
        self.test = test
        self.host_voxelize = host_voxelize
        self.seed = seed
        self.epoch = 0
        self.spec = VoxelGridSpec.from_object_config(config.object)
        if host_voxelize:
            self._voxelize = resolve_host_voxelizer(
                config.data.host_voxelizer)

        # bounded in-RAM frame cache: epochs after the first skip the .bin
        # read (and the grid crop when no augmentation moves points across
        # the boundary). Fill until the budget, no eviction: epoch-cyclic
        # access would thrash an LRU. Pipeline threads share it; entries
        # are treated as immutable.
        mb = config.data.cache_frames_mb
        self._frame_cache: dict | None = {} if mb > 0 else None
        self._cache_budget = mb * (1 << 20)
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()

        velo_dir = os.path.join(data_dir, "velodyne")
        self.tags = sorted(
            f[:-4] for f in os.listdir(velo_dir) if f.endswith(".bin"))
        if not test:
            label_dir = os.path.join(data_dir, "label_2")
            label_tags = {f[:-4] for f in os.listdir(label_dir)
                          if f.endswith(".txt")}
            self.tags = [t for t in self.tags if t in label_tags]

    def __len__(self) -> int:
        return len(self.tags)

    def set_epoch(self, epoch: int) -> None:
        """Vary the per-item RNG streams across epochs (augmentation,
        point shuffling); the trainer calls it each epoch."""
        self.epoch = epoch

    def _item_rng(self, idx: int) -> np.random.Generator:
        """Deterministic per-(item, epoch) RNG: pipeline threads assemble
        examples concurrently, and a shared Generator is not thread-safe."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, idx]))

    def _paths(self, tag: str):
        return (
            os.path.join(self.data_dir, "image_2", tag + ".png"),
            os.path.join(self.data_dir, "velodyne", tag + ".bin"),
            os.path.join(self.data_dir, "label_2", tag + ".txt"),
        )

    @property
    def _emit_i16(self) -> bool:
        """Emit the int16 wire format straight from the dataset: quantized
        once (cached), and every later copy (shuffle gather, pad, collate,
        upload) moves half the bytes. Only when the train step dequantizes
        (train.upload_points='i16q') and no augmentation needs f32 points
        on the host (augmentation, host voxelization)."""
        return (self.config.train.upload_points == "i16q"
                and not self.host_voxelize and not self.augment)

    def _load_points(self, tag: str, velo_path: str) -> np.ndarray:
        """Raw cloud, through the frame cache. Without augmentation the
        cached entry is already grid-cropped (the crop is deterministic
        then) and, in i16q mode, quantized; with augmentation the raw f32
        cloud is cached and a copy handed out (augmentation writes in
        place). Callers must not mutate the no-augment return."""
        cache = self._frame_cache
        pre_crop = (not self.augment) and self.config.data.crop_to_grid

        def prepare(points):
            if pre_crop:
                points = voxelize_lib.crop_points(points, self.spec)
            if self._emit_i16:
                points = voxelize_lib.quantize_points_i16(points)
            return points

        if cache is None:
            return prepare(kitti.read_point_cloud(velo_path))
        hit = cache.get(tag)
        if hit is not None:
            return hit.copy() if self.augment else hit
        points = prepare(kitti.read_point_cloud(velo_path))
        with self._cache_lock:
            if self._cache_bytes + points.nbytes <= self._cache_budget:
                cache[tag] = points
                self._cache_bytes += points.nbytes
        return points.copy() if self.augment else points

    def __getitem__(self, idx: int) -> Example:
        rng = self._item_rng(idx)
        tag = self.tags[idx]
        img_path, velo_path, label_path = self._paths(tag)
        points = self._load_points(tag, velo_path)

        label_lines: list[str] = []
        if not self.test and os.path.exists(label_path):
            with open(label_path) as f:
                label_lines = f.readlines()

        if self.augment and label_lines:
            gt_cam = kitti.parse_label_lines(label_lines, cls_name="",
                                             coordinate="camera")
            collision_iou = None
            if self.config.compat.raster_collision:
                obj, img = self.config.object, self.config.image
                collision_iou = lambda b1, b2: augment_lib.raster_iou_2d(
                    b1, b2, obj, (img.height, img.width))
            points, gt_cam, suffix = augment_lib.augment_pointcloud(
                points, gt_cam, rng, collision_iou=collision_iou)
            classes = kitti.parse_label_classes(label_lines)
            label_lines = kitti.boxes_to_label_lines(
                gt_cam, classes, coordinate="camera")
            tag = f"{tag}_{suffix}"

        gt_lidar = kitti.parse_label_lines(
            label_lines, cls_name=self.config.object.name,
            coordinate="lidar")
        gt_boxes, gt_mask = kitti.pad_gt_boxes(
            gt_lidar, self.config.data.max_gt_boxes)

        if self.config.data.crop_to_grid and self.augment:
            # after augmentation (global rotation/scale move points across
            # the grid boundary), before the cap. The no-augment path
            # cropped (and in i16q mode quantized) in _load_points, so this
            # crop never sees int16 points.
            points = voxelize_lib.crop_points(points, self.spec)
        if self.config.data.shuffle_points:
            points = points[rng.permutation(len(points))]
        n = min(len(points), self.config.data.max_points)
        pts = np.zeros((self.config.data.max_points, 4), points.dtype
                       if points.dtype == np.int16 else np.float32)
        pts[:n] = points[:n]

        ex = Example(
            tag=tag, points=pts, num_points=np.int32(n),
            gt_boxes=gt_boxes, gt_mask=gt_mask,
            label_lines=label_lines, image_path=img_path,
            points_clipped=len(points) > self.config.data.max_points,
            gt_clipped=len(gt_lidar) > self.config.data.max_gt_boxes,
        )
        if self.host_voxelize:
            vox = self._voxelize(points[:n], self.spec,
                                 max_voxels=self.config.data.max_voxels)
            ex.voxel_features = vox.features
            ex.voxel_coords = vox.coords
            ex.voxel_counts = vox.counts
        return ex


def collate(examples: list[Example]) -> dict:
    """Stack Examples into fixed-shape arrays. `clipped_points` /
    `clipped_gt` count examples whose raw cloud / GT list exceeded the
    static caps (saturation telemetry the trainer logs). Host voxel tables,
    when the examples carry them, are stacked too."""
    batch = {
        "tags": [e.tag for e in examples],
        "points": np.stack([e.points for e in examples]),
        "num_points": np.asarray([e.num_points for e in examples], np.int32),
        "gt_boxes": np.stack([e.gt_boxes for e in examples]),
        "gt_mask": np.stack([e.gt_mask for e in examples]),
        "label_lines": [e.label_lines for e in examples],
        "clipped_points": sum(int(e.points_clipped) for e in examples),
        "clipped_gt": sum(int(e.gt_clipped) for e in examples),
    }
    if examples[0].voxel_features is not None:
        for key in ("voxel_features", "voxel_coords", "voxel_counts"):
            batch[key] = np.stack([getattr(e, key) for e in examples])
    return batch


def plan_batches(num_examples: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True,
                 process_shard: tuple[int, int] | None = None,
                 ) -> list[tuple[np.ndarray, int]]:
    """One epoch's batches -> list of (example_idxs, num_real): the one
    plan of the threaded train pipeline (data/pipeline.py) and the
    synchronous val iterator below.

    With drop_remainder=False the tail batch is padded by cycling the
    epoch order up to batch_size (a dataset smaller than one batch wraps
    repeatedly); num_real counts the non-padding examples.

    process_shard=(data index, batch shards): per-process loading
    (parallel/mesh.ProcessMesh.process_shard). batch_size is the global
    batch and each batch shard gets its contiguous row block; the
    processes of a model group share a data index and so load the same
    rows; num_real stays the global count.
    """
    order = np.arange(num_examples)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if process_shard is not None:
        pid, nproc = process_shard
        if batch_size % nproc:
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly "
                f"across {nproc} processes (rows would be silently "
                "dropped)")
    plan = []
    for start in range(0, num_examples, batch_size):
        idxs = order[start:start + batch_size]
        num_real = len(idxs)
        if num_real < batch_size:
            if drop_remainder:
                break
            idxs = np.concatenate(
                [idxs, np.resize(order, batch_size - num_real)])
        if process_shard is not None:
            pid, nproc = process_shard
            local = batch_size // nproc
            idxs = idxs[pid * local:(pid + 1) * local]
        plan.append((idxs, num_real))
    return plan


def make_batch_iterator(dataset: KITTIDataset, batch_size: int,
                        shuffle: bool = True, seed: int = 0,
                        drop_remainder: bool = True,
                        process_shard: tuple[int, int] | None = None,
                        ) -> Iterator[dict]:
    """Epoch iterator of collated batches (plan_batches' semantics)."""
    for idxs, num_real in plan_batches(
            len(dataset), batch_size, shuffle, seed, drop_remainder,
            process_shard):
        batch = collate([dataset[int(i)] for i in idxs])
        batch["num_real"] = num_real
        yield batch
