"""Training loop of the port, as the single-process path of
`voxelnet_tpu/training/trainer.py`: experiment dir `exps/YYYY-MM-DD-NNN/
{checkpoints,logs,vis,preds}`, config snapshot, TensorBoard scalars and
prediction images when a writer imports, sampled validation, per-epoch
validation with KITTI label dumps and `num_vis_dump` image triplets, best
tracking by val loss across resume, saturation counters and a
`torch.profiler` window.

The train and eval steps run on `device` (the card unless the caller asks
for "cpu"). Host batches come from `data/pipeline.LazyBatchIterator`; a
staging thread uploads them ahead of the step (on a CUDA device: pinned
host copies and non_blocking copies on a side stream, which the step's
stream waits on). Unlike the JAX stager, it stops within a bounded time
when the consumer raises or closes mid-epoch.

Several processes, one card each (parallel/distributed.py, started before
the Trainer), run the JAX multi-host trainer's semantics: every process
runs the same Trainer; each loads only its contiguous rows of every global
batch (`num_real` stays global); the steps' BN statistics, gradients and
metrics are global, so every process takes the same update and sees the
same val loss and best-checkpoint decision; `config.yaml`, TensorBoard,
prints and checkpoints come from rank 0 (every rank restores, and waits
at a barrier after each save); label dumps are per batch shard, each of
the frames it loaded, the sweep stopping on the global frame count; a
profiler trace is written per rank. Under a 'model' axis
(`system.num_model_shards > 1`, parallel/mesh.py) the processes of a
model group load the same rows (by their data index) and compute one W
slab each; only the first of them (model index 0) writes the group's
label files and images, so none is written twice. The exp dir must be given
(`exp_dir`): numbering one would race. Unlike the JAX multi-host trainer,
the staging thread stays: it only copies to the device and issues no
collective, while the main thread issues every collective in the same
order on every process.

With `train.host_voxelize` the pipeline workers build each frame's voxel
table on the host (data/dataset.py), and the staging thread uploads it
with the rest of the batch; the step then skips its own voxelization.

The images (front view with predicted and ground-truth boxes, BEV
occupancy with boxes, score heatmap) are drawn by `utils/viz.py` on the
numpy rasterizer and written by `utils/image_io.py`, so no cv2 is needed.
The triplets are `<tag>_front.png`, `<tag>_bv.png` and `<tag>_heatmap.png`
(the JAX trainer writes `.jpg` through cv2). Unlike the JAX trainer's,
the drawing is not best-effort: only a missing (or empty) camera image
skips the front view, and any other failure raises.
"""

from __future__ import annotations

import collections
import datetime
import os
import queue
import threading
import time

import numpy as np
import torch

from voxelnet_tpu_torch.config import VoxelNetConfig, resolve_plan
from voxelnet_tpu_torch.data.dataset import KITTIDataset, make_batch_iterator
from voxelnet_tpu_torch.data.pipeline import LazyBatchIterator
from voxelnet_tpu_torch.models.voxelnet import Detections
from voxelnet_tpu_torch.ops import box_coding, nms
from voxelnet_tpu_torch.ops.anchors import anchors_flat
from voxelnet_tpu_torch.ops.voxelize import (POINT_I16_SCALES,
                                             quantize_points_i16)
from voxelnet_tpu_torch.parallel import distributed
from voxelnet_tpu_torch.parallel.mesh import process_mesh
from voxelnet_tpu_torch.training import checkpoint as ckpt_lib
from voxelnet_tpu_torch.training.train_step import (_device, create_train_state,
                                                    make_eval_step,
                                                    make_train_step)
from voxelnet_tpu_torch.utils import image_io, kitti, viz


def make_exp_dir(base: str = "exps") -> str:
    """exps/YYYY-MM-DD-NNN, the numbered dir claimed with an atomic mkdir
    so two processes starting at once cannot share it."""
    os.makedirs(base, exist_ok=True)
    date = datetime.datetime.now().strftime("%Y-%m-%d")
    i = 0
    while True:
        exp_dir = os.path.join(base, f"{date}-{i:03d}")
        try:
            os.mkdir(exp_dir)
            break
        except FileExistsError:
            i += 1
    for sub in ("checkpoints", "logs", "vis", "preds"):
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
    return exp_dir


def make_decode_fn(config: VoxelNetConfig, device="cuda"):
    """-> fn(probs (B, H', W', 2), deltas (B, H', W', 14)) -> (NMS
    Detections, per-frame candidate counts). The count (anchors at or
    above the score threshold, before top-k) is saturation telemetry:
    above rpn.nms_pre_topk, the top-k dropped candidates."""
    device = _device(device)
    anchors = torch.from_numpy(anchors_flat(config.object)).to(device)
    obj, rpn_cfg = config.object, config.rpn

    @torch.no_grad()
    def decode(probs: torch.Tensor, deltas: torch.Tensor):
        b = probs.shape[0]
        boxes = box_coding.decode_deltas(
            deltas.reshape(b, -1, 7), anchors, obj.anchor_h,
            yaw_mode=config.train.yaw_encoding)
        flat_probs = probs.reshape(b, -1)
        n_candidates = (flat_probs >= rpn_cfg.score_thres).sum(-1)
        res = nms.nms_bev(boxes, flat_probs, score_thresh=rpn_cfg.score_thres,
                          iou_thresh=rpn_cfg.nms_thres,
                          pre_topk=rpn_cfg.nms_pre_topk,
                          post_topk=rpn_cfg.nms_post_topk,
                          mode=rpn_cfg.nms_mode)
        return Detections(res.boxes, res.scores, res.valid), n_candidates

    return decode


class Stager:
    """Iterate (host batch, staged batch) with up to `depth` batches of
    `source` (any iterator) staged ahead by a background thread
    ("batch-staging"). `close()` stops the thread: it drops what it holds
    at its next put or batch, closes its source, and is joined for at
    most `timeout` seconds. Errors of the source or of `stage` are raised
    to the consumer in order."""

    _DONE = object()

    def __init__(self, source, stage, depth: int):
        self._source = source
        self._stage = stage
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="batch-staging")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        try:
            for batch in self._source:
                if self._stop.is_set() or not self._put(
                        (batch, self._stage(batch))):
                    return
        except Exception as e:  # raised again on the consumer's thread
            self._error = e
        finally:
            try:
                _close(self._source)
            finally:
                self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


def _close(source) -> None:
    """Stop a batch source that can be stopped (the pipeline's
    LazyBatchIterator, a generator)."""
    close = getattr(source, "close", None)
    if close is not None:
        close()


def _staged_inline(source, stage, depth: int):
    """The same stream as Stager, staged on the consumer's thread
    (train.staging_thread=False)."""
    try:
        staged = collections.deque()
        for batch in source:
            staged.append((batch, stage(batch)))
            if len(staged) > depth:
                yield staged.popleft()
        while staged:
            yield staged.popleft()
    finally:
        _close(source)


def _summary_writer(logdir: str):
    """A TensorBoard writer from tensorboardX or torch.utils.tensorboard,
    or None when neither imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(logdir)


class Trainer:
    """One training run of one class config. `timings` keeps, per run:
    `first_batch_s` (epoch start to its first step call: the pipeline's
    first batch), `host_gap_s` (host time from the end of one train-step
    call to the start of the next: waiting for the staged batch, logging),
    `epoch_s` and `epoch_steps` (epoch start to its last step done on the
    device), `checkpoint_s`, and `val_dump_s` with `val_dump_frames` (the
    frames this process dumped)."""

    def __init__(self, config: VoxelNetConfig, train_dir: str, val_dir: str,
                 exp_base: str = "exps", resume_from: str | None = None,
                 exp_dir: str | None = None, device="cuda"):
        plan = resolve_plan(config, train=True)
        self.config = config
        self.device = _device(device)
        self._is_main = plan.rank == 0
        self.mesh = process_mesh(config.system)
        self._shard = self.mesh.process_shard()
        if exp_dir is not None:
            self.exp_dir = exp_dir
            for sub in ("checkpoints", "logs", "vis", "preds"):
                os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
        elif plan.world_size > 1:
            raise ValueError(
                f"training in {plan.world_size} processes needs an explicit "
                "exp_dir (--exp-dir) shared by all of them: numbering "
                "exps/DATE-NNN in each process would race")
        else:
            self.exp_dir = make_exp_dir(exp_base)
        if self._is_main:
            with open(os.path.join(self.exp_dir, "config.yaml"), "w") as f:
                f.write(config.dump_yaml())

        self.train_ds = KITTIDataset(
            train_dir, config, augment=config.train.augment,
            host_voxelize=config.train.host_voxelize)
        self.val_ds = KITTIDataset(val_dir, config, augment=False,
                                   host_voxelize=config.train.host_voxelize)
        self.steps_per_epoch = max(
            1, len(self.train_ds) // config.train.batch_size)

        self.state = create_train_state(config, seed=config.train.seed,
                                        device=self.device)
        distributed.broadcast_state_(self.state.model,
                                     self.state.opt_state)
        self.train_step = make_train_step(config, self.device,
                                          self.steps_per_epoch)
        self.eval_step = make_eval_step(config, self.device)
        self.decode_fn = make_decode_fn(config, self.device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # host work on the pipeline threads, overlapped with device steps:
        # target assignment (train.host_targets) and the i16q quantization
        # of augmented (f32) points
        transforms = []
        if config.train.host_targets:
            from voxelnet_tpu_torch.ops.targets import TargetPrecomputer
            transforms.append(TargetPrecomputer(config))
        if config.train.upload_points == "i16q":
            transforms.append(_quantize_points)
        self.batch_transform = None
        if transforms:
            def chain(batch, _ts=tuple(transforms)):
                for t in _ts:
                    batch = t(batch)
                return batch
            self.batch_transform = chain

        self.ckpt = ckpt_lib.CheckpointManager(
            os.path.join(self.exp_dir, "checkpoints"),
            keep=config.train.keep_checkpoints, config=config)
        self.start_epoch = 0
        self._resume_min_loss = float("inf")
        if resume_from:
            mgr = ckpt_lib.CheckpointManager(resume_from, config=config)
            mgr.restore(self.state)
            distributed.broadcast_state_(self.state.model,
                                         self.state.opt_state)
            self.start_epoch = self.state.step // self.steps_per_epoch
            # keep the best val loss of the run before the resume
            best = mgr.best_metric("val_loss")
            if best is not None:
                self._resume_min_loss = best
        self.timings: dict[str, list[float]] = collections.defaultdict(list)
        self._val_iter = None
        self.summary = (_summary_writer(os.path.join(self.exp_dir, "logs"))
                        if self._is_main else None)

    def close(self):
        """Close the summary writer. Idempotent."""
        if self.summary is not None:
            self.summary.close()
            self.summary = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- staging -----------------------------------------------------------
    def _host_to_device(self, batch: dict):
        """Stage a host batch's arrays: (tensors, CUDA event or None). On
        a CUDA device, pinned copies go up by non_blocking copies on the
        side stream, and the event marks their end."""
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        if self._copy_stream is None:
            return {k: torch.from_numpy(v) for k, v in arrays.items()}, None
        with torch.cuda.stream(self._copy_stream):
            tensors = {k: torch.from_numpy(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in arrays.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return tensors, ready

    def _on_step_stream(self, staged) -> dict:
        """Make the staged tensors safe to read on the current stream: it
        waits for their copies, and the allocator keeps their memory until
        the work queued on it now is done."""
        tensors, ready = staged
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors

    def _device_batch(self, batch: dict) -> dict:
        return self._on_step_stream(self._host_to_device(batch))

    def _staged_batches(self, it):
        depth = max(1, self.config.train.staging_depth)
        if self.config.train.staging_thread:
            return Stager(it, self._host_to_device, depth)
        return _staged_inline(it, self._host_to_device, depth)

    # -- metrics -----------------------------------------------------------
    @staticmethod
    def _fetch_metrics(metrics: dict) -> dict:
        """A dict of device scalars -> floats in one transfer (stacked on
        the device, one copy to the host): a float() per tensor would
        synchronize once each. The steps' metrics are already global (the
        step all-reduced them), so this is a local copy on every rank."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        fetched = {}
        if keys:
            vec = torch.stack([metrics[k].detach().to(torch.float64)
                               for k in keys]).cpu()
            fetched = dict(zip(keys, vec.tolist()))
        return {k: fetched[k] if k in fetched else float(v)
                for k, v in metrics.items()}

    def _log(self, group: str, metrics: dict, step: int):
        if self.summary is not None:
            if any(isinstance(v, torch.Tensor) for v in metrics.values()):
                metrics = self._fetch_metrics(metrics)
            for k, v in metrics.items():
                self.summary.add_scalar(f"{group}/{k}", float(v), step)

    # -- main loop ---------------------------------------------------------
    def _next_val_batch(self):
        """Next sampled-validation batch, cycling the val set; None when
        the val set is smaller than one val batch."""
        bs = self.config.val.batch_size
        if self._val_iter is None:
            self._val_iter = make_batch_iterator(
                self.val_ds, bs, shuffle=False, process_shard=self._shard)
        batch = next(self._val_iter, None)
        if batch is None:
            self._val_iter = make_batch_iterator(
                self.val_ds, bs, shuffle=False, process_shard=self._shard)
            batch = next(self._val_iter, None)
        return batch

    def _validate(self, val_batch, step: int, images: bool = False) -> float:
        """The val loss of one global val batch (the same on every rank);
        with `images`, the batch's first frame's prediction images go to
        TensorBoard too."""
        vmet, probs, deltas = self.eval_step(self.state,
                                             self._device_batch(val_batch))
        vmet = self._fetch_metrics(vmet)
        self._log("validate", vmet, step)
        if images:
            self._log_prediction_images(val_batch, probs, deltas, step)
        return float(vmet["loss"])

    # -- prediction images -------------------------------------------------
    def _calib(self, tag: str):
        """(P2, Tr_velo_to_cam, R0_rect) of a frame, or Nones (the default
        calibration) where data.calib_dir holds no file for it."""
        path = os.path.join(self.config.data.calib_dir, tag + ".txt")
        return kitti.load_calib(path) if os.path.exists(path) else (
            None, None, None)

    def _vis_images(self, batch: dict, b: int, pred_boxes: np.ndarray,
                    probs: np.ndarray, calib) -> dict:
        """RGB images of frame b of a host batch: 'front' (the camera
        image with predicted and ground-truth boxes; absent when the val
        split's image_2/<tag>.png is missing or empty, a placeholder that
        cv2.imread reads as None too), 'bv' (BEV occupancy with boxes, 2x)
        and 'heatmap' (the summed scores, 2x). Any other file that is not
        an 8-bit PNG raises."""
        obj = self.config.object
        tag = batch["tags"][b]
        gt = np.asarray(batch["gt_boxes"][b])[np.asarray(batch["gt_mask"][b])]
        points = np.asarray(batch["points"][b])[: int(batch["num_points"][b])]
        if points.dtype == np.int16:      # the i16q wire format
            points = points.astype(np.float32) * np.asarray(
                POINT_I16_SCALES, np.float32)
        P, Tr, R = calib
        out = {}
        img_path = os.path.join(self.val_ds.data_dir, "image_2", tag + ".png")
        if os.path.exists(img_path) and os.path.getsize(img_path):
            out["front"] = viz.draw_boxes3d_on_image(
                image_io.read_png_bgr(img_path), pred_boxes, gt, P2=P,
                T_VELO_2_CAM=Tr, R_RECT_0=R)
        bev = viz.lidar_to_bev_image(points, obj, factor=2)
        out["bv"] = viz.draw_boxes3d_on_bev(bev, pred_boxes, obj,
                                            gt_boxes3d=gt, factor=2)
        out["heatmap"] = viz.colorize_heatmap(probs.transpose(2, 0, 1),
                                              factor=2)
        return out

    def _log_prediction_images(self, batch: dict, probs, deltas, step: int):
        """TensorBoard images of the first frame of a sampled val batch:
        front view with predicted and ground-truth boxes, BEV, score
        heatmap (reference voxelnet/model.py:396-416, train.py:187-192).
        Written where the summary writer exists (rank 0)."""
        if self.summary is None:
            return
        det, _ = self.decode_fn(probs[:1], deltas[:1])
        boxes = det.boxes[0][det.valid[0]].cpu().numpy()
        images = self._vis_images(batch, 0, boxes, probs[0].float().cpu()
                                  .numpy(), self._calib(batch["tags"][0]))
        for key, name in (("front", "front_view_rgb"),
                          ("bv", "bird_view_lidar"),
                          ("heatmap", "bird_view_heatmap")):
            if key in images:
                self.summary.add_image(f"predict/{name}",
                                       images[key].transpose(2, 0, 1), step)

    def train(self, print_interval: int = 100, summary_interval: int = 100,
              val_interval: int = 100, dump_val_labels: bool = True,
              profile_steps: tuple[int, int] | None = None,
              num_vis_dump: int = 0):
        """Run epochs start_epoch .. train.num_epochs - 1.

        profile_steps: optional (start, stop) global-step window traced by
        torch.profiler (CPU, and CUDA on a card) into <exp_dir>/logs as a
        Chrome trace (`*.pt.trace.json`), each step in it a
        `voxelnet.train` range over its stages' ranges (tracing.py).
        num_vis_dump: image triplets of the first val frames written with
        each epoch's label dump (see dump_val_predictions).
        """
        cfg = self.config
        min_loss = self._resume_min_loss
        global_step = self.state.step
        self._val_iter = None
        profiler = None
        try:
            for epoch in range(self.start_epoch, cfg.train.num_epochs):
                epoch_start = time.perf_counter()
                tot_val_loss, tot_val_times = 0.0, 0
                self.train_ds.set_epoch(epoch)
                it = LazyBatchIterator(
                    self.train_ds, cfg.train.batch_size, shuffle=True,
                    seed=cfg.train.seed + epoch,
                    workers=cfg.train.num_workers,
                    transform=self.batch_transform,
                    process_shard=self._shard)
                staged = self._staged_batches(it)
                steps = 0
                step_end = None
                try:
                    for i, (batch, uploaded) in enumerate(staged):
                        if profile_steps is not None:
                            if (global_step == profile_steps[0]
                                    and profiler is None):
                                profiler = self._start_profiler()
                            elif (global_step >= profile_steps[1]
                                  and profiler is not None):
                                profiler.stop()
                                profiler = None
                        step_start = time.perf_counter()
                        if step_end is None:
                            self.timings["first_batch_s"].append(
                                step_start - epoch_start)
                        else:
                            self.timings["host_gap_s"].append(
                                step_start - step_end)
                        args = (self.state, self._on_step_stream(uploaded))
                        # inside the profiler's window the step records
                        # its spans, each a `voxelnet.*` range of the trace
                        self.state, metrics = (
                            self.train_step(*args) if profiler is None
                            else self.train_step(*args, []))
                        step_end = time.perf_counter()
                        global_step += 1
                        steps += 1

                        want_print = ((i + 1) % print_interval == 0
                                      and self._is_main)
                        want_summary = ((i + 1) % summary_interval == 0
                                        and self.summary is not None)
                        if want_print or want_summary or cfg.train.debug_nans:
                            m = self._fetch_metrics(metrics)
                            if cfg.train.debug_nans and not all(
                                    np.isfinite(list(m.values()))):
                                raise FloatingPointError(
                                    f"non-finite train metrics at step "
                                    f"{global_step}: {m}")
                        if want_print:
                            print(f"Train {i + 1} @ epoch {epoch + 1}/"
                                  f"{cfg.train.num_epochs} - loss "
                                  f"{m['loss']:.4f} | reg {m['reg_loss']:.4f}"
                                  f" | cls {m['cls_loss']:.4f}")
                        if want_summary:
                            self._log("train", m, global_step)
                            # static-cap saturation counters: nonzero means
                            # max_points / max_gt_boxes truncated silently
                            self._log("saturation", {
                                "clipped_points": batch.get(
                                    "clipped_points", 0),
                                "clipped_gt": batch.get("clipped_gt", 0),
                            }, global_step)
                        if (i + 1) % val_interval == 0:
                            val_batch = self._next_val_batch()
                            if val_batch is None:
                                # val set smaller than one val batch
                                continue
                            tot_val_loss += self._validate(
                                val_batch, global_step, images=True)
                            tot_val_times += 1
                finally:
                    staged.close()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.timings["epoch_s"].append(
                    time.perf_counter() - epoch_start)
                self.timings["epoch_steps"].append(steps)

                if tot_val_times == 0:
                    # epoch shorter than val_interval: still sample one val
                    # batch so best tracking works
                    val_batch = self._next_val_batch()
                    if val_batch is not None:
                        tot_val_loss += self._validate(val_batch,
                                                       global_step)
                        tot_val_times += 1

                avg_val = (tot_val_loss / tot_val_times
                           if tot_val_times else None)
                is_best = avg_val is not None and avg_val < min_loss
                if avg_val is not None:
                    min_loss = min(avg_val, min_loss)
                t0 = time.perf_counter()
                self.ckpt.save(
                    epoch, self.state,
                    {"val_loss": avg_val} if avg_val is not None else {})
                self.timings["checkpoint_s"].append(time.perf_counter() - t0)

                if dump_val_labels:
                    self.dump_val_predictions(epoch,
                                              num_vis_dump=num_vis_dump)

                val_str = f"{avg_val:.4f}" if avg_val is not None else "n/a"
                if self._is_main:
                    print(f"Epoch {epoch + 1} time "
                          f"{time.perf_counter() - epoch_start:.1f}s "
                          f"avg_val_loss {val_str} best={is_best}")
        finally:
            if profiler is not None:
                profiler.stop()

    def _start_profiler(self):
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        worker = (f"rank{distributed.rank()}"
                  if self.mesh.world_size > 1 else None)
        profiler = profile(activities=activities, on_trace_ready=(
            tensorboard_trace_handler(os.path.join(self.exp_dir, "logs"),
                                      worker_name=worker)))
        profiler.start()
        return profiler

    def dump_val_predictions(self, epoch: int, max_frames: int | None = None,
                             num_vis_dump: int = 0) -> None:
        """Full validation sweep -> one KITTI label file per frame in
        <exp_dir>/preds/<epoch + 1>/data, the count of frames whose
        candidates exceeded rpn.nms_pre_topk, and image triplets of the
        first `num_vis_dump` frames this process dumps in <exp_dir>/vis/
        <epoch + 1> (see _dump_vis_triplet). Several batch shards each
        write the frames they loaded (in a model group, its process of
        model index 0 alone: every member runs the sweep's steps, which
        exchange halos); `max_frames` counts global frames, so every
        process stops after the same batch."""
        cfg = self.config
        writes = self.mesh.model_index == 0
        t0 = time.perf_counter()
        out_dir = os.path.join(self.exp_dir, "preds", str(epoch + 1), "data")
        os.makedirs(out_dir, exist_ok=True)
        vis_dir = os.path.join(self.exp_dir, "vis", str(epoch + 1))
        vis_count = 0
        seen = global_seen = 0
        nms_saturated = 0
        for batch in make_batch_iterator(
                self.val_ds, cfg.val.batch_size, shuffle=False,
                drop_remainder=False, process_shard=self._shard):
            if max_frames and global_seen >= max_frames:
                break
            global_seen += batch["num_real"]
            _, probs, deltas = self.eval_step(self.state,
                                              self._device_batch(batch))
            det, n_cand = self.decode_fn(probs, deltas)
            boxes, scores, valid, n_cand = (
                t.cpu().numpy() for t in (det.boxes, det.scores, det.valid,
                                          n_cand))
            num_real = self.mesh.local_num_real(batch["num_real"],
                                                cfg.val.batch_size)
            nms_saturated += int((n_cand[:num_real]
                                  > cfg.rpn.nms_pre_topk).sum())
            if not writes:
                seen += num_real
                continue
            host_probs = (probs.float().cpu().numpy()
                          if vis_count < num_vis_dump else None)
            for b, tag in enumerate(batch["tags"][:num_real]):
                keep = valid[b]
                calib = self._calib(tag)
                P, Tr, R = calib
                lines = kitti.boxes_to_label_lines(
                    boxes[b][keep], [cfg.object.name] * int(keep.sum()),
                    scores=scores[b][keep], coordinate="lidar",
                    P2=P, T_VELO_2_CAM=Tr, R_RECT_0=R)
                with open(os.path.join(out_dir, tag + ".txt"), "w") as f:
                    f.writelines(lines)
                if vis_count < num_vis_dump:
                    self._dump_vis_triplet(vis_dir, batch, b, boxes[b][keep],
                                           host_probs[b], calib)
                    vis_count += 1
                seen += 1
        self.timings["val_dump_s"].append(time.perf_counter() - t0)
        self.timings["val_dump_frames"].append(seen if writes else 0)
        if self._shard is not None:
            seen, nms_saturated = (int(v) for v in distributed.all_reduce_(
                [torch.tensor([seen, nms_saturated], device=self.device)],
                self.mesh.data_group)[0])
        if nms_saturated and self._is_main:
            print(f"[saturation] nms_pre_topk dropped candidates on "
                  f"{nms_saturated}/{seen} val frames — consider raising "
                  f"rpn.nms_pre_topk")
        if self.summary is not None:
            self.summary.add_scalar(
                "saturation/nms_pre_topk_frames", nms_saturated, epoch + 1)

    def _dump_vis_triplet(self, vis_dir: str, batch: dict, b: int,
                          pred_boxes: np.ndarray, probs: np.ndarray,
                          calib) -> None:
        """Write <tag>_front.png (when the camera image exists),
        <tag>_bv.png and <tag>_heatmap.png, as the reference's per-epoch
        vis dump (voxelnet/train.py:238-259) writes its JPEGs."""
        os.makedirs(vis_dir, exist_ok=True)
        tag = batch["tags"][b]
        for key, rgb in self._vis_images(batch, b, pred_boxes, probs,
                                         calib).items():
            image_io.write_png_rgb(os.path.join(vis_dir, f"{tag}_{key}.png"),
                                   rgb)


def _quantize_points(batch: dict) -> dict:
    """Pipeline transform: f32 points (augmented examples) -> the int16
    wire format on the worker thread."""
    pts = batch.get("points")
    if pts is not None and pts.dtype == np.float32:
        batch = dict(batch, points=quantize_points_i16(pts))
    return batch
