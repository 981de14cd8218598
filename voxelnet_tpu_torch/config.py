"""Configuration for the PyTorch port: the port's own copy of the JAX
package's config surface (`voxelnet_tpu/config.py`: the same frozen
dataclasses, field names, defaults and per-class presets), plus the port's
backend resolver.

The copy is held to the original by `tests/test_torch_train.py`
(`to_dict()` equal for every preset and for override sets), so the two
cannot drift apart. Overrides go through `get_config(class_name,
**overrides)` or an override file (`merge_from_file`): the card's machine
has no pyyaml, so override files and the `dump_yaml` snapshot use the
subset of YAML that `utils/yaml_subset.py` reads and writes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, NamedTuple

import numpy as np

from voxelnet_tpu_torch.parallel.mesh import process_mesh
from voxelnet_tpu_torch.parallel.spatial import slab
from voxelnet_tpu_torch.utils import yaml_subset

# mean KITTI calibration matrices (per-frame calib files override them)
_T_VELO_2_CAM = (
    (7.49916597e-03, -9.99971248e-01, -8.65110297e-04, -6.71807577e-03),
    (1.18652889e-02, 9.54520517e-04, -9.99910318e-01, -7.33152811e-02),
    (9.99882833e-01, 7.49141178e-03, 1.18719929e-02, -2.78557062e-01),
    (0.0, 0.0, 0.0, 1.0),
)
_R_RECT_0 = (
    (0.99992475, 0.00975976, -0.00734152, 0.0),
    (-0.0097913, 0.99994262, -0.00430371, 0.0),
    (0.00729911, 0.0043753, 0.99996319, 0.0),
    (0.0, 0.0, 0.0, 1.0),
)
_MATRIX_P2 = (
    (719.787081, 0.0, 608.463003, 44.9538775),
    (0.0, 719.787081, 174.545111, 0.1066855),
    (0.0, 0.0, 1.0, 3.0106472e-03),
    (0.0, 0.0, 0.0, 0.0),
)


@dataclass(frozen=True)
class SystemConfig:
    num_workers: int = 4
    mesh_axis_data: str = "data"
    mesh_axis_model: str = "model"
    num_data_shards: int = 1
    num_model_shards: int = 1
    num_dcn_shards: int = 1


@dataclass(frozen=True)
class DataConfig:
    dir: str = "/data/kitti/MD_KITTI"
    calib_dir: str = "/data/kitti/KITTI/training/calib"
    max_points: int = 65536       # N bucket: points fed to the voxelizer
    max_voxels: int = 16384       # K bucket: occupied voxels kept per frame
    max_gt_boxes: int = 64        # padded ground-truth boxes per frame
    shuffle_points: bool = True
    crop_to_grid: bool = True     # drop out-of-grid points before the cap
    # lowering knobs of the JAX package; the port maps every accepted
    # value onto its one path (resolve_plan), but for middle_backend
    # 'sparse1', which it runs as a path of its own
    voxelizer_backend: str = "auto"
    vfe_backend: str = "auto"
    train_vfe_backend: str = "auto"
    bev_fold: str = "auto"
    middle_backend: str = "auto"
    host_voxelizer: str = "auto"
    scatter_hints: bool = True
    cache_frames_mb: int = 512
    dense_build: str = "auto"
    fold_bn: str = "auto"         # eval-time BN fold: 'auto' | 'on' | 'off'


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 2
    num_workers: int = 8
    lr: float = 0.01
    lr_scheduler_step: int = 150      # epoch at which LR drops 10x
    alpha: float = 1.5                # positive-class CE weight
    beta: float = 1.0                 # negative-class CE weight
    sigma: float = 3.0                # smooth-L1 transition sharpness
    num_epochs: int = 10
    gradient_clip: float = 5.0
    augment: bool = False
    seed: int = 0
    compute_dtype: str = "bfloat16"   # params stay f32
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 1000
    debug_nans: bool = False
    host_targets: bool = False
    host_voxelize: bool = False
    upload_points: str = "i16q"       # 'f32' | 'i16q' (int16 wire format)
    staging_depth: int = 3
    yaw_encoding: str = "delta"       # 'delta' | 'sin'
    staging_thread: bool = True
    remat: str = "none"               # 'none' | 'seams' | 'full'


@dataclass(frozen=True)
class ValConfig:
    batch_size: int = 2
    num_workers: int = 4


@dataclass(frozen=True)
class ImageConfig:
    width: int = 1242
    height: int = 375
    channels: int = 3


@dataclass(frozen=True)
class ObjectConfig:
    """Per-class detection geometry."""

    name: str = "Car"
    z_min: float = -3.0
    z_max: float = 1.0
    y_min: float = -40.0
    y_max: float = 40.0
    x_min: float = 0.0
    x_max: float = 70.4
    z_voxel_size: float = 0.4
    y_voxel_size: float = 0.2
    x_voxel_size: float = 0.2
    points_per_voxel: int = 35
    feature_ratio: int = 2
    anchor_l: float = 3.9
    anchor_w: float = 1.6
    anchor_h: float = 1.56
    anchor_z: float = -1.0 - 1.56 / 2
    rpn_pos_iou: float = 0.6
    rpn_neg_iou: float = 0.45
    anchors_per_cell: int = 2   # yaw 0 and 90 degrees

    @property
    def depth(self) -> int:
        return int(round((self.z_max - self.z_min) / self.z_voxel_size))

    @property
    def height(self) -> int:
        return int(round((self.y_max - self.y_min) / self.y_voxel_size))

    @property
    def width(self) -> int:
        return int(round((self.x_max - self.x_min) / self.x_voxel_size))

    @property
    def feature_height(self) -> int:
        return self.height // self.feature_ratio

    @property
    def feature_width(self) -> int:
        return self.width // self.feature_ratio

    @property
    def grid_size(self) -> tuple[int, int, int]:
        """(D, H, W) voxel grid extents in (z, y, x) order."""
        return (self.depth, self.height, self.width)

    @property
    def voxel_size_zyx(self) -> tuple[float, float, float]:
        return (self.z_voxel_size, self.y_voxel_size, self.x_voxel_size)

    @property
    def lidar_offset(self) -> tuple[float, float, float]:
        """Shift applied to (x, y, z) so grid indices start at 0."""
        return (-self.x_min, -self.y_min, -self.z_min)

    @property
    def num_anchors(self) -> int:
        return self.feature_height * self.feature_width * self.anchors_per_cell


OBJECT_PRESETS = {
    "Car": ObjectConfig,
    "Pedestrian": lambda: ObjectConfig(
        name="Pedestrian", y_min=-20.0, y_max=20.0, x_min=0.0, x_max=48.0,
        points_per_voxel=45, anchor_l=0.8, anchor_w=0.6, anchor_h=1.73,
        anchor_z=-0.6 - 1.73 / 2, rpn_pos_iou=0.5, rpn_neg_iou=0.35),
    "Cyclist": lambda: ObjectConfig(
        name="Cyclist", y_min=-20.0, y_max=20.0, x_min=0.0, x_max=48.0,
        points_per_voxel=45, anchor_l=1.76, anchor_w=0.6, anchor_h=1.73,
        anchor_z=-0.6 - 1.73 / 2, rpn_pos_iou=0.5, rpn_neg_iou=0.35),
}


@dataclass(frozen=True)
class RPNConfig:
    nms_post_topk: int = 20
    nms_thres: float = 0.1
    score_thres: float = 0.96
    nms_pre_topk: int = 256
    nms_mode: str = "rotated"         # 'rotated' | 'standup'
    block1_stride: int = 2


@dataclass(frozen=True)
class CalibConfig:
    t_velo_2_cam: tuple = _T_VELO_2_CAM
    r_rect_0: tuple = _R_RECT_0
    matrix_p2: tuple = _MATRIX_P2

    def T_VELO_2_CAM(self) -> np.ndarray:
        return np.asarray(self.t_velo_2_cam, dtype=np.float64)

    def R_RECT_0(self) -> np.ndarray:
        return np.asarray(self.r_rect_0, dtype=np.float64)

    def MATRIX_P2(self) -> np.ndarray:
        return np.asarray(self.matrix_p2, dtype=np.float64)


@dataclass(frozen=True)
class CompatConfig:
    """Flags that reproduce the reference's documented quirks; each
    defaults to the corrected semantics."""

    buggy_anchor_standup: bool = False
    buggy_smooth_l1: bool = False
    iou_plus_one: bool = False
    bn_over_padding: bool = False
    raster_collision: bool = False


@dataclass(frozen=True)
class VoxelNetConfig:
    system: SystemConfig = field(default_factory=SystemConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    val: ValConfig = field(default_factory=ValConfig)
    image: ImageConfig = field(default_factory=ImageConfig)
    object: ObjectConfig = field(default_factory=ObjectConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    calib: CalibConfig = field(default_factory=CalibConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump_yaml(self) -> str:
        return yaml_subset.dump(self.to_dict())

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VoxelNetConfig":
        return _merge_dataclass(cls(), d)

    def merge_from_file(self, path: str) -> "VoxelNetConfig":
        with open(path) as f:
            overrides = yaml_subset.load(f.read()) or {}
        return _merge_dataclass(self, overrides)


def _merge_dataclass(obj, overrides: Mapping[str, Any]):
    """Recursively apply a nested dict of overrides to a frozen dataclass."""
    updates = {}
    field_names = {f.name for f in dataclasses.fields(obj)}
    for key, value in overrides.items():
        if key not in field_names:
            raise KeyError(
                f"Unknown config key {key!r} for {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _merge_dataclass(current, value)
        else:
            updates[key] = value
    return replace(obj, **updates)


def get_config(class_name: str = "Car", **overrides) -> VoxelNetConfig:
    """Config for one of the KITTI classes, with nested-dict overrides."""
    if class_name not in OBJECT_PRESETS:
        raise ValueError(
            f"Unknown class {class_name!r}; expected one of "
            f"{sorted(OBJECT_PRESETS)}")
    cfg = VoxelNetConfig(object=OBJECT_PRESETS[class_name]())
    if overrides:
        cfg = _merge_dataclass(cfg, overrides)
    return cfg


MIDDLE_BACKENDS = ("auto", "conv3d", "folded2d", "tap2d", "sparse1",
                   "sparsebwd", "wpack", "wpack2")
BEV_FOLDS = ("auto", "transpose", "dsplit")
VFE_BACKENDS = ("auto", "xla", "fused")
DENSE_BUILDS = ("auto", "scatter", "pallas")
FOLD_BN = ("auto", "on", "off")
TRAIN_VFE_BACKENDS = ("auto", "xla", "planar")
VOXELIZER_BACKENDS = ("auto", "xla", "gather", "pallas", "pallas_interpret",
                      "planar", "planar_interpret")
COMPUTE_DTYPES = ("bfloat16", "float32", "float64")
REMATS = ("none", "seams", "full")


class Plan(NamedTuple):
    """What a config selects on the port's path: the run-copy voxel table
    (train/eval steps), the fused VFE kernel (inference), the middle's
    block 1 (the streaming dense-grid kernel and an nn.Conv3d, or
    'sparse1''s sparse conv of the voxel table), blocks 2-3 (nn.Conv3d)
    and the depth->BEV fold as a reshape of NCDHW; and the processes the
    mesh runs on (parallel/mesh.py)."""

    fold_bn: bool    # data.fold_bn: 'off' keeps the separate BN ops
    dtype: str       # train.compute_dtype
    world_size: int = 1   # processes, one card each (dcn x data x model)
    rank: int = 0
    # 'sparse1' for data.middle_backend='sparse1'; 'conv3d' for every other
    # value, 'auto' included, as the JAX resolver answers off the TPU
    middle: str = "conv3d"


def middle_path(middle_backend: str) -> str:
    """data.middle_backend -> the port's middle: 'sparse1' (block 1 from
    the voxel table, models/sparse_conv.py) or 'conv3d' for every other
    accepted value. 'auto' stays 'conv3d', the JAX resolver's answer off
    the TPU (`voxelnet_tpu/models/voxelnet.py:226-236`)."""
    return "sparse1" if middle_backend == "sparse1" else "conv3d"


def _check(name: str, value: str, allowed: tuple[str, ...]) -> None:
    if value not in allowed:
        raise ValueError(f"data.{name}={value!r} — expected one of {allowed}")


def resolve_plan(config: VoxelNetConfig, train: bool = False) -> Plan:
    """Map every accepted value of the JAX package's lowering knobs onto
    the port's path.

    The JAX lowerings (`wpack2`, `folded2d`, `sparsebwd`, `dsplit`, the
    three Pallas run-copy layouts, ...) are the same math in TPU-friendly
    layouts; the port runs NCDHW convs, where the depth->BEV fold is a
    reshape, and one run-copy kernel for every table layout.
    `middle_backend='sparse1'` alone selects another middle: block 1
    computed from the voxel table (`Plan.middle`, `middle_path`); 'auto'
    stays conv3d. The mesh's axes (`system.num_dcn_shards x
    num_data_shards x num_model_shards`) are processes, one card each:
    their product must equal the running world size (1 without a process
    group). `compat.bn_over_padding` (the reference's ghost-activation
    VFE) takes the table VFE at inference, since the fused kernel
    implements only the masked max. Raises where the port cannot give the
    configured semantics, with the JAX resolvers' messages where they have
    one: `data.vfe_backend='fused'` with `bn_over_padding`,
    `train_vfe_backend='planar'` with `train.host_voxelize`; under a
    'model' axis (`num_model_shards > 1`, spatial W-sharding,
    parallel/spatial.py) `middle_backend='sparsebwd'`, an explicit
    `vfe_backend='fused'` or `dense_build='pallas'`, a grid W that the
    axis does not divide, or a W slab that is not a multiple of
    `rpn.block1_stride` x 4 columns (the RPN's three stride-2 stages must
    split it evenly; XLA pads instead); a mesh that is not the world size
    (parallel/mesh.py); for `train=True`, a `train.remat` other than
    'none', 'seams' or 'full'.
    """
    data = config.data
    _check("middle_backend", data.middle_backend, MIDDLE_BACKENDS)
    _check("bev_fold", data.bev_fold, BEV_FOLDS)
    _check("vfe_backend", data.vfe_backend, VFE_BACKENDS)
    _check("dense_build", data.dense_build, DENSE_BUILDS)
    _check("fold_bn", data.fold_bn, FOLD_BN)
    _check("train_vfe_backend", data.train_vfe_backend, TRAIN_VFE_BACKENDS)
    _check("voxelizer_backend", data.voxelizer_backend, VOXELIZER_BACKENDS)
    if config.compat.bn_over_padding and data.vfe_backend == "fused":
        raise ValueError(
            "data.vfe_backend='fused' is incompatible with "
            "compat.bn_over_padding (reference ghost-activation "
            "semantics) — use the 'xla' backend")
    if config.train.host_voxelize and data.train_vfe_backend == "planar":
        raise ValueError(
            "data.train_vfe_backend='planar' voxelizes on device — "
            "incompatible with train.host_voxelize (pipeline feeds "
            "pre-built (B, K, T, 7) buffers)")
    if config.system.num_model_shards > 1:
        _check_model_axis(config)
    procs = process_mesh(config.system)
    if config.train.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"train.compute_dtype={config.train.compute_dtype!r} — expected "
            f"one of {COMPUTE_DTYPES}")
    if train and config.train.remat not in REMATS:
        raise ValueError(
            f"train.remat={config.train.remat!r} — expected one of {REMATS}")
    return Plan(fold_bn=data.fold_bn != "off",
                dtype=config.train.compute_dtype,
                world_size=procs.world_size, rank=procs.rank,
                middle=middle_path(data.middle_backend))


def _check_model_axis(config: VoxelNetConfig) -> None:
    """The refusals of a 'model' mesh axis (resolve_plan)."""
    data, nm = config.data, config.system.num_model_shards
    if data.middle_backend == "sparsebwd":
        raise ValueError(
            "data.middle_backend='sparsebwd' does not partition over "
            "the spatial 'model' axis — use 'conv3d' (or 'auto') when "
            "num_model_shards > 1")
    if data.vfe_backend == "fused":
        raise ValueError(
            "data.vfe_backend='fused' does not partition over the "
            "spatial 'model' axis — use 'xla' (or 'auto') when "
            "num_model_shards > 1")
    if data.dense_build == "pallas":
        raise ValueError(
            "data.dense_build='pallas' does not partition over a "
            "mesh — use 'scatter' (or 'auto') on sharded configs")
    _, wloc = slab(config.object.grid_size[2], nm, 0)
    align = 4 * config.rpn.block1_stride
    if wloc % align:
        raise ValueError(
            f"system.num_model_shards={nm} gives W slabs of {wloc} columns, "
            f"not a multiple of rpn.block1_stride x 4 = {align}: the RPN's "
            "stride-2 stages would split a slab unevenly (the JAX package "
            "pads; the port refuses, ROADMAP.md queue 3)")
