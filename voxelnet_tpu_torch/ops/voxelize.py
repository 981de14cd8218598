"""Voxelization: host staging in numpy, the sort + run analysis in torch,
and the explicit (B, K, T, 7) voxel table of the train and eval steps.

Counterpart of `voxelnet_tpu/ops/voxelize.py` (`VoxelGridSpec`,
`in_grid_mask`, `pad_points`, the host voxelizer `voxelize_np` with
`resolve_host_voxelizer`, `POINT_I16_SCALES` with
`quantize_points_i16`/`dequantize_points_i16`,
`_sort_stage`, `_pallas_prepare` with the planar layout, `_decode_zyx`,
`_finalize`, and `voxelize_batch_jax` on the run-copy table). The
integer outputs match the JAX function exactly: the same f32 shift +
divide + floor binning, the same stable sort by linear voxel id, the same
run-start table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voxelnet_tpu_torch.kernels.run_copy import run_copy

# wire-format scales of train.upload_points='i16q': xyz at 5 mm,
# reflectance at 1/32768
POINT_I16_SCALES = (0.005, 0.005, 0.005, 1.0 / 32768.0)


class VoxelGridSpec(NamedTuple):
    """Static voxelization parameters derived from an ObjectConfig."""

    grid_dzyx: tuple[int, int, int]         # (D, H, W)
    voxel_size_zyx: tuple[float, float, float]
    offset_xyz: tuple[float, float, float]  # added to points before binning
    max_points_per_voxel: int               # T

    @classmethod
    def from_object_config(cls, obj) -> "VoxelGridSpec":
        return cls(grid_dzyx=tuple(obj.grid_size),
                   voxel_size_zyx=tuple(obj.voxel_size_zyx),
                   offset_xyz=tuple(obj.lidar_offset),
                   max_points_per_voxel=obj.points_per_voxel)


class Prepared(NamedTuple):
    """Per-batch output of `prepare` (B frames, N points, K voxel slots)."""

    sorted_planar: torch.Tensor   # (B, 4, N) f32, points sorted by voxel id
    run_start: torch.Tensor       # (B, K) i32, first sorted index; N = empty
    counts: torch.Tensor          # (B, K) i32, stored points per voxel (<= T)
    coords: torch.Tensor          # (B, K, 3) i32 zyx; (0, 0, 0) = empty
    num_voxels: torch.Tensor      # (B,) i32, occupied voxels kept (<= K)
    num_voxels_raw: torch.Tensor  # (B,) i32, occupied voxels before the cap


class Voxels(NamedTuple):
    """Batched voxel table (`voxelize_table`), or one frame's numpy table
    from the host voxelizer (`voxelize_np`: no batch axis, the voxel counts
    as ints)."""

    features: torch.Tensor        # (B, K, T, 7) f32: x, y, z, r, offsets
    coords: torch.Tensor          # (B, K, 3) i32 zyx; (0, 0, 0) = empty
    counts: torch.Tensor          # (B, K) i32, stored points (<= T)
    num_voxels: torch.Tensor      # (B,) i32, occupied voxels kept (<= K)
    num_voxels_raw: torch.Tensor  # (B,) i32, occupied voxels before the cap


def quantize_points_i16(points: np.ndarray) -> np.ndarray:
    """Host side: (..., 4) f32 points -> the int16 wire format (half the
    bytes of f32 on every host copy and the upload)."""
    scales = np.asarray(POINT_I16_SCALES, np.float32)
    q = np.rint(np.asarray(points, np.float32) / scales)
    return np.clip(q, -32768, 32767).astype(np.int16)


def dequantize_points_i16(points: torch.Tensor) -> torch.Tensor:
    """int16 wire-format points -> f32 (x POINT_I16_SCALES); any other
    dtype passes through."""
    if points.dtype != torch.int16:
        return points
    scales = torch.tensor(POINT_I16_SCALES, dtype=torch.float32,
                          device=points.device)
    return points.to(torch.float32) * scales


def in_grid_mask(points: np.ndarray, spec: VoxelGridSpec) -> np.ndarray:
    """Boolean mask of the points the voxelizer keeps: the exact f32
    shift + divide + floor binning of `prepare`, so a crop by this mask
    never disagrees with the binning at voxel boundaries."""
    D, H, W = spec.grid_dzyx
    pts = np.asarray(points, np.float32).reshape(-1, 4)
    shifted = pts[:, :3] + np.asarray(spec.offset_xyz, np.float32)
    vx = np.floor(shifted[:, 0] / np.float32(spec.voxel_size_zyx[2]))
    vy = np.floor(shifted[:, 1] / np.float32(spec.voxel_size_zyx[1]))
    vz = np.floor(shifted[:, 2] / np.float32(spec.voxel_size_zyx[0]))
    return ((vz >= 0) & (vz < D) & (vy >= 0) & (vy < H)
            & (vx >= 0) & (vx < W))


def crop_points(points: np.ndarray, spec: VoxelGridSpec) -> np.ndarray:
    pts = np.asarray(points, np.float32).reshape(-1, 4)
    return pts[in_grid_mask(pts, spec)]


def voxelize_np(points: np.ndarray, spec: VoxelGridSpec,
                max_voxels: int | None = None, shuffle: bool = False,
                rng: np.random.Generator | None = None) -> Voxels:
    """One frame on the host, with the reference's semantics
    (voxelnet/utils.py:10-100): shift the points, bin them by floor(x / s)
    in f32, crop to the grid, keep the first T points of each voxel in
    arrival order, then append the offsets from the centroid of the stored
    points. Voxels come in ascending (z * H + y) * W + x order; above
    `max_voxels` the lowest ids are kept (a cap the ragged reference does
    not have). `shuffle` permutes the points first, from `rng`.

    -> Voxels of numpy arrays: features (K, T, 7) f32, coords (K, 3) i32
    zyx, counts (K,) i32 (K = max_voxels when given, padding zeroed),
    num_voxels and num_voxels_raw as ints.
    """
    D, H, W = spec.grid_dzyx
    T = spec.max_points_per_voxel
    pts = np.asarray(points, np.float32).reshape(-1, 4)
    if shuffle:
        rng = rng or np.random.default_rng()
        pts = pts[rng.permutation(len(pts))]

    shifted = pts[:, :3] + np.asarray(spec.offset_xyz, np.float32)
    vz = np.floor(shifted[:, 2] / np.float32(spec.voxel_size_zyx[0])
                  ).astype(np.int64)
    vy = np.floor(shifted[:, 1] / np.float32(spec.voxel_size_zyx[1])
                  ).astype(np.int64)
    vx = np.floor(shifted[:, 0] / np.float32(spec.voxel_size_zyx[2])
                  ).astype(np.int64)
    inside = ((vz >= 0) & (vz < D) & (vy >= 0) & (vy < H)
              & (vx >= 0) & (vx < W))
    pts, vz, vy, vx = pts[inside], vz[inside], vy[inside], vx[inside]

    linear = (vz * H + vy) * W + vx
    uniq, inverse = np.unique(linear, return_inverse=True)
    K = len(uniq)

    # each point's slot in its voxel, in arrival order: a stable sort by
    # voxel, then the position in the run
    order = np.argsort(inverse, kind="stable")
    inv_sorted = inverse[order]
    run_start = np.r_[0, np.flatnonzero(np.diff(inv_sorted)) + 1]
    starts = np.repeat(run_start, np.diff(np.r_[run_start, len(inv_sorted)]))
    slot = np.empty(len(inv_sorted), np.int64)
    slot[order] = np.arange(len(inv_sorted)) - starts

    keep = slot < T
    features = np.zeros((K, T, 7), np.float32)
    features[inverse[keep], slot[keep], :4] = pts[keep]
    counts = np.minimum(np.bincount(inverse, minlength=K), T).astype(np.int32)

    # centroid offsets over the stored points (voxelnet/utils.py:86-88)
    centroid = features[:, :, :3].sum(axis=1, keepdims=True) / np.maximum(
        counts, 1).astype(np.float32).reshape(K, 1, 1)
    point_mask = (np.arange(T)[None, :] < counts[:, None])[..., None]
    features[:, :, 4:7] = (features[:, :, :3] - centroid) * point_mask

    coords = np.stack([uniq // (H * W), (uniq // W) % H, uniq % W],
                      axis=1).astype(np.int32)
    if max_voxels is None:
        return Voxels(features, coords, counts, K, K)
    k = min(K, max_voxels)
    feat = np.zeros((max_voxels, T, 7), np.float32)
    crd = np.zeros((max_voxels, 3), np.int32)
    cnt = np.zeros((max_voxels,), np.int32)
    feat[:k], crd[:k], cnt[:k] = features[:k], coords[:k], counts[:k]
    return Voxels(feat, crd, cnt, k, K)


HOST_VOXELIZERS = ("auto", "native", "numpy")


def resolve_host_voxelizer(configured: str = "auto"):
    """`data.host_voxelizer` -> a callable with the signature of
    `voxelize_np(points, spec, max_voxels)`: 'numpy' is `voxelize_np`;
    'native' the C++ twin (voxelnet_tpu_torch/native, built at first use
    with the host C++ compiler), and it raises when the library does not
    build; 'auto' the C++ twin when it builds and loads, else numpy. Both
    give bit-equal tables. 'auto' prints which one it took."""
    if configured not in HOST_VOXELIZERS:
        raise ValueError(f"data.host_voxelizer={configured!r}: no such host "
                         f"voxelizer, expected one of {HOST_VOXELIZERS}")
    if configured == "numpy":
        return voxelize_np
    from voxelnet_tpu_torch import native

    if configured == "native":
        native.load()               # raises with the compiler's output
        return native.voxelize_native
    fn, took = ((native.voxelize_native, f"native ({native.compiler()})")
                if native.available() else
                (voxelize_np, f"numpy (native: {native.load_error()})"))
    print(f"data.host_voxelizer='auto': {took}", flush=True)
    return fn


def pad_points(points: np.ndarray, max_points: int,
               rng: np.random.Generator | None = None,
               shuffle: bool = False):
    """(N, 4) ragged -> ((max_points, 4) f32, count). Above max_points a
    uniform random subsample (shuffle=True) or the first max_points."""
    pts = np.asarray(points, np.float32).reshape(-1, 4)
    if shuffle:
        rng = rng or np.random.default_rng()
        pts = pts[rng.permutation(len(pts))]
    n = min(len(pts), max_points)
    out = np.zeros((max_points, 4), np.float32)
    out[:n] = pts[:n]
    return out, np.int32(n)


def decode_zyx(linear_ids: torch.Tensor, spec: VoxelGridSpec) -> torch.Tensor:
    """Linear voxel ids (vz * H + vy) * W + vx -> (..., 3) zyx coords."""
    _, H, W = spec.grid_dzyx
    vx = linear_ids % W
    rest = linear_ids // W
    return torch.stack([rest // H, rest % H, vx], dim=-1)


def prepare(points: torch.Tensor, num_points: torch.Tensor,
            spec: VoxelGridSpec, max_voxels: int) -> Prepared:
    """(B, N, 4) f32 padded points + (B,) valid counts -> `Prepared`.

    Points are binned by floor(shifted / size) in f32 (a true divide: a
    reciprocal multiply rounds differently within an ulp of a voxel
    boundary), stable-sorted by linear voxel id (invalid points sort last
    under the id D*H*W), and cut into runs. Above `max_voxels` the voxels
    with the lowest ids are kept.
    """
    if points.dim() != 3 or points.shape[-1] != 4:
        raise ValueError(f"points must be (B, N, 4), got {tuple(points.shape)}")
    dev = points.device
    points = points.to(torch.float32)
    B, N, _ = points.shape
    D, H, W = spec.grid_dzyx
    T = spec.max_points_per_voxel
    K = max_voxels
    invalid = D * H * W

    offset = torch.tensor(spec.offset_xyz, dtype=torch.float32, device=dev)
    sizes = torch.tensor(
        (spec.voxel_size_zyx[2], spec.voxel_size_zyx[1],
         spec.voxel_size_zyx[0]), dtype=torch.float32, device=dev)
    vf = torch.floor((points[..., :3] + offset) / sizes)      # (B, N, 3) xyz
    limits = torch.tensor((W, H, D), dtype=torch.float32, device=dev)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    valid = ((idx[None] < num_points.to(dev, torch.int32)[:, None])
             & ((vf >= 0) & (vf < limits)).all(dim=-1))
    v = torch.where(valid[..., None], vf, 0.0).to(torch.int32)
    linear = torch.where(valid, (v[..., 2] * H + v[..., 1]) * W + v[..., 0],
                         invalid)

    sort_ids, order = torch.sort(linear, dim=1, stable=True)
    sorted_planar = torch.gather(
        points.transpose(1, 2), 2, order[:, None, :].expand(B, 4, N))
    sorted_valid = sort_ids < invalid

    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev),
                      sort_ids[:, :-1]], dim=1)
    is_start = (sort_ids != prev) & sorted_valid
    voxel_slot = torch.cumsum(is_start, dim=1, dtype=torch.int32) - 1
    num_voxels_raw = voxel_slot[:, -1] + 1
    num_voxels = torch.clamp(num_voxels_raw, max=K)

    # one table holds run starts and count boundaries: slot k < K gets the
    # start of voxel k, slot K (the first voxel over the cap) closes the
    # last kept run, every other point lands in the unread slot K + 1
    total_valid = sorted_valid.sum(dim=1, dtype=torch.int32)
    slots = torch.where(is_start & (voxel_slot <= K), voxel_slot, K + 1)
    starts = torch.full((B, K + 2), N, dtype=torch.int32, device=dev)
    starts.scatter_(1, slots.long(), idx[None].expand(B, N).contiguous())
    run_start = starts[:, :K].contiguous()
    closed = torch.minimum(starts[:, :K + 1], total_valid[:, None])
    counts = torch.clamp(closed[:, 1:] - closed[:, :-1], 0, T)

    ids_padded = torch.cat(
        [sort_ids, torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    first_ids = torch.gather(ids_padded, 1,
                             torch.clamp(run_start, max=N).long())
    coords = decode_zyx(first_ids, spec)
    return Prepared(sorted_planar, run_start, counts.to(torch.int32),
                    coords.to(torch.int32), num_voxels.to(torch.int32),
                    num_voxels_raw.to(torch.int32))


def finalize(table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Raw (B, K, T, 4) table -> (B, K, T, 7) features: rows at or past a
    voxel's count zeroed, then centroid offsets over the stored points
    (the sum divided by max(count, 1))."""
    T = table.shape[-2]
    mask = (torch.arange(T, device=table.device)
            < counts[..., None])[..., None].to(torch.float32)
    table = table * mask
    denom = torch.clamp(counts, min=1).to(torch.float32)[..., None, None]
    centroid = table[..., :3].sum(dim=-2, keepdim=True) / denom
    offsets = (table[..., :3] - centroid) * mask
    return torch.cat([table, offsets], dim=-1)


def voxelize_table(points: torch.Tensor, num_points: torch.Tensor,
                   spec: VoxelGridSpec, max_voxels: int) -> Voxels:
    """(B, N, 4) padded points + (B,) counts -> `Voxels`: `prepare`, the
    run-copy table (kernels/run_copy.py), `finalize`."""
    prep = prepare(points, num_points, spec, max_voxels)
    table = run_copy(prep.sorted_planar, prep.run_start,
                     spec.max_points_per_voxel)
    return Voxels(finalize(table, prep.counts), prep.coords, prep.counts,
                  prep.num_voxels, prep.num_voxels_raw)
