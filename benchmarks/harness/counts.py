"""The work a batch needs, counted from shapes and from the batch's own
voxels, whatever implements it; the card's published peaks; and the
least time a kernel's work can take (its bytes-once bound).

FLOPs: the VFE's two linear layers over the stored points; middle block
1 only over the (output site, tap) pairs that read an occupied voxel;
blocks 2-3, the RPN's convolutions, its transposed convolutions and the
heads dense at their shapes. A training step counts three times the
forward (backward twice the forward). Batch-norm and elementwise work
are not counted.
"""

from __future__ import annotations

import numpy as np

from benchmarks.reference import net as ref

# NVIDIA H100 SXM data sheet, dense rates at a 700 W limit: HBM3
# bandwidth, and the peak rate by operand type (bf16 on the tensor
# cores; f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MFU_PEAK = PEAK_FLOPS["bfloat16"]
# MACs per stored point of the VFE's two linear layers: 7->16, 32->64
VFE_MACS_PER_POINT = 7 * 16 + 32 * 64


def block1_taps(coords: np.ndarray, counts: np.ndarray, cfg: dict) -> int:
    """(output site, tap) pairs of middle block 1 (3x3x3, stride
    (s, 1, 1), pad (p, 1, 1)) that read an occupied voxel, over a batch's
    voxels (coords (..., 3) zyx, counts (...,): live where > 0)."""
    D, H, W = ref.grid_dzyx(cfg["object"])
    _, stride, pad = ref.MIDDLE[0]
    d_out = ref.middle_depths(D)[0]
    live = counts > 0
    z, y, x = (coords[live][:, i].astype(np.int64) for i in range(3))
    k = np.arange(3)

    def along(v, n_out, s, p):
        o = v[:, None] + p - k[None, :]
        return ((o % s == 0) & (o >= 0) & (o // s < n_out)).sum(1)

    return int((along(z, d_out, stride, pad) * along(y, H, 1, 1)
                * along(x, W, 1, 1)).sum())


def dense_flops(cfg: dict) -> float:
    """One frame's FLOPs of middle blocks 2-3 and the whole RPN."""
    D, H, W = ref.grid_dzyx(cfg["object"])
    depths = ref.middle_depths(D)
    flops = 0.0
    cin = ref.MIDDLE[0][0]
    for (cout, _, _), d in list(zip(ref.MIDDLE, depths))[1:]:
        flops += 2.0 * d * H * W * cout * cin * 27
        cin = cout
    h, w = H, W
    sizes = []
    for ci, co, s in ref.rpn_convs(64 * depths[-1],
                                   cfg["rpn"]["block1_stride"]):
        h, w = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
        flops += 2.0 * h * w * co * ci * 9
        sizes.append((h, w))
    for (ci, co, k, _), (h, w) in zip(ref.DECONVS, (sizes[4], sizes[10],
                                                    sizes[16])):
        flops += 2.0 * h * w * ci * co * k * k
    fh, fw = sizes[4]
    flops += 2.0 * fh * fw * 768 * (2 + 14)
    return flops


def forward_flops(cfg: dict, stored_points: int, taps: int,
                  frames: int) -> float:
    """A forward pass over `frames` frames with these stored points and
    block-1 pairs in all."""
    cin, cout = 128, ref.MIDDLE[0][0]
    return (2.0 * VFE_MACS_PER_POINT * stored_points
            + 2.0 * cin * cout * taps + frames * dense_flops(cfg))


def batch_stats(points: np.ndarray, num_points: np.ndarray, cfg: dict):
    """-> (stored points, block-1 pairs, voxels) of one batch, from the
    reference's voxelization."""
    _, coords, counts = ref.voxelize(points, num_points, cfg)
    return (int(counts.sum()), block1_taps(coords, counts, cfg),
            int((counts > 0).sum()))


def bound_s(n_bytes: float, flops: float = 0.0,
            dtype: str = "float32") -> float:
    """Least seconds for the work on the card: the larger of the bytes
    over HBM bandwidth and the FLOPs over the peak of their type."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def kernel_bounds(cfg: dict, batch: int, stored_points: int) -> dict:
    """Each of the program's kernels on the path -> the bytes-once bound
    in seconds of one launch over one batch: every input byte read once,
    every output byte written once."""
    obj, data = cfg["object"], cfg["data"]
    D, H, W = ref.grid_dzyx(obj)
    N, K, T = data["max_points"], data["max_voxels"], obj["points_per_voxel"]
    cells = D * H * W
    points = batch * 4 * N * 4                    # (B, 4, N) f32 sorted
    table = batch * K * 4                         # (B, K) i32
    weights = (16 * 8 + 16 * 3 + 64 * 32 + 64 * 3) * 4
    # the voxelwise features and the grid are in the compute type
    grid_elem = 4 if cfg["train"]["compute_dtype"] == "float32" else 2
    return {
        "vfe_fused": bound_s(points + 2 * table + batch * 4 + weights
                             + batch * K * 128 * 2,
                             2.0 * VFE_MACS_PER_POINT * stored_points,
                             "bfloat16"),
        "dense_build": bound_s(batch * K * 128 * grid_elem + table
                               + batch * cells * 128 * grid_elem),
        "run_copy": bound_s(points + table + batch * K * T * 4 * 4),
    }
