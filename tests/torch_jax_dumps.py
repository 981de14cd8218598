"""The JAX package's Car detections for `chip_smoke.py`'s own model, as
label files: the fixture that chip_smoke.py phase 14 holds the port's
detections on the card against (tools/ab_compare_dumps.py).

    python tests/torch_jax_dumps.py [OUT_DIR]

OUT_DIR defaults to tests/fixtures/jax_car_dumps. The weights are
`chip_smoke.make_model`'s (`build_model(get_config("Car"), seed=0)` with
random BN statistics from torch's CPU generator), carried to JAX through
`convert.to_jax_variables`; the points are the 3 vendored frames staged
as phase 4 stages them. JAX's `make_inference_fn` runs at full Car width
at score_thres 0 with the fused VFE (in the Pallas interpreter off the
TPU, the port's bf16-output VFE) for each of `chip_smoke.AB_SETTINGS`
(conv3d and sparse1, bf16 and f32), one frame a label file. meta.json
holds the sha256 of the weights and of the staged points, which the
tests and phase 14 check.

Needs JAX (it runs where the JAX package runs, ~1 min on a CPU).
Regenerate it after any change to make_model, stage_points or the Car
preset.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def jax_detections(variables, points, num, overrides: dict):
    """JAX's make_inference_fn (CPU, jitted) on the points -> numpy
    (boxes, scores, valid)."""
    import jax
    import numpy as np

    from voxelnet_tpu.config import get_config
    from voxelnet_tpu.models.voxelnet import make_inference_fn

    fn = jax.jit(make_inference_fn(get_config("Car", **overrides),
                                   platform="cpu"))
    det = fn(variables, points, num)
    return tuple(np.asarray(x) for x in (det.boxes, det.scores, det.valid))


def write_fixture(out: str) -> dict:
    """Write every setting's label files, calib/ and meta.json -> meta."""
    import jax

    import chip_smoke
    from voxelnet_tpu_torch.config import get_config
    from voxelnet_tpu_torch.convert import to_jax_variables
    from voxelnet_tpu_torch.data.sample import sample_frames
    from voxelnet_tpu_torch.tools.ab_compare_dumps import (write_calib_dir,
                                                           write_dumps)

    model = chip_smoke.make_model(get_config("Car"), "cpu")
    variables = to_jax_variables(model.state_dict())
    points, num = chip_smoke.ab_inputs(sample_frames())
    meta = {"weights_sha256": chip_smoke.state_sha256(model),
            "points_sha256": chip_smoke.points_sha256(points, num),
            "num_points": num.tolist(), "jax": jax.__version__,
            "settings": {}}
    for name in chip_smoke.AB_SETTINGS:
        overrides = chip_smoke.merged(chip_smoke.AB_BASE,
                                      chip_smoke.AB_SETTINGS[name])
        boxes, scores, valid = jax_detections(variables, points, num,
                                              overrides)
        tags = write_dumps(os.path.join(out, name), boxes, scores, valid)
        meta["settings"][name] = {"overrides": overrides,
                                  "boxes": valid.sum(1).tolist()}
    write_calib_dir(os.path.join(out, "calib"), tags)
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    return meta


def port_cpu_lines(fixture: str) -> dict:
    """The port's CPU path (the kernels' plain versions) at full Car width
    against the fixture, as phase 14 runs it on the card -> {setting:
    compare()'s dict}."""
    import tempfile

    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        return {name: res for name, (res, _) in
                chip_smoke.ab_compare_runs("cpu", tmp, fixture).items()}


def diagnose(name: str = "conv3d_f32") -> dict:
    """Why the port's and JAX's boxes part at these weights: per frame,
    the spread of the rpn.nms_pre_topk best scores of JAX's map, the
    share of exact ties between neighbours among them, how far the port's
    scores of the same anchors lie from JAX's, and the points that JAX's
    jitted graph bins into another voxel than a true f32 divide (the
    port's and `voxelize_np`'s binning): XLA multiplies by the
    reciprocal of the voxel size."""
    import jax
    import numpy as np
    import torch

    import chip_smoke
    from voxelnet_tpu.config import get_config
    from voxelnet_tpu.models.voxelnet import make_inference_fn
    from voxelnet_tpu.ops import nms as jax_nms
    from voxelnet_tpu.ops.voxelize import VoxelGridSpec, _sort_stage
    from voxelnet_tpu_torch.convert import to_jax_variables
    from voxelnet_tpu_torch.data.sample import sample_frames
    from voxelnet_tpu_torch.models.voxelnet import make_maps_fn

    overrides = chip_smoke.merged(chip_smoke.AB_BASE,
                                  chip_smoke.AB_SETTINGS[name])
    jcfg, tcfg = get_config("Car", **overrides), chip_smoke.ab_config(name)
    model = chip_smoke.make_model(tcfg, "cpu")
    variables = to_jax_variables(model.state_dict())
    points, num = chip_smoke.ab_inputs(sample_frames())
    # JAX's decoded boxes and scores before its NMS: the NMS of this
    # process's copy of the graph returns its inputs
    nms_bev = jax_nms.nms_bev
    jax_nms.nms_bev = lambda boxes, scores, **_: jax_nms.NMSResult(
        boxes, scores, scores >= 0)
    try:
        want = np.asarray(jax.jit(make_inference_fn(jcfg, platform="cpu"))(
            variables, points, num).scores)
    finally:
        jax_nms.nms_bev = nms_bev
    with torch.no_grad():
        cls, _ = make_maps_fn(tcfg, "cpu")(model, points, num)
    got = torch.sigmoid(cls).reshape(len(num), -1).numpy()
    spec = VoxelGridSpec.from_object_config(jcfg.object)
    sizes = np.asarray(spec.voxel_size_zyx[::-1], np.float32)
    k = jcfg.rpn.nms_pre_topk
    out = {"setting": name, "pre_topk": k, "frames": []}
    for b in range(len(num)):
        top = np.argsort(-want[b], kind="stable")[:k]
        gaps = -np.diff(want[b][top])
        diff = np.abs(got[b][top] - want[b][top])
        ids = np.asarray(jax.jit(lambda p, n: _sort_stage(
            p, n, spec, jcfg.data.max_voxels)[1])(points[b], num[b]))
        shifted = points[b, :num[b], :3] + np.asarray(spec.offset_xyz,
                                                      np.float32)
        D, H, W = spec.grid_dzyx

        def linear(v):
            v = v.astype(np.int64)
            inside = ((v >= 0) & (v < [W, H, D])).all(1)
            return np.where(inside, (v[:, 2] * H + v[:, 1]) * W + v[:, 0],
                            D * H * W)

        divide = linear(np.floor(shifted / sizes))
        reciprocal = linear(np.floor(shifted * (np.float32(1) / sizes)))
        out["frames"].append({
            "top_span": float(want[b][top[0]] - want[b][top[-1]]),
            "tied_gaps": float((gaps == 0).mean()),
            "port_gap_max": float(diff.max()),
            "port_gap_share": float((diff > 0).mean()),
            "points": int(num[b]),
            "jax_bins_by_reciprocal": bool(np.array_equal(
                np.sort(ids[:num[b]]), np.sort(reciprocal))),
            "points_binned_apart": int((divide != reciprocal).sum()),
        })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=os.path.join(
        REPO, "tests", "fixtures", "jax_car_dumps"))
    ap.add_argument("--port-cpu", action="store_true",
                    help="write nothing: compare the port's CPU detections "
                         "with the fixture in OUT, one JSON line a setting")
    ap.add_argument("--diagnose", action="store_true",
                    help="write nothing: print diagnose()'s JSON line")
    args = ap.parse_args(argv)
    if args.diagnose:
        import jax

        jax.config.update("jax_platforms", "cpu")
        print(json.dumps(diagnose()))
        return
    if args.port_cpu:
        for name, res in port_cpu_lines(args.out).items():
            print(name, json.dumps(res))
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    meta = write_fixture(args.out)
    print(args.out, json.dumps({k: v["boxes"]
                                for k, v in meta["settings"].items()}))


if __name__ == "__main__":
    main()
