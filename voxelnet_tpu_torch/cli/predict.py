"""Single-frame / directory inference CLI of the port, as
`voxelnet_tpu/cli/predict.py`: read a point cloud, crop it to the grid,
subsample to max_points, run the detector, print the boxes.

    python -m voxelnet_tpu_torch.cli.predict --pcl sample:0 --device cuda
    python -m voxelnet_tpu_torch.cli.predict --pcl frame.bin --device cpu \\
        --weights converted.npz
    python -m voxelnet_tpu_torch.cli.predict --pcl sample:0 \\
        --checkpoint exps/.../checkpoints [--cfg overrides.yaml]

--checkpoint takes a checkpoint of the port's trainer (a checkpoints root,
whose latest step is read, or one step dir); --weights a .npz of JAX
variables (convert.save_npz). Either is refused when it was trained with
another `train.yaw_encoding` than the running config's; a .npz written
without its decode knobs loads with a warning. Without either the weights are a random init
from --seed, and "0 detections" is the expected output. --cfg reads the
YAML subset of `voxelnet_tpu_torch/utils/yaml_subset.py`.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.convert import from_jax_variables, load_npz
from voxelnet_tpu_torch.models.voxelnet import (Detections, build_model,
                                                make_inference_fn)
from voxelnet_tpu_torch.ops.voxelize import (VoxelGridSpec, crop_points,
                                             pad_points)
from voxelnet_tpu_torch.training.checkpoint import load_variables


def load_clouds(pcl: str) -> list[tuple[str, np.ndarray]]:
    """'sample[:N]' (vendored frame N, default 0), a directory of .bin
    files, or one .bin file -> [(name, (P, 4) f32 cloud)]."""
    if pcl == "sample" or pcl.startswith("sample:"):
        from voxelnet_tpu_torch.data.sample import sample_frames

        frames = sample_frames()
        i = int(pcl.split(":", 1)[1]) if ":" in pcl else 0
        if not 0 <= i < len(frames):
            raise SystemExit(f"sample index {i} out of range "
                             f"(have {len(frames)})")
        return [(f"sample:{i}", frames[i])]
    paths = (sorted(glob.glob(os.path.join(pcl, "*.bin")))
             if os.path.isdir(pcl) else [pcl])
    if not paths:
        raise SystemExit(f"no .bin files in {pcl!r}")
    return [(p, np.fromfile(p, np.float32).reshape(-1, 4)) for p in paths]


def stage_points(clouds, config, rng: np.random.Generator):
    """Clouds -> (points (B, max_points, 4) f32, num_points (B,) i32):
    crop to the grid (data.crop_to_grid), then a uniform subsample to
    max_points (data.shuffle_points), as the JAX pipeline stages them."""
    spec = VoxelGridSpec.from_object_config(config.object)
    staged = []
    for cloud in clouds:
        if config.data.crop_to_grid:
            cloud = crop_points(cloud, spec)
        staged.append(pad_points(cloud, config.data.max_points, rng=rng,
                                 shuffle=config.data.shuffle_points))
    return (np.stack([p for p, _ in staged]),
            np.asarray([n for _, n in staged], np.int32))


def predict(infer, model, clouds, config,
            rng: np.random.Generator) -> Detections:
    """Stage the clouds as one batch and run the inference function."""
    points, num_points = stage_points(clouds, config, rng)
    return infer(model, points, num_points)


def load_model(config, weights: str | None, seed: int, device,
               checkpoint: str | None = None):
    model = build_model(config, seed=seed)
    if checkpoint:
        model.load_state_dict(load_variables(checkpoint, config))
    elif weights:
        model.load_state_dict(from_jax_variables(load_npz(weights, config)))
    return model.to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pcl", required=True,
                   help="sample[:N], a .bin file, or a directory of them")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--checkpoint", default=None,
                         help="checkpoints root or step dir of the port's "
                              "trainer")
    weights.add_argument("--weights", default=None,
                         help=".npz of JAX variables (convert.save_npz)")
    p.add_argument("--seed", type=int, default=0,
                   help="random-init seed when --weights is not given")
    p.add_argument("--class-name", default="Car")
    p.add_argument("--cfg", default=None, help="YAML config override file")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch sees no CUDA device")
    config = get_config(args.class_name)
    if args.cfg:
        config = config.merge_from_file(args.cfg)
    model = load_model(config, args.weights, args.seed, args.device,
                       args.checkpoint)
    infer = make_inference_fn(config, args.device)
    rng = np.random.default_rng(0)
    for name, cloud in load_clouds(args.pcl):
        det = predict(infer, model, [cloud], config, rng)
        valid = det.valid[0].cpu().numpy()
        boxes = det.boxes[0].cpu().numpy()[valid]
        scores = det.scores[0].cpu().numpy()[valid]
        print(f"{name}: {int(valid.sum())} detections")
        for b, s in zip(boxes, scores):
            print(f"  score={s:.4f} box(x,y,z,h,w,l,r)="
                  + " ".join(f"{v:.3f}" for v in b))


if __name__ == "__main__":
    main()
