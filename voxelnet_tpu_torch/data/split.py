"""Dataset split tool: the port's copy of `voxelnet_tpu/data/split.py`.

Capability parity with the reference split tool (split_dataset.py:7-63):
copy (or symlink) image/velodyne/label triplets from a KITTI training dir
into MD_KITTI/{training,validation} according to ImageSet split files.

    python -m voxelnet_tpu_torch.data.split --kitti-dir ... --out-dir ... \
        --train-split train.txt --val-split val.txt [--symlink]
"""

from __future__ import annotations

import argparse
import os
import shutil


SUBDIRS = ("image_2", "velodyne", "label_2")
EXTS = {"image_2": ".png", "velodyne": ".bin", "label_2": ".txt"}


def read_split(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def rearrange(kitti_training_dir: str, out_dir: str, train_tags: list[str],
              val_tags: list[str], symlink: bool = False) -> dict:
    """Copy/symlink triplets into out_dir/{training,validation}/<subdir>/."""
    counts = {"training": 0, "validation": 0, "missing": 0}
    for split, tags in (("training", train_tags), ("validation", val_tags)):
        for sub in SUBDIRS:
            os.makedirs(os.path.join(out_dir, split, sub), exist_ok=True)
        for tag in tags:
            paths = {
                sub: os.path.join(kitti_training_dir, sub, tag + EXTS[sub])
                for sub in SUBDIRS
            }
            if not all(os.path.exists(p) for p in paths.values()):
                counts["missing"] += 1
                continue
            for sub, src in paths.items():
                dst = os.path.join(out_dir, split, sub,
                                   os.path.basename(src))
                if os.path.exists(dst):
                    continue
                if symlink:
                    os.symlink(os.path.abspath(src), dst)
                else:
                    shutil.copy2(src, dst)
            counts[split] += 1
    return counts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kitti-dir", required=True,
                   help="KITTI training dir containing image_2/ velodyne/ label_2/")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--train-split", required=True,
                   help="ImageSets train .txt (one tag per line)")
    p.add_argument("--val-split", required=True)
    p.add_argument("--symlink", action="store_true",
                   help="symlink instead of copy")
    args = p.parse_args(argv)
    counts = rearrange(args.kitti_dir, args.out_dir,
                       read_split(args.train_split),
                       read_split(args.val_split), args.symlink)
    print(counts)


if __name__ == "__main__":
    main()
