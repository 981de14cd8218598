"""Training CLI of the port, as `voxelnet_tpu/cli/train.py` (the same flags)
plus --device (default cuda; cuda without a card exits with an error).

    python -m voxelnet_tpu_torch.cli.train --data-dir /data/kitti/MD_KITTI \
        [--cfg overrides.yaml] [--class-name Car] \
        [--resume exps/.../checkpoints] [--device cuda]

--cfg reads the YAML subset of `voxelnet_tpu_torch/utils/yaml_subset.py`.
Several processes (the JAX CLI's VOXELNET_COORDINATOR) and --num-vis-dump
above 0 are not in the port yet.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

import torch

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.training.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", type=str, default=None,
                   help="KITTI root containing training/ and validation/")
    p.add_argument("--cfg", type=str, default=None,
                   help="YAML config override file")
    p.add_argument("--class-name", type=str, default="Car",
                   choices=("Car", "Pedestrian", "Cyclist", "all"),
                   help="'all' trains one model per class in turn")
    p.add_argument("--exp-base", type=str, default="exps")
    p.add_argument("--exp-dir", type=str, default=None,
                   help="explicit experiment dir")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume from")
    p.add_argument("--print-interval", type=int, default=100)
    p.add_argument("--summary-interval", type=int, default=100)
    p.add_argument("--summary-val-interval", type=int, default=100)
    p.add_argument("--profile-steps", type=str, default=None,
                   help="START:STOP global-step window traced with "
                        "torch.profiler into the exp logs dir")
    p.add_argument("--num-vis-dump", type=int, default=0, choices=(0,),
                   help="per-epoch image dumps: only 0 in the port")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch sees no CUDA device")
    classes = (("Car", "Pedestrian", "Cyclist")
               if args.class_name == "all" else (args.class_name,))
    profile_steps = None
    if args.profile_steps:
        a, b = args.profile_steps.split(":")
        profile_steps = (int(a), int(b))

    for cls_name in classes:
        config = get_config(cls_name)
        if args.cfg:
            config = config.merge_from_file(args.cfg)
        if args.data_dir:
            config = replace(
                config, data=replace(config.data, dir=args.data_dir))
        print(config.dump_yaml())

        with Trainer(
            config,
            train_dir=os.path.join(config.data.dir, "training"),
            val_dir=os.path.join(config.data.dir, "validation"),
            exp_base=(args.exp_base if len(classes) == 1
                      else os.path.join(args.exp_base, cls_name)),
            resume_from=args.resume,
            # one subdir per class under a shared explicit exp dir
            exp_dir=(args.exp_dir if args.exp_dir is None
                     or len(classes) == 1
                     else os.path.join(args.exp_dir, cls_name)),
            device=args.device,
        ) as trainer:
            trainer.train(
                print_interval=args.print_interval,
                summary_interval=args.summary_interval,
                val_interval=args.summary_val_interval,
                profile_steps=profile_steps,
                num_vis_dump=args.num_vis_dump,
            )


if __name__ == "__main__":
    main()
