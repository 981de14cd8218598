"""Training CLI of the port, as `voxelnet_tpu/cli/train.py` (the same flags)
plus --device (cuda, cuda:N or cpu; default cuda; cuda without a card
exits with an error) and --dist-backend.

    python -m voxelnet_tpu_torch.cli.train --data-dir /data/kitti/MD_KITTI \
        [--cfg overrides.yaml] [--class-name Car] \
        [--resume exps/.../checkpoints] [--device cuda]

Several processes, one card each, N = system.num_dcn_shards x
num_data_shards x num_model_shards in the --cfg file and train.batch_size
the global batch (a model axis above 1 shards the BEV grid's W axis over
the processes of each model group, which load the same rows):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m voxelnet_tpu_torch.cli.train --exp-dir <shared dir> --cfg ...

or, as the JAX CLI, VOXELNET_COORDINATOR=host:port,
VOXELNET_NUM_PROCESSES=N and VOXELNET_PROCESS_ID=i in each process. With
either set, the CLI starts the process group before the Trainer (nccl on
cuda:LOCAL_RANK; --dist-backend gloo with --device cuda:0 puts every rank
on one card) and destroys it at exit.

--cfg reads the YAML subset of `voxelnet_tpu_torch/utils/yaml_subset.py`.
--num-vis-dump N writes the front/BEV/heatmap images of N val frames an
epoch as PNGs under <exp>/vis/<epoch> (no cv2 needed).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

import torch

from voxelnet_tpu_torch.config import get_config
from voxelnet_tpu_torch.parallel import distributed
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
    p.add_argument("--num-vis-dump", type=int, default=0,
                   help="val frames an epoch whose front/BEV/heatmap images "
                        "are written as PNGs under <exp>/vis/<epoch>")
    p.add_argument("--device", type=_device_arg, default="cuda",
                   help="cuda (cuda:LOCAL_RANK when launched in several "
                        "processes), cuda:N or cpu")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="backend of a multi-process launch (default nccl "
                        "on a card, gloo on the CPU; gloo lets several "
                        "ranks share one card)")
    args = p.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device")
    world = distributed.launch_world_size() if distributed.launched() else 1
    if world > 1 and args.exp_dir is None:
        raise SystemExit(
            f"training in {world} processes needs --exp-dir, one directory "
            "shared by all of them (numbering exps/DATE-NNN would race)")
    classes = (("Car", "Pedestrian", "Cyclist")
               if args.class_name == "all" else (args.class_name,))
    profile_steps = None
    if args.profile_steps:
        a, b = args.profile_steps.split(":")
        profile_steps = (int(a), int(b))

    device = args.device
    start_group = distributed.launched() and not distributed.is_initialized()
    if start_group:
        device = distributed.initialize(
            backend=args.dist_backend,
            device=None if args.device == "cuda" else args.device)
    try:
        _train(args, classes, device, profile_steps)
    finally:
        if start_group:
            distributed.shutdown()


def _device_arg(value: str) -> str:
    if value not in ("cuda", "cpu") and not (
            value.startswith("cuda:") and value[5:].isdigit()):
        raise argparse.ArgumentTypeError(
            f"{value!r}: expected cuda, cuda:N or cpu")
    return value


def _train(args, classes, device, profile_steps) -> None:
    for cls_name in classes:
        config = get_config(cls_name)
        if args.cfg:
            config = config.merge_from_file(args.cfg)
        if args.data_dir:
            config = replace(
                config, data=replace(config.data, dir=args.data_dir))
        if distributed.is_main():
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
            device=device,
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
