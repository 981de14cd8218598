"""A copy of the benchmark in a temporary directory with tiny cells of
its own added as files (a configuration, two mixes, their limits and two
cells in BENCHMARK.json), for runs on the CPU."""

from __future__ import annotations

import copy
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAMES = os.path.join("voxelnet_tpu", "data", "sample_frames")
TINY_OBJECT = {"x_max": 12.8, "y_min": -6.4, "y_max": 6.4}
TINY_DATA = {"max_points": 2048, "max_voxels": 256, "max_gt_boxes": 8}
# limits for the tiny cells: sound runs read reg_gap 0.34-0.44,
# reg_scale_gap 0.002-0.021, logit_gap 0.19-0.45 (the fused VFE keeps
# bfloat16 under a float32 configuration), nms_faults 0, head_grad_dir
# under 1e-4 and bn_gap about 1e-5; each planted fault and the control
# read far above
TINY_LIMITS = {"reg_gap": 1.0, "reg_scale_gap": 0.05, "logit_gap": 1.5,
               "nms_faults": 0, "head_grad_dir": 1e-3, "bn_gap": 1e-3}
INFER = ("reg_gap", "reg_scale_gap", "logit_gap", "nms_faults")
TRAIN = ("head_grad_dir", "bn_gap")


def tiny_config() -> dict:
    with open(os.path.join(REPO, "benchmarks", "configs", "car.json")) as f:
        spec = json.load(f)
    spec = copy.deepcopy(spec)
    spec["name"] = "tiny"
    cfg = spec["config"]
    cfg["object"].update(TINY_OBJECT)
    cfg["data"].update(TINY_DATA)
    cfg["train"]["compute_dtype"] = "float32"
    # the score gate at the tiny map's own scale
    cfg["rpn"]["nms_pre_topk"] = 64
    spec["reduced"] = ["object", "data", "train", "rpn"]
    return spec


def make_tree(tmp: str, limits: dict | None = None) -> str:
    """The benchmark copied into a directory under tmp, with the cells
    tiny-infer and tiny-train -> that directory."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "benchmarks"),
                    os.path.join(root, "benchmarks"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.makedirs(os.path.join(root, os.path.dirname(FRAMES)))
    os.symlink(os.path.join(REPO, FRAMES), os.path.join(root, FRAMES))
    b = os.path.join(root, "benchmarks")
    write(os.path.join(b, "configs", "tiny.json"), tiny_config())
    common = {"batch": 2, "pool_batches": 3, "rotation_deg": 45.0,
              "flip": 0.5, "drop": 0.05, "frames": FRAMES}
    write(os.path.join(b, "traffic", "tiny_infer.json"),
          dict(kind="offline_infer", **common, gate_candidates=256,
               warmup_calls=1, trace_calls=2, check_calls=2))
    write(os.path.join(b, "traffic", "tiny_train.json"),
          dict(kind="train_step", **common, steps_per_epoch=100,
               trace_calls=2))
    lim = dict(TINY_LIMITS, **(limits or {}))
    for cell, names in (("tiny-infer", INFER), ("tiny-train", TRAIN)):
        write(os.path.join(b, "limits", f"{cell}.json"),
              {"limits": {k: lim[k] for k in names}})
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmarks/configs/tiny.json",
                             "reduced": [], "why": "tiny"})
    for name, mix, fam in (("tiny-infer", "tiny_infer", "infer"),
                           ("tiny-train", "tiny_train", "train")):
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": mix, "chips": 1, "why": "t"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and m["workloads"][0].endswith(fam + "-b8"):
                m["workloads"].append(name)
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
