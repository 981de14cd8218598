#!/usr/bin/env python3
"""The benchmark of voxelnet_tpu_torch on one NVIDIA card.

    python3 benchmarks/run.py --workload car-infer-b8 --seed 12345 \\
        --seconds 20 --trace 0

Runs one cell of BENCHMARK.json from the root of a checkout: set-up
(inputs and weights from --seed, the program built and warmed up), a
window of --seconds of calls (with --trace 1 instead a profiled window of
the mix's trace_calls calls), then the comparison of what the window
produced with the plain float32 reference under benchmarks/reference/.
Prints the card's power limit, then each compared number beside its
limit, on standard error, then one JSON line on standard output:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device, with --trace 1 breakdown,
and last `checks`.

Exits with 2 and prints no result where torch sees no CUDA card (or
fewer than the cell asks for), and with 3 where a module of JAX or of
the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout: the
# program's own nvcc builds go to voxelnet_tpu_torch/_build/, and a
# Triton kernel, a torch extension or PTX that CUDA compiles at run
# time would cache here (later cells cannot edit this file)
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "cuda"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The power limit of the card the run used, as nvidia-smi reads it."""
    import subprocess

    import torch

    card = str(getattr(torch.cuda.get_device_properties(0), "uuid", 0))
    if card.count("-") == 4:
        card = "GPU-" + card
    try:
        out = subprocess.run(["nvidia-smi", "-i", card,
                              "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return (out.stdout.strip() or "not read") if out.returncode == 0 \
        else "not read"


def main(argv=None) -> int:
    args = parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmarks.harness import core

    chips = core.load_cell_entry(ROOT, args.workload)["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{seen}", file=sys.stderr)
        return 2
    result = core.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T_START)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or of the JAX package were "
              f"loaded: {found}", file=sys.stderr)
        return 3
    # beside mfu: a card set below its maximum runs slower under load
    print(f"card power limit: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
