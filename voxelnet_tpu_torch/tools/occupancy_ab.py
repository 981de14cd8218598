"""Time sparse1's occupancy map and its cells in two checkouts of the repo,
in turns on one card: A, B, B, A.

    python voxelnet_tpu_torch/tools/occupancy_ab.py --trees A_DIR B_DIR \
        [--out FILE.jsonl]

Each turn is a process of its own that imports `voxelnet_tpu_torch` from
its checkout (so it builds and runs that checkout's kernels) and times
them with this checkout's `tools/card.py`, so both trees are timed by one
code. It prints one JSON line:
- `occupancy`: at Car B=2 and B=8 on the vendored frames (the voxel
  table's coords and counts, as `chip_smoke.py` phase 10 feeds them), for
  the tree's `occupancy_map`, for its one torch call (a fill of -1 and one
  `index_put_` of the live rows' k at their cells, computed beforehand)
  and, in B's turns, for a memset of the whole map and a scatter of the
  live rows (`SCATTER_SOURCE`, the occupancy kernel before its streaming
  form, built here with nvcc) behind B's wrapper's host path: `ms`
  (`cuda_ms`), `device_ms`, `host_us` and `device_ops`; every map is
  checked equal to `occupancy_map_plain`;
- `bench`: `voxelnet_tpu_torch.bench` in process for sparse1 inference at
  B=1 and B=8 and the sparse1 train step at B=8 (frames/s, 3 chains of
  its ITERS calls).
The card's name and power limit head the output. Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

BENCH_RUNS = (
    ("infer_sparse1_b1", ["--stage", "infer", "--batch", "1"]),
    ("infer_sparse1_b8", ["--stage", "infer", "--batch", "8"]),
    ("train_sparse1_b8", ["--stage", "train", "--batch", "8"]),
)
BENCH_REPEATS = 3
CARD_PY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "card.py")

# the map by a memset of every cell to -1 and a scatter of each live row's
# k to its cell: the occupancy kernel's form before the streaming one,
# on an exact (B, D, H, W) map (padding rows write nothing)
SCATTER_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
occupancy_scatter(const int* __restrict__ coords,
                  const int* __restrict__ counts, int* __restrict__ occ,
                  int B, int K, int D, int H, int W) {
  const long long n = (long long)D * H * W, total = (long long)B * K;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    if (counts[i] > 0) {
      const long long b = i / K;
      const int z = coords[3 * i], y = coords[3 * i + 1],
                x = coords[3 * i + 2];
      if (z < 0 || z >= D || y < 0 || y >= H || x < 0 || x >= W) __trap();
      occ[b * n + ((long long)z * H + y) * W + x] = (int)(i - b * K);
    }
  }
}
extern "C" int occupancy_scatter_launch(const void* coords,
                                        const void* counts, void* occ,
                                        int B, int K, int D, int H, int W,
                                        void* stream) {
  cudaError_t err = cudaMemsetAsync(occ, 0xFF, (size_t)B * D * H * W * 4,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long want = ((long long)B * K + 255) / 256;
  occupancy_scatter<<<(unsigned)(want < (1 << 20) ? want : (1 << 20)), 256,
                      0, (cudaStream_t)stream>>>(
      (const int*)coords, (const int*)counts, (int*)occ, B, K, D, H, W);
  return (int)cudaGetLastError();
}
"""


def _scatter_map(torch, _build, tmp: str):
    """SCATTER_SOURCE built into `tmp`, behind the host path of B's
    `occupancy_map` (its checks, an exact map, the stream, one ctypes
    call)."""
    src, lib = os.path.join(tmp, "scatter.cu"), os.path.join(tmp, "scatter.so")
    with open(src, "w") as f:
        f.write(SCATTER_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    launch = ctypes.CDLL(lib).occupancy_scatter_launch
    launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int

    def occupancy_map(coords, counts, grid_dzyx):
        index = _build.require_cuda("occupancy_map", coords, counts)
        B, K = counts.shape
        D, H, W = grid_dzyx
        _build.require_shapes("occupancy_map",
                              ("coords", coords, torch.int32, (B, K, 3)),
                              ("counts", counts, torch.int32, (B, K)))
        if not (0 < B < 65536 and K > 0 and 0 < D * H * W < 2 ** 31):
            raise ValueError("occupancy_map: shapes out of range")
        occ = counts.new_empty((B, D, H, W))
        _build.check(launch(coords.data_ptr(), counts.data_ptr(),
                            occ.data_ptr(), B, K, D, H, W,
                            _build.stream(index)), "occupancy_map")
        return occ

    return occupancy_map


def worker(tree: str, scatter: bool) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from voxelnet_tpu_torch import bench
    from voxelnet_tpu_torch.cli import predict
    from voxelnet_tpu_torch.config import get_config
    from voxelnet_tpu_torch.data.sample import sample_frames
    from voxelnet_tpu_torch.kernels import _build, sparse_conv
    from voxelnet_tpu_torch.ops.voxelize import VoxelGridSpec, prepare

    if not torch.cuda.is_available():
        raise SystemExit("occupancy_ab: torch sees no CUDA device")
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        sparse_conv.__file__))).startswith(os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location("occupancy_ab_card", CARD_PY)
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    device = torch.device("cuda", 0)
    config = get_config("Car")
    frames = sample_frames()
    grid = tuple(config.object.grid_size)
    D, H, W = grid
    out = {"tree": tree, "occupancy": {}, "bench": {}}
    maps = {"kernel": sparse_conv.occupancy_map}
    if scatter:
        with tempfile.TemporaryDirectory() as tmp:
            maps["scatter_behind_wrapper"] = _scatter_map(torch, _build, tmp)
    for B in (2, 8):
        with torch.inference_mode():
            points, num = predict.stage_points(
                [frames[i % len(frames)] for i in range(B)], config,
                np.random.default_rng(0))
            prep = prepare(torch.from_numpy(points).to(device),
                           torch.from_numpy(num).to(device),
                           VoxelGridSpec.from_object_config(config.object),
                           config.data.max_voxels)
            coords, counts = prep.coords, prep.counts
            live = counts.reshape(-1) > 0
            cells = ((coords[..., 0].long() * H + coords[..., 1]) * W
                     + coords[..., 2] + torch.arange(B, device=device)[
                         :, None] * (D * H * W)).reshape(-1)[live]
            rows = torch.arange(counts.shape[1], dtype=torch.int32,
                                device=device).repeat(B)[live]
            flat = torch.empty(B * D * H * W, dtype=torch.int32,
                               device=device)
            want = sparse_conv.occupancy_map_plain(coords, counts, grid)
            fns = {name: (lambda m=m: m(coords, counts, grid))
                   for name, m in maps.items()}
            fns["one_torch_call"] = lambda: flat.new_full(
                flat.shape, -1).index_put_((cells,), rows)
            row = out["occupancy"][f"b{B}"] = {"live": int(live.sum())}
            for name, fn in fns.items():
                assert torch.equal(fn().view(want.shape), want), (
                    f"{name} differs from plain")
                row[name] = {"ms": card.cuda_ms(fn),
                             "device_ms": card.device_ms(fn),
                             "host_us": card.host_us(fn),
                             "device_ops": card.device_ops(fn)}
    torch.cuda.empty_cache()
    for name, argv in BENCH_RUNS:
        with contextlib.redirect_stdout(io.StringIO()):
            line = bench.main(argv + ["--middle-backend", "sparse1",
                                      "--repeats", str(BENCH_REPEATS)])
        out["bench"][name] = line
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trees", nargs=2, metavar=("A", "B"))
    p.add_argument("--worker", metavar="TREE", default=None,
                   help="one turn, in the checkout TREE (internal)")
    p.add_argument("--scatter", action="store_true",
                   help="the turn also times SCATTER_SOURCE (internal)")
    p.add_argument("--out", default=None, help="also write the lines here")
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.scatter)))
        return
    a, b = (os.path.abspath(t) for t in args.trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or card.stderr.strip())
    lines = []
    for tree in (a, b, b, a):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             *(["--scatter"] if tree == b else [])],
            cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"occupancy_ab: the turn in {tree} failed:\n"
                             f"{proc.stderr[-4000:]}")
        lines.append(proc.stdout.strip().splitlines()[-1])
        print(lines[-1])
        print(f"  ({time.perf_counter() - t0} s)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
