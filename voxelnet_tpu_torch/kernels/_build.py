"""Build the CUDA sources in `voxelnet_tpu_torch/csrc/` with nvcc into
shared libraries with a plain C interface, and load them with ctypes.

A library is built at first use into `voxelnet_tpu_torch/_build/`, named
by a hash of its source, the shared headers (`csrc/*.cuh`) and the flags,
so an edited source never loads a stale build. Every exported launcher takes device pointers and the CUDA stream as
`void*` and returns `cudaGetLastError()` after its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of voxelnet_tpu_torch are built from csrc/ at first use")
    return found


def _paths(name: str) -> tuple[str, str]:
    """-> (source, library path named by the hash of the source, the
    shared headers and the flags)."""
    src = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *(os.path.join(CSRC, h) for h in headers)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names) -> None:
    """Compile every named source whose library is missing, one nvcc
    process each, all started together; raise on the first failure."""
    todo = [(n, *_paths(n)) for n in names]
    todo = [(n, src, lib) for n, src, lib in todo if not os.path.exists(lib)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    running = []
    for n, src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        running.append((n, src, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for n, src, lib, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}\n{err}")
            continue
        os.replace(tmp, lib)
        build_seconds[n] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """csrc/<name>.cu -> loaded library with `argtypes` declared for each
    exported function (restype int: the launch's cudaError_t). Builds the
    library first if it is missing."""
    if name in _loaded:
        return _loaded[name]
    build([name])
    lib = ctypes.CDLL(_paths(name)[1])
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def kernel_info(lib: ctypes.CDLL, fn: str, *args: int) -> dict:
    """A built kernel's registers per thread, local (spill) bytes per
    thread, static shared bytes per block and resident blocks per SM on the
    current card, from the library's `fn(int* info, *args)` entry
    (csrc/kernel_info.cuh)."""
    info = (ctypes.c_int * 4)()
    check(getattr(lib, fn)(info, *args), fn)
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), info))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def on_cpu(t) -> bool:
    """A wrapper runs its kernel's plain version only for CPU tensors."""
    return t.device.type == "cpu"


def require_shapes(what: str, want: dict) -> None:
    """want: name -> (tensor, dtype, shape); raise on the first mismatch."""
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    devices = {t.device for t in tensors}
    if any(t.device.type != "cuda" for t in tensors) or len(devices) != 1:
        raise ValueError(f"{what}: the kernel takes CUDA tensors on one "
                         f"device, got {sorted(map(str, devices))}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
