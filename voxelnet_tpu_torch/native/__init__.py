"""The host voxelizer in C++ (`voxelize.cpp`), loaded through ctypes: the
port's copy of `voxelnet_tpu/native/`, for the `train.host_voxelize`
pipeline (ops/voxelize.resolve_host_voxelizer).

The library is built at first use with the host C++ compiler ($CXX, else
g++, else c++) into `voxelnet_tpu_torch/_build/`, named by a hash of the
source, the compiler and its flags, so an edited source never loads a
stale build; it is never built next to the source. `compiler()` says which
compiler built it. `load()` raises with the compiler's output when the
build fails; `available()` says whether it loads, and `load_error()` why
not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from voxelnet_tpu_torch.kernels._build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "voxelize.cpp")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None
_compiler: str | None = None

_F = ctypes.c_float
_I32 = ctypes.c_int32
_GRID = [_I32, _I32, _I32, _F, _F, _F, _F, _F, _F]  # D H W, sizes zyx, off xyz


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler ($CXX, g++ or c++) on PATH; "
                       "the native voxelizer is built from "
                       "voxelnet_tpu_torch/native/voxelize.cpp at first use")


def _version(cxx: str) -> str:
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return out.stdout.splitlines()[0] if out.stdout else "unknown version"


def build() -> str:
    """Compile the library if it is missing -> its path. Raises
    RuntimeError with the compiler's output when it fails."""
    global _compiler
    cxx = _cxx()
    version = _version(cxx)
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            (cxx, version) + FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libvoxelize-{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # a temporary name per process, then an atomic rename: builders
        # running at once never load a half-written library
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SRC}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    _compiler = f"{cxx}: {version}"
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when it cannot
    be built or loaded (again on every call, with the first error)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError) as e:
            _error = f"native voxelizer unavailable: {e}"
            raise RuntimeError(_error) from e
        lib.voxelnet_crop_f32.restype = ctypes.c_int64
        lib.voxelnet_crop_f32.argtypes = [
            ctypes.POINTER(_F), ctypes.c_int64, *_GRID, ctypes.POINTER(_F)]
        lib.voxelnet_voxelize_f32.restype = ctypes.c_int
        lib.voxelnet_voxelize_f32.argtypes = [
            ctypes.POINTER(_F), ctypes.c_int64, *_GRID,
            _I32, _I32,                                       # T max_voxels
            ctypes.POINTER(_F), ctypes.POINTER(_I32),         # features coords
            ctypes.POINTER(_I32),                             # counts
            ctypes.POINTER(_I32), ctypes.POINTER(_I32)]       # k k_raw
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library builds and loads; never raises."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def load_error() -> str | None:
    """Why the library did not load (None when it did or was not tried)."""
    return _error


def compiler() -> str | None:
    """The compiler that built (or found built) the loaded library: path
    and first line of its --version."""
    return _compiler


def _grid_args(spec) -> list:
    D, H, W = spec.grid_dzyx
    return [D, H, W, *(_F(v) for v in spec.voxel_size_zyx),
            *(_F(v) for v in spec.offset_xyz)]


def _points(points: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 4))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def voxelize_native(points: np.ndarray, spec, max_voxels: int):
    """ops/voxelize.voxelize_np(points, spec, max_voxels) in C++, bit-equal
    (the no-shuffle form: the dataset shuffles before it voxelizes)."""
    from voxelnet_tpu_torch.ops.voxelize import Voxels

    lib = load()
    pts = _points(points)
    T = spec.max_points_per_voxel
    features = np.empty((max_voxels, T, 7), np.float32)
    coords = np.empty((max_voxels, 3), np.int32)
    counts = np.empty((max_voxels,), np.int32)
    k, k_raw = _I32(0), _I32(0)
    rc = lib.voxelnet_voxelize_f32(
        _ptr(pts, _F), len(pts), *_grid_args(spec), T, max_voxels,
        _ptr(features, _F), _ptr(coords, _I32), _ptr(counts, _I32),
        ctypes.byref(k), ctypes.byref(k_raw))
    if rc != 0:
        raise RuntimeError(f"native voxelizer error code {rc}")
    return Voxels(features, coords, counts, int(k.value), int(k_raw.value))


def crop_in_grid(points: np.ndarray, spec) -> np.ndarray:
    """`points[ops.voxelize.in_grid_mask(points, spec)]` in C++: the same
    rows in the same order."""
    lib = load()
    pts = _points(points)
    out = np.empty_like(pts)
    k = lib.voxelnet_crop_f32(_ptr(pts, _F), len(pts), *_grid_args(spec),
                              _ptr(out, _F))
    return out[:k]
