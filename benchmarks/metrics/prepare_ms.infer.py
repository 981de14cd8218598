"""Voxelization of the inference path (ops/voxelize.py::prepare): the program's
marks (CUDA events at its stage boundaries), mean ms a call over the traced
window, from 'start' to 'prepare'."""


def read(r):
    return r.stage_ms["prepare"]
