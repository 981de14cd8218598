"""The train step's voxel table (ops/voxelize.py, the run_copy kernel): the
program's marks (CUDA events at its stage boundaries), mean ms a call over
the traced window, from 'start' to 'voxelize'."""


def read(r):
    return r.stage_ms["voxelize"]
