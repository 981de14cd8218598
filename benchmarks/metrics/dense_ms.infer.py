"""The dense grid (models/scatter.py, the dense_build kernel; under sparse1 the
occupancy map): the program's marks (CUDA events at its stage boundaries),
mean ms a call over the traced window, from 'vfe' to 'dense'."""


def read(r):
    return r.stage_ms["dense"]
