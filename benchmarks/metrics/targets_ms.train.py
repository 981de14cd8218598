"""Target assignment on the device (ops/targets.py): the program's marks (CUDA
events at its stage boundaries), mean ms a call over the traced window, from
'voxelize' to 'targets'."""


def read(r):
    return r.stage_ms["targets"]
