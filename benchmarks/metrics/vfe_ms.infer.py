"""The VFE of the inference path (models/vfe.py, the fused kernel): the
program's marks (CUDA events at its stage boundaries), mean ms a call over
the traced window, from 'prepare' to 'vfe'."""


def read(r):
    return r.stage_ms["vfe"]
