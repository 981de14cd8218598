"""The Conv3D middle (models/middle.py): the program's marks (CUDA events at
its stage boundaries), mean ms a call over the traced window, from 'dense'
to 'middle'."""


def read(r):
    return r.stage_ms["middle"]
