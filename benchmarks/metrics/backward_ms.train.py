"""The backward pass (autograd, models/bn.py): the program's marks (CUDA events
at its stage boundaries), mean ms a call over the traced window, from 'loss'
to 'backward'."""


def read(r):
    return r.stage_ms["backward"]
