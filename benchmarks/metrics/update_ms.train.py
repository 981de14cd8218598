"""The clipped SGD update (training/optim.py; the gradient's all-reduce,
nothing in one process): the program's marks (CUDA events at its stage
boundaries), mean ms a call over the traced window, from 'backward' to
'update'."""


def read(r):
    return r.stage_ms["all_reduce"] + r.stage_ms["update"]
