"""The train-mode forward and the loss (models/, ops/losses.py): the program's
marks (CUDA events at its stage boundaries), mean ms a call over the traced
window, from 'targets' to 'loss'."""


def read(r):
    return r.stage_ms["forward"] + r.stage_ms["loss"]
