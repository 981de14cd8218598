"""The RPN and its heads (models/rpn.py): the program's marks (CUDA events at
its stage boundaries), mean ms a call over the traced window, from 'middle'
to 'rpn'."""


def read(r):
    return r.stage_ms["rpn"]
