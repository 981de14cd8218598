"""Box decoding and NMS (ops/box_coding.py, ops/nms.py), their host syncs
included: the program's marks (CUDA events at its stage boundaries), mean ms
a call over the traced window, from 'rpn' to 'nms'."""


def read(r):
    return r.stage_ms["decode"] + r.stage_ms["nms"]
