"""Greedy NMS iterations a call (ops/nms.py::greedy_suppress), each one
host synchronisation: the program's `nms.iters` counter
(voxelnet_tpu_torch/tracing.py), mean over the traced window's calls. None
where the program records no `nms` span."""


def read(r):
    try:
        from voxelnet_tpu_torch import tracing
        calls = tracing.recent(r.calls)
    except (ImportError, ValueError):
        return None
    calls = [c for c in calls if c.named("nms")]
    if not calls:
        return None
    return sum(c.count("nms.iters") for c in calls) / len(calls)
