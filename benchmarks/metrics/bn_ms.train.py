"""The train step's f32 batch-norms (models/bn.py::flax_batch_norm, each
call in train mode), forward and backward: the program's `bn` and
`bn.backward` spans (voxelnet_tpu_torch/tracing.py), each the ms between
its two CUDA events, summed over a step; mean over the traced window's
steps. None where the program records no such span."""


def read(r):
    try:
        from voxelnet_tpu_torch import tracing
        calls = tracing.recent(r.calls)
    except (ImportError, ValueError):
        return None
    spans = [[s for name in ("bn", "bn.backward") for s in c.named(name)]
             for c in calls]
    if not any(spans):
        return None
    return sum(s.device_ms() for step in spans for s in step) / len(spans)
