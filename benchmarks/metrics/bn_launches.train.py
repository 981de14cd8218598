"""The train step's batch-norm kernel launches (csrc/batch_norm.cu through
voxelnet_tpu_torch/kernels/batch_norm.py), forward and backward: the
program's `bn.launches` counter (voxelnet_tpu_torch/tracing.py), which the
wrapper adds to at each launch, mean over the traced window's steps. None
where the program counts no such launch."""


def read(r):
    try:
        from voxelnet_tpu_torch import tracing
        calls = tracing.recent(r.calls)
    except (ImportError, ValueError):
        return None
    if not any(c.counters.get("bn.launches") for c in calls):
        return None
    return sum(c.count("bn.launches") for c in calls) / len(calls)
