"""The host's own time in an inference call, ms: the host duration of the
program's `infer` span (voxelnet_tpu_torch/tracing.py) less its
`host.wait_ns`, the time it spent blocked in synchronisations; mean over
the traced window's calls. None where the program records no `infer`
call."""


def read(r):
    try:
        from voxelnet_tpu_torch import tracing
        calls = tracing.recent(r.calls)
    except (ImportError, ValueError):
        return None
    calls = [c for c in calls if c.name == "infer"]
    if not calls:
        return None
    return sum(c.spans[0].host_ns - c.count("host.wait_ns")
               for c in calls) / len(calls) / 1e6
