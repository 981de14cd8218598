"""The host's time blocked in the program's own synchronisations with the
device (today the one in each iteration of NMS's greedy loop), ms a call: the
program's `host.wait_ns` counter (voxelnet_tpu_torch/tracing.py), mean
over the traced window's calls. The harness's copy of the detections to
the host is not the program's and is not in it. None where the program
records no `infer` call."""


def read(r):
    try:
        from voxelnet_tpu_torch import tracing
        calls = tracing.recent(r.calls)
    except (ImportError, ValueError):
        return None
    calls = [c for c in calls if c.name == "infer"]
    if not calls:
        return None
    return sum(c.count("host.wait_ns") for c in calls) / len(calls) / 1e6
