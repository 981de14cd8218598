"""The share of the NMS's rotated-IoU pairs (ops/nms.py, B * k^2 a call over
its nms_pre_topk candidates) whose two candidates are both over the score
gate: the program's `nms.iou_pairs_live` over `nms.iou_pairs`
(voxelnet_tpu_torch/tracing.py) over the traced window, in %. None where
the program records no `nms` span."""


def read(r):
    try:
        from voxelnet_tpu_torch import tracing
        calls = tracing.recent(r.calls)
    except (ImportError, ValueError):
        return None
    calls = [c for c in calls if c.named("nms")]
    pairs = sum(c.count("nms.iou_pairs") for c in calls)
    if not pairs:
        return None
    return 100.0 * sum(c.count("nms.iou_pairs_live") for c in calls) / pairs
