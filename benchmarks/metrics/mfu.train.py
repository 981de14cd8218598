"""The whole step's share of the card's peak: the FLOPs the window's batches
need (harness/counts.py: block 1 over its occupied taps, the rest dense; a
training step three times the forward) over the window's length and 989
TFLOP/s (bf16, dense)."""

from benchmarks.harness.counts import MFU_PEAK


def read(r):
    if r.busy_s <= 0:
        return None
    return 100.0 * r.flops_per_call * r.calls / r.window_s / MFU_PEAK
