"""The vfe_fused kernel's share of its bytes-once bound: the least time its
inputs read once and its outputs written once take at the card's peak
bandwidth (or its operations at the peak rate of their type, whichever is
longer; harness/counts.py), over its device time a call in the trace.
Nothing where the kernel did not run."""


def read(r):
    ms = r.kernel_ms.get("vfe_fused")
    if not ms:
        return None
    return 100.0 * r.kernel_bound_ms["vfe_fused"] / ms
