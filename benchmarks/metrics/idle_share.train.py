"""The share of the traced window in which no operation ran on the device: 1 -
the union of the device ops' intervals over the window."""


def read(r):
    if r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
