"""The share of the traced steps' wall time in which no operation ran on
the device, in percent: 100 (1 - busy / wall), busy the union of the
device's kernels, copies and sets in the trace."""

SPANS = []


def read(t):
    if t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
