"""The share of the traced slice, in %, in which no kernel, copy or set
ran on the device: one minus the union of the device's activity intervals
from ``torch.profiler`` over the slice's seconds on the device (its first
operation's start to its last's end)."""

UNIT = "%"
LAYER = "device"
MOVES = "images_per_min"


def read(run):
    if run.trace.window_s <= 0 or run.trace.events == 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
