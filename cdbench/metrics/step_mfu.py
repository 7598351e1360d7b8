"""The whole request's share of the card's dense bf16 peak in the traced
slice, in %: the benchmark's count of model operations per request (the
configuration's ``counts`` times the mix's driver module's units of work) times the
requests in the slice, over the slice's seconds on the device (its first
operation's start to its last's end, in the profiler's trace), over
989 TFLOP/s."""

from cdbench import counts

UNIT = "%"
LAYER = "the whole step: pipelines/latent_text.py down to the kernels"
MOVES = "images_per_min"


def read(run):
    if run.trace.window_s <= 0 or run.trace.events == 0:
        return None
    flops = run.flops_per_request * run.slice_requests
    return 100.0 * flops / run.trace.window_s / counts.PEAK_FLOPS
