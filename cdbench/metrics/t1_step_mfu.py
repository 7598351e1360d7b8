"""The whole request's share of the card's dense bf16 peak in the traced
slice, in %, for a mix whose requests differ in work (the ensemble's skip
cycle): the operations of the requests the slice traced, each counted by
its own units of work (the driver's ``work_of_request`` at its index, times
the configuration's ``counts``), over the slice's seconds on the device
(its first operation's start to its last's end) over 989 TFLOP/s.  None
where the driver has no per-request work or the slice ran nothing on the
device."""

from cdbench import counts

UNIT = "%"
LAYER = "the whole step: pipelines/latent_text.py down to the kernels"
MOVES = "images_per_min"
# the harness's slice starts at the window's second request (index 1)
FIRST = 1


def read(run):
    work = getattr(run.driver, "work_of_request", None)
    if work is None or run.trace.window_s <= 0 or run.trace.events == 0:
        return None
    per_unit = run.cfg["counts"]
    flops = sum(n * per_unit[unit]
                for i in range(FIRST, FIRST + run.slice_requests)
                for unit, n in work(run.cfg, run.mix, i).items())
    return 100.0 * flops / run.trace.window_s / counts.PEAK_FLOPS
