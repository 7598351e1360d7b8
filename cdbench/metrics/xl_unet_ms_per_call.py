"""Device milliseconds per UNet call in the SDXL cell: ``unet_ms_per_call``'s
reading (CUDA events around each ``apply_model``, a 70-block, d-64,
2048-d-context UNet's graph replay at the CFG pair's batch), kept apart
from the SD and LDM cells' so that each architecture's UNet time is read
on its own."""

from cdbench.metrics import unet_ms_per_call as base

UNIT, LAYER, MOVES = base.UNIT, base.LAYER, base.MOVES


def read(run):
    return base.read(run)
