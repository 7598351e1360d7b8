"""The share of the SDXL cell's traced slice, in %, in which no kernel, copy
or set ran on the device: ``device_idle_share``'s reading."""

from cdbench.metrics import device_idle_share as base

UNIT, LAYER, MOVES = base.UNIT, base.LAYER, base.MOVES


def read(run):
    return base.read(run)
