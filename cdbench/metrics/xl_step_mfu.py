"""The whole request's share of the card's dense bf16 peak in the SDXL
cell's traced slice, in %: ``step_mfu``'s reading over the ``sdxl``
family's counts (a UNet row 6.76 TFLOP at the 128 x 128 latent)."""

from cdbench.metrics import step_mfu as base

UNIT, LAYER, MOVES = base.UNIT, base.LAYER, base.MOVES


def read(run):
    return base.read(run)
