"""The attention kernels' share of their roofline in the SDXL cell, in %:
``attn_roofline``'s reading, through the family's ``self_attention_shapes``:
K1 at 1,024 tokens (60 calls a UNet row, 20 heads of 64) and K2 at 4,096
(10 calls, 10 heads of 64), bound over the ``flash_fwd`` kernels' time."""

from cdbench.metrics import attn_roofline as base

UNIT, LAYER, MOVES = base.UNIT, base.LAYER, base.MOVES


def read(run):
    return base.read(run)
