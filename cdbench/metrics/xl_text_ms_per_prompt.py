"""Device milliseconds per encoded prompt in the SDXL cell: ``text_ms_per_prompt``'s
reading of the program's ``graph.text`` span, here the one graph of both
towers (CLIP ViT-L/14 to its 11th layer, OpenCLIP ViT-bigG/14) and the
pooling, over the prompts it encoded.  The unconditional rows, zeros that
no tower encodes (``cond.zero_rows``), are not among them."""

from cdbench.metrics import text_ms_per_prompt as base

UNIT, LAYER, MOVES = base.UNIT, base.LAYER, base.MOVES


def read(run):
    return base.read(run)
