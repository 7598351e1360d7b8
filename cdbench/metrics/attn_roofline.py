"""The attention kernels' share of their roofline in the traced slice, in %.

The bound: every UNet self-attention at 1,024 query tokens or more (the
calls the shipped port's dispatcher sends to its kernels K1 and K2; the
shorter ones and the 77-token cross-attention run as plain PyTorch), each
at its rows, heads, tokens and head size from the configuration, at the
larger of ``4 B H T^2 d`` operations over 989 TFLOP/s and the bf16 bytes
of q, k, v and o over 3.35 TB/s (``cdbench/counts.py``).  The time: the
device seconds of the kernels whose names hold one of ``PATTERNS``.  None
when the slice ran no such kernel.
"""

from cdbench import counts

UNIT = "%"
LAYER = "kernels: csrc/ K1-K4 through ops/flash_attention.py"
MOVES = "images_per_min"
PATTERNS = ("flash_fwd",)
MIN_TOKENS = 1024


def read(run):
    seconds = run.trace.seconds_matching(PATTERNS)
    rows = run.slice_rows.get("unet", 0)
    if seconds <= 0 or rows == 0:
        return None
    bound = sum(counts.attention_bound_s(rows, t, h, d)
                for t, h, d in counts.self_attention_shapes(run.cfg) if t >= MIN_TOKENS)
    return 100.0 * bound / seconds
