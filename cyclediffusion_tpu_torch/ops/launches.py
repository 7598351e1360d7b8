"""Launch counts of the port's hand-written kernels, one dict for all.

Each wrapper call that launches a kernel adds one to its entry in
:data:`counts` (``ops.flash_attention``: K1-K4; ``ops.group_norm``: the
GroupNorm forward and its gradient).  Plain-version calls on CPU tensors are
not launches and count nothing.  A call captured into a CUDA graph launches
nothing: ``runtime.graphs`` takes what its capture counted back out and adds
it at each replay.
"""

counts = {"flash_attention_packed": 0, "flash_attention_bhtd": 0,
          "qout_self_attention_block": 0, "fused_self_attention_block": 0,
          "group_norm": 0, "group_norm_backward": 0}


def reset() -> None:
    """Set every count to zero."""
    for name in counts:
        counts[name] = 0
