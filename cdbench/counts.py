"""The benchmark's own count of operations and bytes, and the card's peaks.

Operations are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference on the meta device (a multiply-add is two
operations), per unit of work, as the configuration's model family defines
it: for ``latent_text``, one UNet row at the configuration's latent size
with a full-length context, one image through the first stage's encoder or
decoder, one prompt through the text encoder.  The results are
stored in each configuration's file under ``counts`` and checked against
this function by a CPU test.

The attention bound of a call at (B rows, H heads, T tokens, d) is the
larger of its ``4 B H T^2 d`` operations over the peak rate and the bytes
of q, k, v and o, each read or written once, over the peak bandwidth.
"""

from __future__ import annotations

import torch

from cdbench.registry import family

# one NVIDIA H100 SXM: dense bf16 tensor-core rate and HBM3 bandwidth (data sheet)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def latent_size(cfg: dict) -> int:
    return cfg["resolution"] // 2 ** (len(cfg["arch"]["first_stage"]["ch_mult"]) - 1)


@torch.no_grad()
def model_flops(cfg: dict) -> dict:
    """{unit: operations} for the units of the configuration's model family
    (``unit_calls`` of ``reference/<family>.py``: ``unet_row``,
    ``encode_image``, ``decode_image``, ``prompt``) and, with a scorer,
    ``energy_grad`` (the CLIP energy's gradient through the decoder at one
    latent), ``clip_image`` (an image at the configuration's resolution,
    resized and embedded) and ``clip_text``."""
    from torch.utils.flop_counter import FlopCounterMode

    from cdbench.reference.guided import clip_energy_grad

    arch = cfg["arch"]
    ref = family(cfg, "reference")
    names = tuple(ref.PARTS) + (("scorer",) if "scorer" in arch else ())
    parts = ref.build_parts(arch, "meta", names)
    calls = ref.unit_calls(cfg, parts)
    if "scorer" in arch:
        fs, scorer = parts["first_stage"][1], parts["scorer"][1]
        n, res = latent_size(cfg), cfg["resolution"]
        sc, zc = arch["scorer"], arch["first_stage"]["embed_dim"]
        meta = dict(device="meta")
        calls["energy_grad"] = lambda: clip_energy_grad(
            fs, scorer, torch.empty(1, n, n, zc, **meta),
            torch.empty(1, sc["embed_dim"], **meta), arch["scale_factor"])
        calls["clip_image"] = lambda: scorer.embed_image(torch.empty(1, res, res, 3, **meta))
        calls["clip_text"] = lambda: scorer.embed_text(
            torch.zeros(1, sc["context_length"], dtype=torch.int64, **meta))
    out = {}
    for unit, call in calls.items():
        with FlopCounterMode(display=False) as counter:
            call()
        out[unit] = int(counter.get_total_flops())
    return out


def self_attention_shapes(cfg: dict) -> list:
    """(tokens, heads, head dim) of every self-attention of one UNet row,
    in the order the UNet runs them (the family's own count)."""
    return family(cfg, "reference").self_attention_shapes(cfg)


def attention_bound_s(rows: int, tokens: int, heads: int, d: int, elem_bytes: int = 2) -> float:
    """The least time of one self-attention over ``rows`` batch rows."""
    flops = 4 * rows * heads * tokens * tokens * d
    nbytes = 4 * rows * tokens * heads * d * elem_bytes
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
