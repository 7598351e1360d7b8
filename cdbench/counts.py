"""The benchmark's own count of operations and bytes, and the card's peaks.

Operations are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference on the meta device (a multiply-add is two
operations), per unit of work: one UNet row at the configuration's latent
size with a full-length context, one image through the first stage's
encoder or decoder, one prompt through the text encoder.  The results are
stored in each configuration's file under ``counts`` and checked against
this function by a CPU test.

The attention bound of a call at (B rows, H heads, T tokens, d) is the
larger of its ``4 B H T^2 d`` operations over the peak rate and the bytes
of q, k, v and o, each read or written once, over the peak bandwidth.
"""

from __future__ import annotations

import torch

# one NVIDIA H100 SXM: dense bf16 tensor-core rate and HBM3 bandwidth (data sheet)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def latent_size(cfg: dict) -> int:
    return cfg["resolution"] // 2 ** (len(cfg["arch"]["first_stage"]["ch_mult"]) - 1)


@torch.no_grad()
def model_flops(cfg: dict) -> dict:
    """{unit: operations} for ``unet_row``, ``encode_image``,
    ``decode_image``, ``prompt`` and, with a scorer, ``energy_grad`` (the
    CLIP energy's gradient through the decoder at one latent),
    ``clip_image`` (an image at the configuration's resolution, resized
    and embedded) and ``clip_text``."""
    from torch.utils.flop_counter import FlopCounterMode

    from cdbench.reference.guided import clip_energy_grad
    from cdbench.reference.models import PARTS, build_parts

    arch = cfg["arch"]
    names = PARTS + (("scorer",) if "scorer" in arch else ())
    parts = {k: m for k, (_, m) in build_parts(arch, "meta", names).items()}
    n, res = latent_size(cfg), cfg["resolution"]
    c = arch["cond"]
    zc = arch["first_stage"]["embed_dim"]
    meta = dict(device="meta")
    calls = {
        "unet_row": lambda: parts["unet"](
            torch.empty(1, n, n, arch["unet"]["in_channels"], **meta),
            torch.zeros(1, dtype=torch.int64, **meta),
            torch.empty(1, c["context_length"], arch["unet"]["context_dim"], **meta)),
        "encode_image": lambda: parts["first_stage"].encode(
            torch.empty(1, res, res, 3, **meta), torch.empty(1, n, n, zc, **meta)),
        "decode_image": lambda: parts["first_stage"].decode(torch.empty(1, n, n, zc, **meta)),
        "prompt": lambda: parts["cond"](
            torch.zeros(1, c["context_length"], dtype=torch.int64, **meta)),
    }
    if "scorer" in arch:
        sc = arch["scorer"]
        calls["energy_grad"] = lambda: clip_energy_grad(
            parts["first_stage"], parts["scorer"], torch.empty(1, n, n, zc, **meta),
            torch.empty(1, sc["embed_dim"], **meta), arch["scale_factor"])
        calls["clip_image"] = lambda: parts["scorer"].embed_image(
            torch.empty(1, res, res, 3, **meta))
        calls["clip_text"] = lambda: parts["scorer"].embed_text(
            torch.zeros(1, sc["context_length"], dtype=torch.int64, **meta))
    out = {}
    for unit, call in calls.items():
        with FlopCounterMode(display=False) as counter:
            call()
        out[unit] = int(counter.get_total_flops())
    return out


def self_attention_shapes(cfg: dict) -> list:
    """(tokens, heads, head dim) of every self-attention of one UNet row,
    in the order the UNet runs them."""
    u = cfg["arch"]["unet"]
    n, mc = latent_size(cfg), u["model_channels"]
    shapes, ds = [], 1
    mults = u["channel_mult"]
    for level, mult in enumerate(mults):
        if ds in u["attention_resolutions"]:
            shapes += [((n // ds) ** 2, u["num_heads"], mult * mc // u["num_heads"])] \
                * u["num_res_blocks"] * u["transformer_depth"]
        if level != len(mults) - 1:
            ds *= 2
    mid = ((n // ds) ** 2, u["num_heads"], mults[-1] * mc // u["num_heads"])
    ups = []
    for level, mult in list(enumerate(mults))[::-1]:
        if ds in u["attention_resolutions"]:
            ups += [((n // ds) ** 2, u["num_heads"], mult * mc // u["num_heads"])] \
                * (u["num_res_blocks"] + 1) * u["transformer_depth"]
        if level:
            ds //= 2
    return shapes + [mid] * u["transformer_depth"] + ups


def attention_bound_s(rows: int, tokens: int, heads: int, d: int, elem_bytes: int = 2) -> float:
    """The least time of one self-attention over ``rows`` batch rows."""
    flops = 4 * rows * heads * tokens * tokens * d
    nbytes = 4 * rows * tokens * heads * d * elem_bytes
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
