"""Seeded weights for a configuration, drawn on the device under the
published state-dict names, and the per-run seeds derived from ``--seed``.

The names and shapes are the reference's: the ``build_parts`` of the
configuration's model family (``reference/<family>.py``) on the meta
device.  Each part's values come from one normal draw on the
device in the served dtype, cut into the leaves in name order and scaled
by this rule: a matrix or kernel by 1/sqrt(fan_in) (fan_in: the size of
one output row), a 1-D weight (a norm's scale) as 1 + 0.1 z, a bias as
0.1 z.  Zero-initialised layers get weights too, so attention and every
output projection reach the result.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from cdbench.registry import family

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def derive_seed(seed: int, *labels) -> int:
    """A 63-bit seed for one use of ``--seed`` (any whole number)."""
    text = ":".join([str(int(seed))] + [str(x) for x in labels])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


@torch.no_grad()
def draw_state_dict(cfg: dict, seed: int, device, dtype: torch.dtype,
                    parts=None) -> Dict[str, torch.Tensor]:
    """The weights of the configuration's ``parts`` (by default its
    family's ``PARTS``), published names -> tensors on ``device`` in
    ``dtype``; the same ``seed`` gives the same values, each part drawn
    apart from the others."""
    ref = family(cfg, "reference")
    out = {}
    for part, (prefix, module) in ref.build_parts(cfg["arch"], "meta",
                                                  parts or ref.PARTS).items():
        leaves = list(module.named_parameters())
        total = sum(p.numel() for _, p in leaves)
        gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", part))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        start = 0
        for name, p in leaves:
            z = flat[start:start + p.numel()].view(p.shape)
            start += p.numel()
            if p.ndim >= 2:
                z.mul_(p[0].numel() ** -0.5)
            elif name.endswith("weight"):
                z.mul_(0.1).add_(1.0)
            else:
                z.mul_(0.1)
            out[prefix + name] = z
    return out
