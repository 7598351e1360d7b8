"""The shared DirectionalCLIP scorer, built once (the port's counterpart of
``cyclediffusion_tpu.runtime.context``).

Assets:

* ``CYCLEDIFFUSION_CLIP_CKPT`` — OpenAI's ``ViT-B-32.pt``
* ``CYCLEDIFFUSION_CLIP_BPE``  — ``bpe_simple_vocab_16e6.txt.gz``

Without them, ``get_directional_clip(required=False)`` logs a warning and
returns None, unless a scorer was installed with :func:`set_directional_clip`
(the tiny factory installs its seeded miniature); ``required=True`` raises
``FileNotFoundError``.  With no scorer, ranking raises and the evaluators'
CLIP scores are NaN.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

_CACHE: dict = {}


def get_directional_clip(required: bool = True, device="cuda"):
    """The shared DirectionalCLIP scorer, built from the assets on first use."""
    if _CACHE.get("dclip") is not None:
        return _CACHE["dclip"]
    if "dclip" in _CACHE and not required:
        return None  # an earlier optional call found the assets missing
    ckpt = os.environ.get("CYCLEDIFFUSION_CLIP_CKPT")
    bpe = os.environ.get("CYCLEDIFFUSION_CLIP_BPE")
    if not ckpt or not bpe or not os.path.exists(ckpt) or not os.path.exists(bpe):
        msg = ("DirectionalCLIP assets missing (set CYCLEDIFFUSION_CLIP_CKPT and "
               "CYCLEDIFFUSION_CLIP_BPE): no DirectionalCLIP scorer.")
        if required:
            raise FileNotFoundError(msg)
        logger.warning(msg)
        _CACHE["dclip"] = None
        return None
    from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
    from cyclediffusion_tpu_torch.text import CLIPBPETokenizer

    dclip = DirectionalCLIP(CLIPScorer.from_checkpoint(ckpt, device=device),
                            CLIPBPETokenizer(bpe))
    _CACHE["dclip"] = dclip
    return dclip


def set_directional_clip(dclip) -> None:
    """Install a scorer (tests and smoke runs use seeded random towers)."""
    _CACHE["dclip"] = dclip


def reset() -> None:
    _CACHE.clear()
