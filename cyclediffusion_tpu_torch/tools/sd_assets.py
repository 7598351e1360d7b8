"""Synthetic Stable Diffusion v1 assets in the layouts the port reads, for
tests and smoke runs where the real files are absent.

* :func:`compvis_state_dict` / :func:`write_sd_checkpoint`: a core's weights
  under CompVis's ``LatentDiffusion`` names (``model.diffusion_model.*``,
  ``first_stage_model.*``, ``cond_stage_model.transformer.text_model.*`` with
  HF's CLIP names), saved as ``{"state_dict": ...}`` in the core's dtype:
  the inverse of ``convert.from_torch``.
* :func:`write_bpe_merges`: a short CLIP BPE merges file (the tokenizer takes
  short files).
* :func:`seeded_scorer`: a DirectionalCLIP with a seeded random ViT-B/32 at
  its published widths.

The factory finds the checkpoint at ``<root>/ckpts/stable_diffusion/<name>``
with ``CYCLEDIFFUSION_CKPT_ROOT=<root>`` and the merges file through
``CYCLEDIFFUSION_CLIP_BPE``; install the scorer with
``runtime.context.set_directional_clip``.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import torch

from cyclediffusion_tpu_torch.convert.from_torch import (
    COND_PREFIX,
    FIRST_STAGE_PREFIX,
    UNET_PREFIX,
)

CLIP_TEXT_PREFIX = COND_PREFIX + "transformer.text_model."

# port CLIPTextEncoder name -> HF CLIPTextModel name
_HF_NAMES = (
    (r"^token_embedding\.", "embeddings.token_embedding."),
    (r"^position_embedding$", "embeddings.position_embedding.weight"),
    (r"^layers\.(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.", r"encoder.layers.\1.self_attn.\2."),
    (r"^layers\.(\d+)\.(fc1|fc2)\.", r"encoder.layers.\1.mlp.\2."),
    (r"^layers\.(\d+)\.", r"encoder.layers.\1."),
)

# a few merges over the letters of everyday prompts
MERGES = "#version: synthetic\nt h\nth e</w>\na n\ni n\ne r\no n\nr e\na t\ne n\ns t\n"


def hf_clip_text_name(port_name: str) -> str:
    for pat, rep in _HF_NAMES:
        name, n = re.subn(pat, rep, port_name)
        if n:
            return name
    return port_name


def compvis_state_dict(core) -> Dict[str, torch.Tensor]:
    """A ``LatentDiffusionCore``'s weights (on the CPU, in its dtype) under
    CompVis / HF names, with HF's ``position_ids`` buffer."""
    sd = {UNET_PREFIX + k: v for k, v in core.unet.state_dict().items()}
    sd.update({FIRST_STAGE_PREFIX + k: v for k, v in core.first_stage.state_dict().items()})
    sd.update({CLIP_TEXT_PREFIX + hf_clip_text_name(k): v
               for k, v in core.cond_model.state_dict().items()})
    sd[CLIP_TEXT_PREFIX + "embeddings.position_ids"] = torch.arange(
        core.spec.cond_cfg.max_positions)[None]
    return {k: v.detach().cpu() for k, v in sd.items()}


def write_sd_checkpoint(core, path: str) -> int:
    """``{"state_dict": compvis_state_dict(core)}`` -> ``path``; returns its bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": compvis_state_dict(core)}, path)
    return os.path.getsize(path)


def write_bpe_merges(path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(MERGES)
    return path


def seeded_scorer(seed: int, tokenizer, device="cuda"):
    """DirectionalCLIP over a seeded random ViT-B/32 (published widths)."""
    from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
    from cyclediffusion_tpu_torch.models.clip import CLIPConfig

    return DirectionalCLIP(CLIPScorer.random_init(seed, CLIPConfig.vit_b_32(), device),
                           tokenizer)
