"""Synthetic checkpoints of the unconditional FFHQ / CelebA-HQ LDMs in the
CompVis layout, for tests and smoke runs where the real files are absent.

:func:`write_ema_checkpoint` saves a ``LatentDiffusionCore`` (VQ first
stage, no cond stage) as the published ``model.ckpt`` files hold it: the
raw UNet under ``model.diffusion_model.*``, the LitEma shadows under
``model_ema.*`` (the parameter's name below the root with the dots
deleted, plus ``decay`` and ``num_updates``) and the VQ model under
``first_stage_model.*``.  The core's own UNet weights go into the shadows;
the raw UNet gets different seeded values, so a loader that takes the raw
weights where it should take the EMA ones fails a bit-for-bit check.  The
factory finds the file at ``<root>/ckpts/ldm_models/ldm/<type>/model.ckpt``
with ``CYCLEDIFFUSION_CKPT_ROOT=<root>``.
"""

from __future__ import annotations

import os

import torch

from cyclediffusion_tpu_torch.convert.from_torch import UNET_PREFIX, ema_key
from cyclediffusion_tpu_torch.tools.sd_assets import compvis_state_dict


def ema_state_dict(core, raw_seed: int):
    """``compvis_state_dict(core)`` with the UNet moved to its EMA shadows
    and seeded normals (std 0.02) of the same shapes and dtypes as the raw
    UNet."""
    sd = compvis_state_dict(core)
    gen = torch.Generator().manual_seed(raw_seed)
    for k in [k for k in sd if k.startswith(UNET_PREFIX)]:
        v = sd[k]
        sd[ema_key(k)] = v
        sd[k] = (0.02 * torch.randn(v.shape, generator=gen)).to(v.dtype)
    sd["model_ema.decay"] = torch.tensor(0.9999, dtype=torch.float32)
    sd["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
    return sd


def write_ema_checkpoint(core, path: str, raw_seed: int = 1) -> int:
    """``{"state_dict": ema_state_dict(core, raw_seed)}`` -> ``path``;
    returns its bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": ema_state_dict(core, raw_seed)}, path)
    return os.path.getsize(path)
