"""Synthetic pixel-DDPM checkpoints and a synthetic FID Inception, in the
layouts the port reads, for tests and smoke runs where the real files are
absent.

* :func:`write_pixel_checkpoint`: a pixel UNet's weights as the reference's
  checkpoints hold them, a bare state dict with no prefix (the
  improved-diffusion ``cat_ema_0.9999_050000.pt`` / ``afhq_dog_4m.pt``
  layout, or the CompVis ``celeba_hq.ckpt`` one for a ``DDPMUNet``), in the
  module's dtype.
* :func:`inception_state_dict` / :func:`write_inception_checkpoint`: seeded
  weights in pytorch-fid's ``pt_inception-2015-12-05`` layout (bias-free
  convs, BatchNorm with its running statistics, the 1008-way ``fc`` head),
  for ``CYCLEDIFFUSION_INCEPTION_CKPT``.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn

from cyclediffusion_tpu_torch.models.inception import InceptionV3Features


def write_pixel_checkpoint(model: nn.Module, path: str) -> int:
    """``model.state_dict()`` (on the CPU) -> ``path``; returns its bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return os.path.getsize(path)


def inception_state_dict(seed: int) -> Dict[str, torch.Tensor]:
    """Seeded pytorch-fid InceptionV3 weights: conv kernels std
    sqrt(2 / fan_in) (so the ReLU tower keeps its scale), BN scale 1 + 0.1
    N(0, 1), shift and running mean 0.1 N(0, 1), running variance
    U(0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in InceptionV3Features().state_dict().items()
                  if k.endswith(".conv.weight")}
    sd = {}
    for key, shape in shapes.items():
        mod, c = key[: -len(".conv.weight")], shape[0]
        sd[key] = torch.randn(shape, generator=gen) * (2.0 / shape[1:].numel()) ** 0.5
        sd[f"{mod}.bn.weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{mod}.bn.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{mod}.bn.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{mod}.bn.running_var"] = 0.5 + torch.rand(c, generator=gen)
    sd["fc.weight"] = torch.randn((1008, 2048), generator=gen) * 2048 ** -0.5
    sd["fc.bias"] = torch.zeros(1008)
    return sd


def write_inception_checkpoint(path: str, seed: int = 0) -> int:
    """:func:`inception_state_dict` -> ``path``; returns its bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(inception_state_dict(seed), path)
    return os.path.getsize(path)
