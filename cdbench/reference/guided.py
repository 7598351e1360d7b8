"""The CLIP energy of CycleDiffusion's energy-guided sampler,
``E = -sum cos(CLIP(decode(pred_x0)), text)``, and its gradient; each
guided step shifts its eps by ``weight * sqrt(a_t) / sqrt(1 - a_t) *
dE/dpred_x0`` (``drivers/guided.py``)."""

from __future__ import annotations

import torch


def clip_energy_grad(fs, scorer, pred_x0, text, scale_factor: float) -> torch.Tensor:
    """dE/dpred_x0 through the first stage's decoder and CLIP's image tower."""
    with torch.enable_grad():
        p = pred_x0.detach().float().requires_grad_(True)
        img01 = torch.clamp((fs.decode(p / scale_factor) + 1.0) / 2.0, 0.0, 1.0)
        energy = -torch.sum(scorer.embed_image(img01) * text)
        return torch.autograd.grad(energy, p)[0]

