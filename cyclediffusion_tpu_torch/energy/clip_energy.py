"""The CLIP-similarity energy through the latent decoder, for guided sampling
(counterpart of ``cyclediffusion_tpu.energy.clip_energy``).

``energy_fn(x_t, pred_x0, t)`` decodes the step's pred_x0 latent to pixels
with the core's first stage, embeds the image with the scorer's vision
tower and scores it against a target text embedding; the gradient
:func:`samplers.guided.energy_guided_decode` takes runs backward through the
decoder, ``clip_preprocess``'s antialiased bicubic resize and clamps, and
the vision tower.  Both models' weights are frozen: the graph holds the
activations only.
"""

from __future__ import annotations

import torch

from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, normalize
from cyclediffusion_tpu_torch.models.clip import clip_preprocess


def clip_energy_fn(core, scorer: CLIPScorer, text_feature: torch.Tensor,
                   weight_prior: float = 0.0):
    """-> ``energy_fn(x_t, pred_x0, t)``, minus the summed cosine of
    CLIP(decode(pred_x0)) to ``text_feature`` ((1, D) unit norm, e.g. from
    ``scorer.embed_text``), plus ``weight_prior * 0.5 * sum(x_t^2)`` (the
    prior-z term) where ``weight_prior`` is non-zero."""
    res = scorer.config.image_resolution

    def energy_fn(x_t, pred_x0, t):
        img = core.decode_first_stage(pred_x0)                  # [-1, 1], fp32
        img01 = torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)
        # preprocessed in fp32, the tower in the scorer's dtype, as in JAX
        feats = scorer.model.encode_image(clip_preprocess(img01, res).to(scorer.dtype))
        sim = torch.sum(normalize(feats.float()) * text_feature, dim=-1)
        energy = -torch.sum(sim)
        if weight_prior:
            energy = energy + weight_prior * 0.5 * torch.sum(x_t ** 2)
        return energy

    return energy_fn
