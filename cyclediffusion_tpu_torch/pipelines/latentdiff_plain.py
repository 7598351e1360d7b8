"""The deterministic-inversion latent pipeline, the reference's legacy
``LatentDiffWrapper`` (counterpart of
``cyclediffusion_tpu.pipelines.latentdiff_plain``).

encode = the first stage, then DDIM inversion at eta 0
(:func:`samplers.ddim_invert`) to x_T, flattened; generate = a plain DDIM
decode from that x_T, then the first stage's decode.  The reference's encode
calls a sampler method its vendored sampler lacks; the standard inversion
recurrence takes its place, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore
from cyclediffusion_tpu_torch.samplers import ddim_decode, ddim_invert


class LatentDiffPlainPipeline:
    """``encode(image01)`` -> z, the inverted x_T flattened to
    ``latent_dim = image_size^2 * channels``; ``__call__(z)`` -> [0, 1]
    NHWC images.  The schedule's eta is 0, so the decode draws no noise.
    ``vae_noise`` replaces the KL posterior's draw."""

    def __init__(self, core: LatentDiffusionCore, *, custom_steps: int,
                 enforce_class_input: Optional[bool] = None,
                 unconditional_guidance_scale: Optional[float] = None):
        if enforce_class_input:
            raise NotImplementedError("class-conditional latent sampling is plumbed but not "
                                      "implemented, as in the reference")
        self.core = core
        self.custom_steps = custom_steps
        self.sched = core.make_ddim_schedule(custom_steps, eta=0.0)
        spec = core.spec
        self.resolution = spec.resolution
        self.latent_dim = spec.image_size ** 2 * spec.channels

    def encode(self, image01, generator: Optional[torch.Generator] = None,
               class_label=None, *, vae_noise=None) -> torch.Tensor:
        """[0, 1] NHWC images -> z (B, latent_dim)."""
        if class_label is not None:
            raise NotImplementedError("class-conditional translation is not implemented")
        core, spec = self.core, self.core.spec
        image01 = torch.as_tensor(image01, dtype=torch.float32, device=core.device)
        if not image01.shape[1] == image01.shape[2] == self.resolution:
            raise ValueError(f"image {tuple(image01.shape)} is not "
                             f"{self.resolution}x{self.resolution}")
        image = (image01 - 0.5) * 2.0
        if spec.fs_kind == "kl" and vae_noise is None:
            vae_noise = torch.randn((image.shape[0], spec.image_size, spec.image_size,
                                     spec.embed_dim), generator=generator,
                                    device=core.device)
        x0 = core.encode_first_stage(image, vae_noise)
        return ddim_invert(core.apply_model, self.sched, x0).reshape(image.shape[0], -1)

    def generate(self, z, generator: Optional[torch.Generator] = None,
                 class_label=None) -> torch.Tensor:
        """z -> [-1, 1] NHWC images (fp32)."""
        if class_label is not None:
            raise NotImplementedError("class-conditional translation is not implemented")
        spec = self.core.spec
        if z.shape[1] != self.latent_dim:
            raise ValueError(f"z of {z.shape[1]} values per image, expected {self.latent_dim}")
        xT = z.reshape(-1, spec.image_size, spec.image_size, spec.channels)
        sample = ddim_decode(self.core.apply_model, self.sched, xT, None, generator)
        return self.core.decode_first_stage(sample)

    def __call__(self, z, generator: Optional[torch.Generator] = None,
                 class_label=None) -> torch.Tensor:
        return (self.generate(z, generator, class_label) + 1.0) / 2.0
