"""Unpaired domain translation task model, AFHQ cat/wild -> dog and FFHQ ->
CelebA-HQ (counterpart of ``cyclediffusion_tpu.tasks.unsupervised_translation``).

The source and target pipelines are built from one ``[gan]`` section (the
factory's ``source_`` / ``target_`` remapping) on one ``device``, which the
evaluators read for their own models; ``forward(sample_id,
original_image)`` encodes each image with the source model, ``z =
source.encode(images)``, decodes it with the target model, ``img =
target(z)``, and returns ``((original, image), weighted_loss=0,
losses={})``.

A batch runs as one: one generator, seeded from ``(base_seed, first sample
id)`` as the JAX task folds the first id into its key, makes every draw of
the batch, so the UNet runs on the whole batch.  A sample's result thus
depends on the batch it sits in, unlike the text task, which seeds and runs
each sample alone.  The class-conditional branch raises, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cyclediffusion_tpu_torch.pipelines.factory import get_gan_wrapper
from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import sample_seed


class UnsupervisedTranslation:
    def __init__(self, args, base_seed: int = 0, device="cuda"):
        self.args = args
        self.source_gan_wrapper = get_gan_wrapper(args.gan, device=device)
        self.target_gan_wrapper = get_gan_wrapper(args.gan, target=True, device=device)
        if self.source_gan_wrapper.resolution != self.target_gan_wrapper.resolution:
            raise ValueError("the source and target models differ in resolution")
        self.resolution = self.source_gan_wrapper.resolution
        self.device = self.source_gan_wrapper.device
        self.base_seed = base_seed

    def forward(self, sample_id, class_label=None, original_image=None):
        if class_label is not None:
            raise NotImplementedError("class-conditional translation is plumbed but not "
                                      "implemented")
        device = self.device
        images = torch.as_tensor(np.stack([np.asarray(im, np.float32)
                                           for im in original_image]), device=device)
        ids = np.asarray(sample_id).reshape(-1)
        gen = torch.Generator(device=device).manual_seed(sample_seed(self.base_seed, ids[0]))
        z = self.source_gan_wrapper.encode(images, gen)
        img = self.target_gan_wrapper(z, gen)
        weighted_loss = torch.zeros((images.shape[0],), dtype=torch.float32, device=device)
        return (images, img), weighted_loss, {}

    __call__ = forward


Model = UnsupervisedTranslation
