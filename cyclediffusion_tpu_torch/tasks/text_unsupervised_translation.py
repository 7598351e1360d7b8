"""Zero-shot text-guided translation task model (counterpart of
``cyclediffusion_tpu.tasks.text_unsupervised_translation``).

``forward(sample_id, original_image, encode_text, decode_text)`` encodes the
z-ensemble of each image under its source text, decodes and ranks the
candidates under its target text, and returns
``((original, image), weighted_loss=0, losses={})``.

Each sample runs alone with its own generator, seeded from
``(base_seed, sample_id)``: a sample's result does not depend on what else
is in its batch.
"""

from __future__ import annotations

import numpy as np
import torch

from cyclediffusion_tpu_torch.pipelines.factory import get_gan_wrapper


def sample_seed(base_seed: int, sample_id: int) -> int:
    """A 64-bit generator seed for one sample."""
    seq = np.random.SeedSequence([int(base_seed), int(sample_id)])
    return int(seq.generate_state(1, dtype=np.uint64)[0])


class TextUnsupervisedTranslation:
    def __init__(self, args, base_seed: int = 0, device="cuda"):
        self.args = args
        self.gan_wrapper = get_gan_wrapper(args.gan, device=device)
        self.base_seed = base_seed
        self.resolution = self.gan_wrapper.resolution

    def forward(self, sample_id, original_image, encode_text, decode_text):
        pipe = self.gan_wrapper
        device = pipe.core.device
        images = torch.as_tensor(np.stack([np.asarray(im, np.float32)
                                           for im in original_image]), device=device)
        ids = np.asarray(sample_id).reshape(-1)
        if len(ids) != images.shape[0]:
            raise ValueError(f"{len(ids)} sample ids for {images.shape[0]} images")
        outs = []
        for i, sid in enumerate(ids):
            gen = torch.Generator(device=device).manual_seed(sample_seed(self.base_seed, sid))
            one = images[i:i + 1]
            z_ensemble = pipe.encode(one, [encode_text[i]], gen)
            img, _combos = pipe.forward(z_ensemble, one, [encode_text[i]],
                                        [decode_text[i]], gen)
            outs.append(img)
        weighted_loss = torch.zeros((images.shape[0],), dtype=torch.float32, device=device)
        return (images, torch.cat(outs)), weighted_loss, {}

    __call__ = forward


Model = TextUnsupervisedTranslation
