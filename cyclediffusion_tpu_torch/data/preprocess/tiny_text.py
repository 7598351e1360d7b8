"""Tiny synthetic text-editing triplets for smoke runs (counterpart of
``cyclediffusion_tpu.data.preprocess.tiny_text``): seeded 32x32 images with
toy text pairs, in ``translate_text512``'s item schema."""

from __future__ import annotations

import numpy as np

from cyclediffusion_tpu_torch.data.preprocess.common import (
    ListDataset,
    PreprocessorBase,
    sample_id,
)

PAIRS = [
    ("a photo of a cat", "a photo of a dog"),
    ("a red car", "a blue car"),
    ("a winter scene", "a summer scene"),
    ("an old house", "a new house"),
]


class Preprocessor(PreprocessorBase):
    resolution = 32

    def build_dev(self):
        res = self.resolution
        start, end = getattr(self.meta_args.raw_data, "range", None) or [0, 4]

        def getter(data):
            rng = np.random.RandomState(int(data["sample_id"]))
            enc, dec = PAIRS[int(data["sample_id"]) % len(PAIRS)]
            data["encode_text"] = enc
            data["decode_text"] = dec
            data["original_image"] = rng.uniform(0, 1, size=(res, res, 3)).astype(np.float32)
            data["model_kwargs"] = data["model_kwargs"] + [
                "encode_text", "decode_text", "original_image"]
            return data

        items = [{"sample_id": sample_id(idx), "model_kwargs": ["sample_id"]}
                 for idx in range(start, end)]
        return ListDataset(items, getter)
