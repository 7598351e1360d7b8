"""Tiny synthetic image set for the unpaired-translation smoke path
(counterpart of ``cyclediffusion_tpu.data.preprocess.tiny_images``): seeded
16x16 images, ``[preprocess] count`` of them (default 4)."""

from __future__ import annotations

import numpy as np

from cyclediffusion_tpu_torch.data.preprocess.common import (
    ListDataset,
    PreprocessorBase,
    sample_id,
)


class Preprocessor(PreprocessorBase):
    resolution = 16
    count = 4

    def build_dev(self):
        res = self.resolution
        count = getattr(self.args.preprocess, "count", None) or self.count

        def getter(data):
            rng = np.random.RandomState(1000 + int(data["sample_id"]))
            data["original_image"] = rng.uniform(0, 1, size=(res, res, 3)).astype(np.float32)
            data["model_kwargs"] = data["model_kwargs"] + ["original_image"]
            return data

        items = [{"sample_id": sample_id(idx), "model_kwargs": ["sample_id"]}
                 for idx in range(count)]
        return ListDataset(items, getter)
