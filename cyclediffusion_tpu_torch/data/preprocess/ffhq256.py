"""Hand-picked FFHQ-1024 images resized to 256, the FFHQ -> CelebA-HQ task
(counterpart of ``cyclediffusion_tpu.data.preprocess.ffhq256``): images
00001, 00011 and 00015 of ``data/images1024x1024``; ``model_kwargs =
[sample_id, original_image]``.
"""

from __future__ import annotations

from cyclediffusion_tpu_torch.data.preprocess.common import (
    ListDataset,
    PreprocessorBase,
    resolve_path,
    sample_id,
)
from cyclediffusion_tpu_torch.data.transforms import load_image, resize, to_array

ROOT = "data/images1024x1024"
PICKS = [1, 11, 15]


class Preprocessor(PreprocessorBase):
    def build_dev(self):
        def getter(data):
            img = load_image(resolve_path(f"{ROOT}/{data['meta']}"))
            data["original_image"] = to_array(resize(img, 256))
            data["model_kwargs"] = data["model_kwargs"] + ["original_image"]
            return data

        items = [{"sample_id": sample_id(idx), "meta": str(i).zfill(5) + ".png",
                  "model_kwargs": ["sample_id"]}
                 for idx, i in enumerate(PICKS)]
        return ListDataset(items, getter)
