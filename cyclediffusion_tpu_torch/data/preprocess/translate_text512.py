"""Zero-shot text-editing triplets at 512 px, the SD v1 task (counterpart of
``cyclediffusion_tpu.data.preprocess.translate_text512``).

Reads ``data/translate-text.json`` (a list of {encode_text, decode_text,
img_path}); each image goes CenterCropLongEdge -> Resize(512, bilinear) ->
[0, 1].  Items carry ``model_kwargs = [sample_id, encode_text, decode_text,
original_image]``; the experiment's ``[raw_data] range`` selects the slice.
"""

from __future__ import annotations

import json

from cyclediffusion_tpu_torch.data.preprocess.common import (
    ListDataset,
    PreprocessorBase,
    resolve_path,
    sample_id,
)
from cyclediffusion_tpu_torch.data.transforms import (
    center_crop_long_edge,
    load_image,
    resize,
    to_array,
)

RESOLUTION = 512


class Preprocessor(PreprocessorBase):
    resolution = RESOLUTION

    def build_dev(self):
        with open(resolve_path("data/translate-text.json")) as f:
            raw = json.load(f)
        start, end = self.meta_args.raw_data.range
        res = self.resolution

        def getter(data):
            img = load_image(resolve_path(data["meta"]["img_path"]))
            data["encode_text"] = data["meta"]["encode_text"]
            data["decode_text"] = data["meta"]["decode_text"]
            data["original_image"] = to_array(resize(center_crop_long_edge(img), res))
            data["model_kwargs"] = data["model_kwargs"] + [
                "encode_text", "decode_text", "original_image"]
            return data

        items = [{"sample_id": sample_id(idx), "meta": meta, "model_kwargs": ["sample_id"]}
                 for idx, meta in enumerate(raw[start:end])]
        return ListDataset(items, getter)
