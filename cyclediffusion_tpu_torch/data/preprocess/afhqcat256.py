"""AFHQ test-split cats, 512 -> 256 bilinear, the source of unpaired cat ->
dog translation (counterpart of
``cyclediffusion_tpu.data.preprocess.afhqcat256``): the images under
``stargan-v2/data/test/cat`` (recursive, sorted), each 512x512;
``model_kwargs = [sample_id, original_image]``.  The release's JPEGs are
decoded by ``data/jpeg.py`` as Pillow decodes them.
"""

from __future__ import annotations

from cyclediffusion_tpu_torch.data.preprocess.common import (
    ListDataset,
    PreprocessorBase,
    resolve_path,
    sample_id,
)
from cyclediffusion_tpu_torch.data.transforms import (
    list_image_files_recursively,
    load_image,
    resize,
    to_array,
)

ROOT = "stargan-v2/data/test/cat"
INTERPOLATION = "bilinear"


def load_afhq(path: str):
    """An AFHQ image file -> float32 (256, 256, 3) in [0, 1]; raises unless
    it is 512x512."""
    img = load_image(path)
    if img.shape[:2] != (512, 512):
        raise ValueError(f"{path}: {img.shape[1]}x{img.shape[0]}, AFHQ images are 512x512")
    return to_array(resize(img, 256, INTERPOLATION))


class Preprocessor(PreprocessorBase):
    root = ROOT

    def build_dev(self):
        files = list_image_files_recursively(resolve_path(self.root))

        def getter(data):
            data["original_image"] = load_afhq(data["file_name"])
            data["model_kwargs"] = data["model_kwargs"] + ["original_image"]
            return data

        items = [{"sample_id": sample_id(idx), "file_name": fn, "model_kwargs": ["sample_id"]}
                 for idx, fn in enumerate(files)]
        return ListDataset(items, getter)
