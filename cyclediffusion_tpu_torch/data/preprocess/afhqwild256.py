"""AFHQ test-split wild animals, 512 -> 256 bilinear (counterpart of
``cyclediffusion_tpu.data.preprocess.afhqwild256``)."""

from cyclediffusion_tpu_torch.data.preprocess.afhqcat256 import Preprocessor as _Cat


class Preprocessor(_Cat):
    root = "stargan-v2/data/test/wild"
