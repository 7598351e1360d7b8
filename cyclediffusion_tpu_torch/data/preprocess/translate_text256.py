"""Zero-shot text-editing triplets at 256 px, the LDM text2img-large task
(counterpart of ``cyclediffusion_tpu.data.preprocess.translate_text256``)."""

from cyclediffusion_tpu_torch.data.preprocess.translate_text512 import (
    Preprocessor as _P512,
)


class Preprocessor(_P512):
    resolution = 256
