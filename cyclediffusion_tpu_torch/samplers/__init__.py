"""Latent DDIM samplers: the DPM-Encoder and the eps-replay decoder, exact
and with encoder caching (the fast mode), the stochastic refine, plain
sampling, deterministic inversion, the SDEdit-style stochastic encode and
decode, and energy-guided decoding; the pixel DDPM / eta-DDIM DPM-Encoder
and replay."""

from cyclediffusion_tpu_torch.samplers.ddim import (  # noqa: F401
    ddim_decode,
    ddim_decode_cached,
    ddim_invert,
    ddim_refine,
    ddim_sample,
    dpm_encode,
    dpm_encode_cached,
    num_recovered_eps,
    stochastic_decode,
    stochastic_encode,
)
from cyclediffusion_tpu_torch.samplers.guided import energy_guided_decode  # noqa: F401
from cyclediffusion_tpu_torch.samplers.pixel import pixel_encode, pixel_generate  # noqa: F401
