"""Latent DDIM samplers: the DPM-Encoder and the eps-replay decoder, exact
and with encoder caching (the fast mode), and the stochastic refine; the
pixel DDPM / eta-DDIM DPM-Encoder and replay."""

from cyclediffusion_tpu_torch.samplers.ddim import (  # noqa: F401
    ddim_decode,
    ddim_decode_cached,
    ddim_refine,
    dpm_encode,
    dpm_encode_cached,
    num_recovered_eps,
)
from cyclediffusion_tpu_torch.samplers.pixel import pixel_encode, pixel_generate  # noqa: F401
