"""Latent DDIM samplers: the DPM-Encoder and the eps-replay decoder, exact
and with encoder caching (the fast mode)."""

from cyclediffusion_tpu_torch.samplers.ddim import (  # noqa: F401
    ddim_decode,
    ddim_decode_cached,
    dpm_encode,
    dpm_encode_cached,
    num_recovered_eps,
)
