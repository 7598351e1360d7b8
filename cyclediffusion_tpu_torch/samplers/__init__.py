"""Latent DDIM samplers: the DPM-Encoder and the eps-replay decoder."""

from cyclediffusion_tpu_torch.samplers.ddim import (  # noqa: F401
    ddim_decode,
    dpm_encode,
    num_recovered_eps,
)
