"""The Gaussian prior energy over latent codes (counterpart of
``cyclediffusion_tpu.energy.prior_z``): 0.5 * ||z||^2 summed over every
non-batch axis.  Differentiable, so energy-guided sampling can take its
gradient."""

from __future__ import annotations

import torch


def prior_z_energy(z: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B,) energy 0.5 * sum(z^2)."""
    if z.ndim < 2:
        raise ValueError(f"z must have a batch axis, got shape {tuple(z.shape)}")
    return 0.5 * torch.sum(z ** 2, dim=tuple(range(1, z.ndim)))


class PriorZEnergy:
    """The reference module's surface."""

    @staticmethod
    def prepare_inputs(**kwargs):
        return {"z": kwargs["z"]}

    def __call__(self, z):
        return prior_z_energy(z)
