"""The energy factory (counterpart of ``cyclediffusion_tpu.energy.factory``)."""

from __future__ import annotations

from cyclediffusion_tpu_torch.energy.prior_z import PriorZEnergy


def get_energy(name: str, energy_kwargs=None, gan_wrapper=None):
    """An energy by its configured name; only ``PriorZEnergy`` exists."""
    if name == "PriorZEnergy":
        return PriorZEnergy()
    raise ValueError(name)


def parse_key(key: str):
    """An energy key -> (name, suffix): a trailing ``1`` / ``2`` or
    ``Pair`` split off, else None."""
    if key.endswith("1"):
        return key[:-1], 1
    if key.endswith("2"):
        return key[:-1], 2
    if key.endswith("Pair"):
        return key[: -len("Pair")], "Pair"
    return key, None
