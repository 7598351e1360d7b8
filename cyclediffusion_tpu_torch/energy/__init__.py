"""Energies and scores: CLIP and directional-CLIP scoring of translated
images, the CLIP energy of guided sampling, the Gaussian prior-z energy and
the energy factory."""

from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP  # noqa: F401
from cyclediffusion_tpu_torch.energy.factory import get_energy, parse_key  # noqa: F401
from cyclediffusion_tpu_torch.energy.prior_z import prior_z_energy  # noqa: F401
