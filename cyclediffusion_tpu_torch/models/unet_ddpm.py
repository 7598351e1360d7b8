"""CompVis resampling layers (counterpart of the ``Downsample`` / ``Upsample``
of ``cyclediffusion_tpu.models.unet_ddpm``), used by the VAE.  NCHW."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class Downsample(nn.Module):
    """Asymmetric pad (right/bottom by one) then a VALID stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x then a SAME 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
