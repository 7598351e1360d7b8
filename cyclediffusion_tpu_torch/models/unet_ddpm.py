"""The CompVis pixel DDPM UNet (CelebA-HQ / LSUN checkpoints) and its
resampling layers, which the VAE shares (counterpart of
``cyclediffusion_tpu.models.unet_ddpm``).

Module names are the reference's (``temb.dense.0``, ``down.0.block.1``,
``down.3.attn.0``, ``down.0.downsample.conv``, ``mid.block_1``,
``mid.attn_1``, ``up.2.upsample.conv``), so a CompVis state dict loads as
it is.  Public ``forward`` takes NHWC; the modules run on (N, C, H, W) views
of channels-last memory, the conv weights channels-last from construction
(see ``models.nn``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cyclediffusion_tpu_torch.models.nn import (
    Conv2d,
    GroupNorm,
    SpatialSelfAttention,
    channels_last_,
    ddpm_timestep_embedding,
    nearest_upsample_2x,
    nhwc_to_nchw,
)


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
        return self.conv(nearest_upsample_2x(x))


@dataclasses.dataclass(frozen=True)
class DDPMUNetConfig:
    """The reference's yml surface (``config.model.*``)."""

    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    in_channels: int = 3
    resolution: int = 256
    resamp_with_conv: bool = True


class ResnetBlock(nn.Module):
    """GroupNorm (eps 1e-6) + SiLU + conv, the timestep projection added,
    again, plus a 1x1 ``nin_shortcut`` when the width changes (inference:
    no dropout)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, 1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(32, out_channels, 1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


def _level(blocks, attns, **resample) -> nn.Module:
    level = nn.Module()
    level.block, level.attn = nn.ModuleList(blocks), nn.ModuleList(attns)
    for name, module in resample.items():
        setattr(level, name, module)
    return level


class DDPMUNet(nn.Module):
    """``forward(x (B,H,W,C) NHWC at the config's resolution, t (B,))`` ->
    eps NHWC."""

    def __init__(self, cfg: DDPMUNetConfig):
        super().__init__()
        if not cfg.resamp_with_conv:
            raise NotImplementedError("the pixel DDPMs resample with convolutions")
        self.config = cfg
        temb_ch = cfg.ch * 4
        levels = len(cfg.ch_mult)
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(cfg.ch, temb_ch),
                                         nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)

        chans, ch, res = [cfg.ch], cfg.ch, cfg.resolution
        self.down = nn.ModuleList()
        for i in range(levels):
            out = cfg.ch * cfg.ch_mult[i]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, out, temb_ch))
                ch = out
                if res in cfg.attn_resolutions:
                    attns.append(SpatialSelfAttention(ch))
                chans.append(ch)
            resample = {}
            if i != levels - 1:
                resample["downsample"] = Downsample(ch)
                chans.append(ch)
                res //= 2
            self.down.append(_level(blocks, attns, **resample))

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(ch, ch, temb_ch)
        self.mid.attn_1 = SpatialSelfAttention(ch)
        self.mid.block_2 = ResnetBlock(ch, ch, temb_ch)

        up = []
        for i in reversed(range(levels)):
            out = cfg.ch * cfg.ch_mult[i]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch + chans.pop(), out, temb_ch))
                ch = out
                if res in cfg.attn_resolutions:
                    attns.append(SpatialSelfAttention(ch))
            resample = {}
            if i != 0:
                resample["upsample"] = Upsample(ch)
                res *= 2
            up.insert(0, _level(blocks, attns, **resample))
        self.up = nn.ModuleList(up)

        self.norm_out = GroupNorm(32, ch, 1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_ch, 3, padding=1)
        channels_last_(self)

    def forward(self, x, t):
        cfg = self.config
        if not x.shape[1] == x.shape[2] == cfg.resolution:
            raise ValueError(f"input {tuple(x.shape)} is not {cfg.resolution}x{cfg.resolution}")
        temb = ddpm_timestep_embedding(t, cfg.ch).to(x.dtype)
        temb = self.temb.dense[1](F.silu(self.temb.dense[0](temb)))

        hs = [self.conv_in(nhwc_to_nchw(x))]
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[i](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(hs[-1], temb)), temb)

        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True)).permute(0, 2, 3, 1)
