"""First-stage autoencoders for latent diffusion, KL and VQ (counterpart of
``AutoencoderKL`` and ``VQModel`` in ``cyclediffusion_tpu.models.autoencoder``).

The conv Encoder/Decoder backbones (ResnetBlock without time embedding,
vanilla single-head AttnBlock, asymmetric-pad Downsample) run on (N, C, H, W)
views of channels-last memory inside, their conv weights channels-last from
construction (see ``models.nn``); :meth:`AutoencoderKL.encode_moments` and
:meth:`AutoencoderKL.decode` take and return NHWC.  The VAE posterior sample
is part of the CycleDiffusion latent code, so :class:`DiagonalGaussian`
samples with explicit noise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from cyclediffusion_tpu_torch.models.nn import (
    GroupNorm,
    SpatialSelfAttention,
    channels_last_,
    nhwc_to_nchw,
)
from cyclediffusion_tpu_torch.models.unet_ddpm import Downsample, Upsample


@dataclasses.dataclass(frozen=True)
class DDConfig:
    """Mirrors the reference's ``ddconfig`` yaml block."""

    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    resolution: int = 256
    z_channels: int = 4
    double_z: bool = True

    @staticmethod
    def sd_f8() -> "DDConfig":
        """SD / txt2img-1p4B KL-f8 (v1-inference.yaml first_stage_config)."""
        return DDConfig()

    @staticmethod
    def vq_f4() -> "DDConfig":
        """FFHQ/CelebA VQ-f4 (ffhq-ldm-vq-4.yaml): z=3, ch_mult (1,2,4)."""
        return DDConfig(ch_mult=(1, 2, 4), z_channels=3, double_z=False)


def _conv3x3(cin: int, cout: int):
    return nn.Conv2d(cin, cout, 3, padding=1)


class AEResnetBlock(nn.Module):
    """ResnetBlock with temb_channels=0 (no time projection)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, 1e-6)
        self.conv1 = _conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm(32, out_channels, 1e-6)
        self.conv2 = _conv3x3(out_channels, out_channels)
        self.nin_shortcut = (
            nn.Identity() if in_channels == out_channels
            else nn.Conv2d(in_channels, out_channels, 1))

    def forward(self, x):
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        return self.nin_shortcut(x) + h


class _Level(nn.Module):
    """One resolution level: ``block.i``, ``attn.i`` and the resampler."""

    def __init__(self, blocks, attns, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample is not None:
            self.add_module(resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = AEResnetBlock(channels, channels)
        self.attn_1 = SpatialSelfAttention(channels)
        self.block_2 = AEResnetBlock(channels, channels)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


def _apply_level(level: _Level, h):
    for i, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[i](h)
    return h


class Encoder(nn.Module):
    def __init__(self, cfg: DDConfig):
        super().__init__()
        self.conv_in = _conv3x3(cfg.in_channels, cfg.ch)
        num_res = len(cfg.ch_mult)
        curr_res = cfg.resolution
        ch = cfg.ch
        self.down = nn.ModuleList()
        for i_level in range(num_res):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(AEResnetBlock(ch, block_out))
                ch = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(SpatialSelfAttention(ch))
            last = i_level == num_res - 1
            self.down.append(_Level(blocks, attns, "downsample",
                                    None if last else Downsample(ch)))
            if not last:
                curr_res //= 2
        self.mid = _Mid(ch)
        self.norm_out = GroupNorm(32, ch, 1e-6)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = _conv3x3(ch, out_ch)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _apply_level(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: DDConfig):
        super().__init__()
        num_res = len(cfg.ch_mult)
        ch = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (num_res - 1)
        self.conv_in = _conv3x3(cfg.z_channels, ch)
        self.mid = _Mid(ch)
        levels = {}
        for i_level in reversed(range(num_res)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(AEResnetBlock(ch, block_out))
                ch = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(SpatialSelfAttention(ch))
            levels[i_level] = _Level(blocks, attns, "upsample",
                                     Upsample(ch) if i_level != 0 else None)
            if i_level != 0:
                curr_res *= 2
        self.up = nn.ModuleList(levels[i] for i in range(num_res))
        self.norm_out = GroupNorm(32, ch, 1e-6)
        self.conv_out = _conv3x3(ch, cfg.out_ch)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = _apply_level(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


class DiagonalGaussian:
    """Split moments -> (mean, logvar clipped to [-30, 20]); explicit-noise
    sampling.  Channel-last moments (NHWC)."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = torch.chunk(moments, 2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        return self.mean + self.std * noise


class AutoencoderKL(nn.Module):
    """KL autoencoder: NHWC image -> moments -> DiagonalGaussian; NHWC
    latent -> image.  ``quant_conv`` / ``post_quant_conv`` are 1x1 convs
    (the JAX package's Dense over channels)."""

    def __init__(self, cfg: DDConfig, embed_dim: int = 4):
        super().__init__()
        if not cfg.double_z:
            raise ValueError("AutoencoderKL needs double_z")
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, cfg.z_channels, 1)
        channels_last_(self)

    def encode_moments(self, x):
        h = self.encoder(nhwc_to_nchw(x))
        return self.quant_conv(h).permute(0, 2, 3, 1)

    def decode(self, z):
        h = self.post_quant_conv(nhwc_to_nchw(z))
        return self.decoder(h).permute(0, 2, 3, 1)

    def forward(self, x, noise):
        return self.decode(DiagonalGaussian(self.encode_moments(x)).sample(noise))


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook lookup (taming's VectorQuantizer2,
    inference only).  The codebook stays fp32 whatever the model's dtype and
    the distances are taken in fp32, as in the JAX module, whose codebook is
    an fp32 parameter: bf16 distances would pick other codes."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.embedding.weight.data = self.embedding.weight.data.float()
        return self

    def forward(self, z):
        """NHWC latent -> (fp32 quantised latent, code indices (B, H, W))."""
        codebook = self.embedding.weight
        flat = z.reshape(-1, codebook.shape[1]).float()
        # ||z - e||^2 = ||z||^2 - 2 z.e + ||e||^2, argmin over the codebook
        d = (flat.pow(2).sum(1, keepdim=True) - 2.0 * flat @ codebook.t()
             + codebook.pow(2).sum(1)[None, :])
        idx = torch.argmin(d, dim=1)
        return codebook[idx].reshape(z.shape), idx.reshape(z.shape[:-1])


class VQModel(nn.Module):
    """VQ autoencoder with the VQModelInterface surface on NHWC tensors:
    :meth:`encode` returns the PRE-quantisation latent (the diffusion runs
    on it); :meth:`decode` quantises unless ``force_not_quantize``.
    ``quant_conv`` / ``post_quant_conv`` are 1x1 convs, as in the
    checkpoint."""

    def __init__(self, cfg: DDConfig, n_embed: int = 8192, embed_dim: int = 3):
        super().__init__()
        if cfg.double_z:
            raise ValueError("VQModel takes a single-z encoder (double_z False)")
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = nn.Conv2d(cfg.z_channels, embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, cfg.z_channels, 1)
        channels_last_(self)

    def encode(self, x):
        return self.quant_conv(self.encoder(nhwc_to_nchw(x))).permute(0, 2, 3, 1)

    def decode(self, h, force_not_quantize: bool = False):
        if not force_not_quantize:
            h = self.quantize(h)[0].to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(nhwc_to_nchw(h))).permute(0, 2, 3, 1)

    def forward(self, x):
        return self.decode(self.encode(x))
