"""The guided-diffusion-family UNet: the improved-DDPM pixel models (AFHQ,
FFHQ, ImageNet-512) and the latent models' UNet (counterpart of
``cyclediffusion_tpu.models.unet_gd``).

Two kinds of attention layer, chosen by ``use_spatial_transformer``: the
SD-v1 / LDM text2img-large cross-attention UNet's spatial transformers
(``context`` required), or ``GDAttentionBlock`` (the pixel models and the
unconditional FFHQ/CelebA-HQ LDM, ``ldm_ffhq256``; no context).
``use_scale_shift_norm`` conditions the ResBlocks' second norm on the
timestep by scale and shift, ``resblock_updown`` resamples inside ResBlocks
in place of the conv ``GDDownsample`` / ``GDUpsample`` layers, and
``num_classes`` adds the class-label embedding (``y``; the AFHQ preset is
``afhq256``).  The reference's stateful
head-count selection (``num_heads`` reassigned inside the layer loop when
``num_head_channels`` is set) is kept in :func:`_attn_layout`, and the
output blocks' attention blocks take ``num_heads_upsample`` (by default the
ORIGINAL ``num_heads``), so converted checkpoints attend identically.
Module names mirror the reference (``input_blocks.3.0.in_layers.2``,
``emb_layers.1``, ``out_layers.3``, ``skip_connection``, ``label_emb``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from cyclediffusion_tpu_torch.models.nn import (
    GDAttentionBlock,
    GroupNorm,
    avg_pool_2x,
    channels_last_,
    gd_timestep_embedding,
    nearest_upsample_2x,
    nhwc_to_nchw,
)
from cyclediffusion_tpu_torch.models.transformer import SpatialTransformer


@dataclasses.dataclass(frozen=True)
class GDUNetConfig:
    in_channels: int = 3
    model_channels: int = 128
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (16,)  # downsample factors (ds)
    channel_mult: Tuple[float, ...] = (1, 2, 4, 8)
    num_classes: Optional[int] = None
    num_heads: int = -1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    legacy: bool = True

    @staticmethod
    def afhq256() -> "GDUNetConfig":
        """The improved-DDPM AFHQ / FFHQ pixel UNet (256 px; attention at
        ds 16, heads of 64 channels)."""
        return GDUNetConfig(
            in_channels=3, model_channels=128, out_channels=6, num_res_blocks=1,
            attention_resolutions=(16,), channel_mult=(1, 1, 2, 2, 4, 4),
            num_heads=4, num_head_channels=64, use_scale_shift_norm=True,
            resblock_updown=True,
        )

    @staticmethod
    def sd_v1() -> "GDUNetConfig":
        """Stable Diffusion v1 UNet (configs/stable-diffusion/v1-inference.yaml)."""
        return GDUNetConfig(
            in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
            attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
            num_heads=8, use_spatial_transformer=True, transformer_depth=1,
            context_dim=768, legacy=False,
        )

    @staticmethod
    def ldm_text2img_large() -> "GDUNetConfig":
        """LDM text2img-large (txt2img-1p4B-eval.yaml): SD topology, 1280-d ctx."""
        return dataclasses.replace(GDUNetConfig.sd_v1(), context_dim=1280)

    @staticmethod
    def ldm_ffhq256() -> "GDUNetConfig":
        """Unconditional FFHQ/CelebA-HQ latent UNet (ffhq-ldm-vq-4.yaml)."""
        return GDUNetConfig(
            in_channels=3, model_channels=224, out_channels=3, num_res_blocks=2,
            attention_resolutions=(8, 4, 2), channel_mult=(1, 2, 3, 4),
            num_head_channels=32,
        )

    @staticmethod
    def tiny(context_dim: Optional[int] = 24) -> "GDUNetConfig":
        """The CPU-runnable miniature of ``LatentCoreSpec.tiny``: spatial
        transformers over a ``context_dim`` context, or with ``None`` the
        unconditional model's attention blocks."""
        return GDUNetConfig(
            in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=4,
            use_spatial_transformer=context_dim is not None, context_dim=context_dim,
            legacy=False,
        )


def _attn_layout(cfg: GDUNetConfig, ch: int, num_heads_state: int):
    """Replicate the reference's head selection (stateful num_heads)."""
    num_heads = num_heads_state
    if cfg.num_head_channels == -1:
        dim_head = ch // num_heads
    else:
        num_heads = ch // cfg.num_head_channels
        dim_head = cfg.num_head_channels
    if cfg.legacy:
        dim_head = ch // num_heads if cfg.use_spatial_transformer else cfg.num_head_channels
    return num_heads, dim_head


def _conv3x3(cin: int, cout: int, stride: int = 1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class GDResBlock(nn.Module):
    """guided-diffusion ResBlock: the timestep embedding added after the
    first conv, or with ``use_scale_shift_norm`` applied to the second norm
    as ``norm(h) * (1 + scale) + shift``; ``up`` / ``down`` resample both
    ``h`` (after the first norm and SiLU, before the first conv) and the
    skip input.  Each norm runs its SiLU in the same pass (``silu=True``),
    except the second one under scale and shift; the ``nn.SiLU`` slots keep
    the reference's module indices."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 norm_eps: float = 1e-5, use_scale_shift_norm: bool = False,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.resample = nearest_upsample_2x if up else avg_pool_2x if down else None
        self.in_layers = nn.Sequential(
            GroupNorm(32, in_channels, norm_eps), nn.SiLU(),
            _conv3x3(in_channels, out_channels))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_dim, (2 if use_scale_shift_norm else 1) * out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm(32, out_channels, norm_eps), nn.SiLU(), nn.Identity(),
            _conv3x3(out_channels, out_channels))
        self.skip_connection = (
            nn.Identity() if in_channels == out_channels
            else nn.Conv2d(in_channels, out_channels, 1))

    def forward(self, x, emb):
        h = self.in_layers[0](x, silu=True)
        if self.resample is not None:
            h, x = self.resample(h), self.resample(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = self.out_layers[3](self.out_layers[1](h))
        else:
            h = self.out_layers[3](self.out_layers[0](h + emb_out, silu=True))
        return self.skip_connection(x) + h


class GDDownsample(nn.Module):
    """Symmetric-pad stride-2 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.op = _conv3x3(channels, out_channels, stride=2)

    def forward(self, x):
        return self.op(x)


class GDUpsample(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = _conv3x3(channels, out_channels)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


def _apply_layers(layers, h, emb, context):
    for layer in layers:
        if isinstance(layer, GDResBlock):
            h = layer(h, emb)
        elif isinstance(layer, SpatialTransformer):
            h = layer(h, context)
        else:
            h = layer(h)
    return h


class GDUNet(nn.Module):
    """``forward(x (B,H,W,C) NHWC, t (B,), context (B,T,ctx) or None, y=
    (B,) class labels or None)`` -> the model output NHWC (eps, or eps and
    the variance values for a 2C ``out_channels``); the context only with
    spatial transformers, the labels exactly when ``num_classes`` is set.

    ``folded_attn`` (``None``, ``"qo"`` or ``"1"``) goes to every spatial
    transformer's self-attention (see ``transformer.CrossAttention``).

    ``encoder_cache`` / ``return_cache`` are the encoder-propagation fast
    mode (Faster Diffusion, arXiv 2312.09608): ``return_cache=True`` returns
    ``(eps, cache)`` with ``cache = (h_middle, hs)``, the middle block's
    output and the input blocks' skip activations ((B, C, H, W) views of
    channels-last memory, in the UNet's dtype); a call given that cache
    skips the input and middle blocks and runs the decoder half on it, with
    the current timestep's embedding.

    The conv weights are channels-last from construction (see
    ``models.nn``)."""

    def __init__(self, cfg: GDUNetConfig, folded_attn: Optional[str] = None):
        super().__init__()
        if cfg.use_spatial_transformer and cfg.context_dim is None:
            raise ValueError("spatial transformers need a context_dim")
        self.config = cfg
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed = nn.Sequential(
            nn.Linear(mc, emb_dim), nn.SiLU(), nn.Linear(emb_dim, emb_dim))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb_dim)

        def resblock(cin, cout, **updown):
            return GDResBlock(cin, cout, emb_dim,
                              use_scale_shift_norm=cfg.use_scale_shift_norm, **updown)

        # the reference's head bookkeeping: num_heads is reassigned per
        # layer; the output blocks' attention blocks bind to the original
        num_heads = cfg.num_heads
        heads_upsample = (cfg.num_heads_upsample if cfg.num_heads_upsample != -1
                          else cfg.num_heads)

        def make_attn(ch, upsample=False):
            nonlocal num_heads
            num_heads, dim_head = _attn_layout(cfg, ch, num_heads)
            if not cfg.use_spatial_transformer:
                return GDAttentionBlock(ch, heads_upsample if upsample else num_heads,
                                        dim_head)
            return SpatialTransformer(ch, num_heads, dim_head,
                                      depth=cfg.transformer_depth,
                                      context_dim=cfg.context_dim,
                                      folded_attn=folded_attn)

        ch = int(cfg.channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([_conv3x3(cfg.in_channels, ch)])])
        input_chans = [ch]
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                out = int(mult * mc)
                layers = [resblock(ch, out)]
                ch = out
                if ds in cfg.attention_resolutions:
                    layers.append(make_attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                input_chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([
                    resblock(ch, ch, down=True) if cfg.resblock_updown
                    else GDDownsample(ch, ch)]))
                input_chans.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList(
            [resblock(ch, ch), make_attn(ch), resblock(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                out = int(mult * mc)
                layers = [resblock(ch + input_chans.pop(), out)]
                ch = out
                if ds in cfg.attention_resolutions:
                    layers.append(make_attn(ch, upsample=True))
                if level and i == cfg.num_res_blocks:
                    layers.append(resblock(ch, ch, up=True) if cfg.resblock_updown
                                  else GDUpsample(ch, ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.Sequential(
            GroupNorm(32, ch, 1e-5), nn.SiLU(), _conv3x3(ch, cfg.out_channels))
        channels_last_(self)

    def encode(self, x, emb, context):
        """The input and middle blocks on NHWC ``x`` -> ``(h_middle, hs)``."""
        h = nhwc_to_nchw(x)
        hs = []
        for layers in self.input_blocks:
            h = _apply_layers(layers, h, emb, context)
            hs.append(h)
        return _apply_layers(self.middle_block, h, emb, context), tuple(hs)

    def decode(self, h, hs, emb, context):
        """The output blocks over an encoder's ``(h_middle, hs)`` -> eps NHWC."""
        hs = list(hs)
        for layers in self.output_blocks:
            h = _apply_layers(layers, torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out[2](self.out[0](h, silu=True)).permute(0, 2, 3, 1)

    def forward(self, x, t, context=None, encoder_cache=None, return_cache=False, y=None):
        emb = self.time_embed(
            gd_timestep_embedding(t, self.config.model_channels).to(x.dtype))
        if (y is None) != (self.config.num_classes is None):
            raise ValueError("class labels y go with num_classes, and only with it "
                             f"(num_classes={self.config.num_classes})")
        if y is not None:
            emb = emb + self.label_emb(y)
        cache = self.encode(x, emb, context) if encoder_cache is None else encoder_cache
        out = self.decode(*cache, emb, context)
        return (out, cache) if return_cache else out
