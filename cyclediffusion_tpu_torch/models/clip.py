"""OpenAI CLIP image and text towers for DirectionalCLIP scoring (counterpart
of ``cyclediffusion_tpu.models.clip``; ViT-B/32 by default).

The vision tower is a patch-conv ViT with a class token; the text tower a
causal transformer pooled at the end token (the first argmax of the ids).
Both use QuickGELU MLPs, one fused ``in_proj`` for q/k/v, and project into
the shared embedding space.  Their attention is plain: 50 image tokens, 77
text tokens.  Images are NHWC in [0, 1], normalised by
:func:`clip_preprocess`.

Parameter names follow the JAX package's Flax tree (``resblocks.<i>.in_proj``,
``ln_1``, ``c_fc``); ``convert.from_jax`` also maps OpenAI's own state-dict
names onto them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from cyclediffusion_tpu_torch.data.device_transforms import resize_nhwc
from cyclediffusion_tpu_torch.models.nn import channels_last_
from cyclediffusion_tpu_torch.models.text_encoders import (
    causal_mask_bias,
    masked_multi_head_attention,
    quick_gelu,
)

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    patch_size: int = 32
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8

    @staticmethod
    def vit_b_32() -> "CLIPConfig":
        return CLIPConfig()


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention (one fused q/k/v projection) and QuickGELU MLP, each
    residual."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x, bias=None):
        q, k, v = self.in_proj(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.out_proj(masked_multi_head_attention(q, k, v, self.heads, bias))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPVisionTower(nn.Module):
    """``forward(images (B, H, W, 3) normalised NHWC)`` -> (B, embed_dim)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.vision_width
        grid = cfg.image_resolution // cfg.patch_size
        # channels-last, as its NHWC input's view: cuDNN then converts neither
        self.conv1 = channels_last_(
            nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size, bias=False))
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, w))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(w, cfg.vision_heads) for _ in range(cfg.vision_layers))
        self.ln_post = nn.LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, images):
        x = self.conv1(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None]
        x = self.ln_pre(x)
        for block in self.resblocks:
            x = block(x)
        return self.ln_post(x[:, 0]) @ self.proj


class CLIPTextTower(nn.Module):
    """``forward(input_ids (B, T) int)`` -> (B, embed_dim), pooled at the
    first position of the largest id (the end token)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, w))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(w, cfg.text_heads) for _ in range(cfg.text_layers))
        self.ln_final = nn.LayerNorm(w, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, input_ids):
        b, t = input_ids.shape
        x = self.token_embedding(input_ids) + self.positional_embedding[None, :t]
        bias = causal_mask_bias(t, x.dtype, x.device)
        for block in self.resblocks:
            x = block(x, bias)
        x = self.ln_final(x)
        # torch.argmax returns the first maximal index, as jnp.argmax does
        eot = torch.argmax(input_ids, dim=-1)
        return x[torch.arange(b, device=x.device), eot] @ self.text_projection


class CLIPModel(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.config = cfg
        self.visual = CLIPVisionTower(cfg)
        self.text = CLIPTextTower(cfg)

    def encode_image(self, images):
        return self.visual(images)

    def encode_text(self, input_ids):
        return self.text(input_ids)

    def forward(self, images, input_ids):
        return self.visual(images), self.text(input_ids)


def clip_preprocess(images: torch.Tensor, resolution: int = 224) -> torch.Tensor:
    """NHWC [0, 1] images -> the normalised CLIP input at ``resolution``.

    The resize is ``jax.image.resize(..., "bicubic")``'s (Keys cubic with
    a = -0.5, antialiased when downsampling, half-pixel centres), applied
    as JAX's weight matrices (``data.device_transforms.resize_nhwc``: two
    fp32 products, whose gradient is the same at every call), then a clip
    to [0, 1].  Square inputs make the reference's centre crop a no-op."""
    b, h, w, c = images.shape
    if (h, w) != (resolution, resolution):
        images = resize_nhwc(images, resolution, resolution, "bicubic", antialias=True)
        images = images.clamp(0.0, 1.0)
    mean, std = _image_stats(images.dtype, images.device)
    return (images - mean) / std


@functools.lru_cache(maxsize=None)
def _image_stats(dtype, device):
    """CLIP's channel mean and std in ``dtype`` on ``device``, copied there
    once: a host-to-device copy cannot run inside a CUDA graph's capture."""
    return (torch.tensor(CLIP_IMAGE_MEAN, dtype=dtype, device=device),
            torch.tensor(CLIP_IMAGE_STD, dtype=dtype, device=device))
