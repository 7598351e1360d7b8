"""Shared neural-net primitives (counterpart of ``cyclediffusion_tpu.models.nn``).

GroupNorm epsilons differ by family: CompVis blocks (VAE, the
SpatialTransformer's norm) use 1e-6, guided-diffusion blocks (GDResBlock,
GDAttentionBlock, the UNet's ``out.0``) use 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cyclediffusion_tpu_torch.ops.flash_attention import multi_head_attention_fused


def gd_timestep_embedding(t: torch.Tensor, dim: int,
                          max_period: float = 10000.0) -> torch.Tensor:
    """guided-diffusion-style [cos, sin] embedding (improved-DDPM, LDM, SD)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=1)
    if dim % 2 == 1:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=1)
    return emb


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the port's
    entry points run on the card unless the caller passes ``"cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    return device


@torch.no_grad()
def fill_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Overwrite every parameter with seeded normal draws — zero-initialised
    layers included, so attention reaches the output of a random model.
    Matrices and kernels get std 1/sqrt(fan_in), norm scales 1 + 0.1 N(0,1),
    biases 0.1 N(0,1)."""
    for name, p in module.named_parameters():
        z = torch.randn(p.shape, generator=generator, device=p.device)
        if p.ndim >= 2:
            z = z * (p[0].numel() ** -0.5)
        elif name.endswith("weight"):
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        p.copy_(z.to(p.dtype))


def silu(x):
    return F.silu(x)


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis (dim 1) with fp32 statistics, the
    result rounded once to the input dtype.  The group count is clamped to
    the channel count, as in the JAX module (tiny test configs)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float):
        super().__init__()
        self.num_groups = min(num_groups, num_channels)
        if num_channels % self.num_groups:
            raise ValueError((num_channels, self.num_groups))
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        # F.group_norm accumulates half inputs in fp32 and rounds once
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def multi_head_attention(q, k, v, num_heads: int):
    """(B,Tq,H*D) x (B,Tk,H*D) multi-head attention; long self-attention goes
    to the flash kernels (``ops/flash_attention.py``)."""
    return multi_head_attention_fused(q, k, v, num_heads)


class SpatialSelfAttention(nn.Module):
    """Single-head spatial attention with 1x1 q/k/v/proj (CompVis AttnBlock),
    residual included.  Plain attention, as in the JAX module: the VAE's
    mid-block attention is an einsum there, not a kernel."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(32, channels, 1e-6)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).flatten(2) for m in (self.q, self.k, self.v))  # (b,c,hw)
        logits = torch.bmm(q.float().transpose(1, 2), k.float()) * (c ** -0.5)
        wgt = torch.softmax(logits, dim=-1).to(v.dtype)                 # (b,q,k)
        out = torch.bmm(v, wgt.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class GDAttentionBlock(nn.Module):
    """guided-diffusion AttentionBlock on NCHW ``x``, residual included:
    GroupNorm over the tokens, the fused ``qkv`` projection in the legacy
    ``[head][q(d), k(d), v(d)]`` channel layout, :func:`multi_head_attention`
    (a kernel at >= 1024 tokens), ``proj_out``.  ``qkv`` and ``proj_out``
    are CompVis's 1-tap Conv1d modules, applied to the token-major
    activations with their weights squeezed, as the JAX module's Dense
    layers are."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1):
        super().__init__()
        self.heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.norm = GroupNorm(32, channels, 1e-5)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        d = c // self.heads
        hn = self.norm(x.flatten(2)).transpose(1, 2)                    # (b, T, c)
        qkv = F.linear(hn, self.qkv.weight[:, :, 0], self.qkv.bias)
        qkv = qkv.reshape(b, h * w, self.heads, 3, d)
        q, k, v = (qkv[..., i, :].reshape(b, h * w, c) for i in range(3))
        out = F.linear(multi_head_attention(q, k, v, self.heads),
                       self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + out.transpose(1, 2).reshape(b, c, h, w)
