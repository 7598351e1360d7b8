"""Shared neural-net primitives (counterpart of ``cyclediffusion_tpu.models.nn``).

GroupNorm epsilons differ by family: CompVis blocks (VAE, the
SpatialTransformer's norm) use 1e-6, guided-diffusion blocks (GDResBlock,
GDAttentionBlock, the UNet's ``out.0``) use 1e-5.

The conv models take NHWC at their public functions and run on
``(N, C, H, W)`` views of channels-last memory inside: :func:`nhwc_to_nchw`
makes the first view, their conv weights are channels-last
(:func:`channels_last_`), and :class:`GroupNorm` reads and writes that
layout (``ops/group_norm.py``), so cuDNN's NHWC kernels convert nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cyclediffusion_tpu_torch.ops.flash_attention import multi_head_attention_fused
from cyclediffusion_tpu_torch.ops.group_norm import group_norm


def ddpm_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The CompVis pixel DDPM's [sin, cos] embedding, frequency divisor
    ``half - 1`` (not :func:`gd_timestep_embedding`'s [cos, sin] over
    ``half``)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


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


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC input as the NCHW view the convolutions take, in one memory
    layout (channels-last) whatever the caller's strides.  A convolution's
    algorithm, and so its rounding, follows its input's layout, and the
    DPM-Encoder's replay must evaluate a model as its encode chain did:
    an x0 permuted from an NCHW output, and every encode state made from
    it, is stored channel-major, the replay's states NHWC-contiguous."""
    return x.contiguous().permute(0, 3, 1, 2)


def channels_last_(module: nn.Module) -> nn.Module:
    """``module``'s conv weights (its 4-d parameters) converted to
    channels-last in place, one at a time; later loads (``load_state_dict``,
    ``fill_random_``), casts and moves keep that layout."""
    return module.to(memory_format=torch.channels_last)


def nearest_upsample_2x(x):
    """Nearest-neighbour 2x upsample, NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def avg_pool_2x(x):
    """2x2 average pool with stride 2, NCHW."""
    return F.avg_pool2d(x, 2, 2)


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis (dim 1) with fp32 statistics, the
    result rounded once to the input dtype (``ops.group_norm``: the
    hand-written kernels on the card), a channels-last view; ``silu=True``
    applies SiLU to that rounded result in the same pass.  The group count
    is clamped to the channel count, as in the JAX module (tiny test
    configs)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float):
        super().__init__()
        self.num_groups = min(num_groups, num_channels)
        if num_channels % self.num_groups:
            raise ValueError((num_channels, self.num_groups))
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, silu: bool = False):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu=silu)


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
        # token-major (b, hw, c): its NCHW view is channels-last, as proj_out's input
        out = torch.bmm(wgt, v.transpose(1, 2)).transpose(1, 2).unflatten(2, (h, w))
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
