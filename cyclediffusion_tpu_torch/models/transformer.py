"""Spatial transformer blocks for the cross-attention UNet (counterpart of
``cyclediffusion_tpu.models.transformer``: separate q/k/v projections, or
the folded self-attention kernels K3/K4 when ``folded_attn`` asks for them).

``CrossAttention``: bias-free q/k/v, 1/sqrt(d) scale, biased output
projection.  ``BasicTransformerBlock``: pre-LayerNorm self-attention ->
cross-attention -> GEGLU feed-forward, each residual.  ``SpatialTransformer``:
GroupNorm -> 1x1 in -> blocks over (h w) tokens -> 1x1 out, residual (the
1x1 convs are ``models.nn.Conv2d``: GEMMs over the tokens, biases added in
their epilogues);
``LinearSpatialTransformer`` (SDXL's ``use_linear_in_transformer``):
GroupNorm -> tokens -> linear in -> blocks -> linear out -> back, residual.

The GEGLU's GELU is the tanh form (``geglu_approximate="tanh"``: SD v1 and
LDM, as the JAX package computes it) or the exact erf form (``"none"``:
SDXL, as generative-models' ``sgm/modules/attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch import nn

from cyclediffusion_tpu_torch.models.nn import Conv2d, GroupNorm, multi_head_attention
from cyclediffusion_tpu_torch.ops import flash_attention


# self-attention over at least this many tokens goes to a folded kernel when
# ``folded_attn`` asks for one (the JAX module's threshold)
FOLDED_MIN_TOKENS = 2048
FOLDED_MODES = (None, "qo", "1")


class CrossAttention(nn.Module):
    """Multi-head attention, q from x, k/v from context (or x if None).

    ``folded_attn`` takes the values of the JAX package's
    ``CYCLEDIFFUSION_FOLDED_ATTN``: ``None`` keeps the separate projections
    around the dispatched attention; ``"qo"`` sends long self-attention to
    K3 (q and output projections in the kernel, k/v projected here), ``"1"``
    to K4 (every projection in the kernel)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, folded_attn: Optional[str] = None):
        super().__init__()
        if folded_attn not in FOLDED_MODES:
            raise ValueError(f"folded_attn={folded_attn!r} not in {FOLDED_MODES}")
        inner = heads * dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.folded_attn = folded_attn
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context=None):
        if (context is None and self.folded_attn is not None
                and x.shape[1] >= FOLDED_MIN_TOKENS):
            wo, bo = self.to_out[0].weight, self.to_out[0].bias
            if self.folded_attn == "1":
                return flash_attention.fused_self_attention_block(
                    x, self.to_q.weight, self.to_k.weight, self.to_v.weight, wo, bo,
                    self.heads)
            return flash_attention.qout_self_attention_block(
                x, self.to_q.weight, self.to_k(x), self.to_v(x), wo, bo, self.heads)
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        return self.to_out(multi_head_attention(q, k, v, self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, approximate: str = "tanh"):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)
        # jax.nn.gelu defaults to the tanh approximation
        self.approximate = approximate

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate=self.approximate)


class FeedForward(nn.Module):
    """GEGLU feed-forward with 4x expansion (``net.1`` is the reference's
    dropout slot)."""

    def __init__(self, dim: int, geglu_approximate: str = "tanh"):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * 4, geglu_approximate), nn.Identity(),
                                 nn.Linear(dim * 4, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, folded_attn: Optional[str] = None,
                 geglu_approximate: str = "tanh"):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head, folded_attn=folded_attn)
        self.ff = FeedForward(dim, geglu_approximate)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """(B, C, h, w) in and out, views of channels-last memory; the blocks
    run over its token-major (B, h*w, C) view, taken and given back without
    a copy."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 folded_attn: Optional[str] = None, geglu_approximate: str = "tanh"):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, in_channels, 1e-6)
        self.proj_in = self._projection(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim, folded_attn,
                                  geglu_approximate)
            for _ in range(depth))
        self.proj_out = self._projection(inner, in_channels)

    @staticmethod
    def _projection(cin: int, cout: int) -> nn.Module:
        return Conv2d(cin, cout, 1)

    def forward(self, x, context=None):
        h, w = x.shape[2:]
        hidden = self.proj_in(self.norm(x))
        hidden = hidden.flatten(2).transpose(1, 2)           # (b, h*w, inner)
        for block in self.transformer_blocks:
            hidden = block(hidden, context=context)
        hidden = hidden.transpose(1, 2).unflatten(2, (h, w))
        return x + self.proj_out(hidden)


class LinearSpatialTransformer(SpatialTransformer):
    """:class:`SpatialTransformer` with linear ``proj_in`` / ``proj_out``
    (generative-models' ``use_linear``: SDXL), applied to the token-major
    view of the normalised input and of the blocks' output."""

    @staticmethod
    def _projection(cin: int, cout: int) -> nn.Module:
        return nn.Linear(cin, cout)

    def forward(self, x, context=None):
        h, w = x.shape[2:]
        hidden = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for block in self.transformer_blocks:
            hidden = block(hidden, context=context)
        return x + self.proj_out(hidden).transpose(1, 2).unflatten(2, (h, w))
