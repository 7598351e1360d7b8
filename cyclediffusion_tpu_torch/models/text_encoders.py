"""The CLIP ViT-L/14 text encoder used for SD conditioning (counterpart of
``CLIPTextEncoder`` in ``cyclediffusion_tpu.models.text_encoders``).

Pre-LN transformer over learned position embeddings, causal mask, QuickGELU,
returning the last hidden state.  Its attention is plain: 77 tokens.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def causal_mask_bias(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 1, n, n) additive attention bias: 0 on and below the diagonal,
    float32's most negative finite value above (not -inf)."""
    keep = torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))
    neg = torch.finfo(torch.float32).min
    bias = torch.where(keep, torch.zeros((), device=device),
                       torch.full((), neg, device=device))
    return bias.to(dtype)[None, None]


def masked_multi_head_attention(q, k, v, num_heads: int, bias=None):
    """Plain multi-head attention with an optional additive (1,1,Tq,Tk) bias;
    q and k are each pre-scaled by d^-1/4, logits and softmax in fp32."""
    b, tq, width = q.shape
    tk = k.shape[1]
    d = width // num_heads
    qh = q.reshape(b, tq, num_heads, d)
    kh = k.reshape(b, tk, num_heads, d)
    vh = v.reshape(b, tk, num_heads, d)
    scale = 1.0 / torch.sqrt(torch.sqrt(torch.tensor(float(d))))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float() * scale, kh.float() * scale)
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
    return out.reshape(b, tq, width)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    intermediate_size: int = 3072

    @staticmethod
    def vit_l_14() -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14 text tower (SD v1 conditioning)."""
        return CLIPTextConfig()


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        w = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.layer_norm1 = nn.LayerNorm(w, eps=1e-5)
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)
        self.layer_norm2 = nn.LayerNorm(w, eps=1e-5)
        self.fc1 = nn.Linear(w, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, w)

    def forward(self, x, bias):
        h = self.layer_norm1(x)
        attn = masked_multi_head_attention(
            self.q_proj(h), self.k_proj(h), self.v_proj(h), self.num_heads, bias)
        x = x + self.out_proj(attn)
        h = self.fc1(self.layer_norm2(x))
        return x + self.fc2(quick_gelu(h))


class CLIPTextEncoder(nn.Module):
    """``forward(input_ids (B, T) int)`` -> last hidden state (B, T, hidden)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_positions, cfg.hidden_size))
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids):
        t = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :t]
        bias = causal_mask_bias(t, x.dtype, x.device)
        for layer in self.layers:
            x = layer(x, bias)
        return self.final_layer_norm(x)
