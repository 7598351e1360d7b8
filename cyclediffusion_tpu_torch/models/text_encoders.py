"""The conditioning text encoders (counterparts of ``CLIPTextEncoder`` and
``LDMBertEncoder`` in ``cyclediffusion_tpu.models.text_encoders``).

* :class:`CLIPTextEncoder` — the CLIP ViT-L/14 text tower of SD v1: pre-LN
  transformer over learned position embeddings, causal mask, QuickGELU,
  returning the last hidden state.
* :class:`LDMBertEncoder` — LDM text2img-large's BERT-style x-transformer
  encoder: token + absolute position embeddings, depth x (pre-LN attention
  with bias-free q/k/v of 8 heads x 64 -> residual, pre-LN feed-forward with
  exact GELU, 4x -> residual), final LayerNorm, no mask.

Their attention is plain: 77 tokens.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
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


@dataclasses.dataclass(frozen=True)
class LDMBertConfig:
    vocab_size: int = 30522
    dim: int = 1280
    depth: int = 32
    heads: int = 8
    dim_head: int = 64          # x_transformer's DEFAULT_DIM_HEAD; inner 512
    max_seq_len: int = 77
    ff_mult: int = 4

    @staticmethod
    def text2img_large() -> "LDMBertConfig":
        return LDMBertConfig()


class XTransformerAttention(nn.Module):
    def __init__(self, cfg: LDMBertConfig):
        super().__init__()
        inner = cfg.dim_head * cfg.heads
        self.heads = cfg.heads
        self.to_q = nn.Linear(cfg.dim, inner, bias=False)
        self.to_k = nn.Linear(cfg.dim, inner, bias=False)
        self.to_v = nn.Linear(cfg.dim, inner, bias=False)
        self.to_out = nn.Linear(inner, cfg.dim)

    def forward(self, x):
        out = masked_multi_head_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                          self.heads)
        return self.to_out(out)


class LDMBertEncoder(nn.Module):
    """``forward(input_ids (B, T) int)`` -> embeddings (B, T, dim): the
    x-transformer ``TransformerWrapper(Encoder)`` with
    ``return_embeddings=True``."""

    def __init__(self, cfg: LDMBertConfig):
        super().__init__()
        dim, depth = cfg.dim, cfg.depth
        self.token_emb = nn.Embedding(cfg.vocab_size, dim)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_seq_len, dim))
        self.attn_norm = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5) for _ in range(depth))
        self.attn = nn.ModuleList(XTransformerAttention(cfg) for _ in range(depth))
        self.ff_norm = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5) for _ in range(depth))
        self.ff_in = nn.ModuleList(nn.Linear(dim, dim * cfg.ff_mult) for _ in range(depth))
        self.ff_out = nn.ModuleList(nn.Linear(dim * cfg.ff_mult, dim) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, input_ids):
        t = input_ids.shape[1]
        x = self.token_emb(input_ids) + self.pos_emb[None, :t]
        for attn_norm, attn, ff_norm, ff_in, ff_out in zip(
                self.attn_norm, self.attn, self.ff_norm, self.ff_in, self.ff_out):
            x = x + attn(attn_norm(x))
            x = x + ff_out(F.gelu(ff_in(ff_norm(x))))
        return self.norm(x)
