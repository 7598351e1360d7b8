"""The conditioning text encoders (counterparts of ``CLIPTextEncoder`` and
``LDMBertEncoder`` in ``cyclediffusion_tpu.models.text_encoders``).

* :class:`CLIPTextEncoder` — the CLIP ViT-L/14 text tower of SD v1: pre-LN
  transformer over learned position embeddings, causal mask, QuickGELU,
  returning the last hidden state (or, with ``hidden_layer``, Hugging
  Face's ``hidden_states[hidden_layer]``: the output of that many layers,
  no final LayerNorm, the later layers not run).
* :class:`OpenCLIPTextEncoder` — OpenCLIP's text tower (ViT-bigG/14 for
  SDXL): the same pre-LN causal transformer with exact GELU, OpenCLIP's
  names (``transformer.resblocks.i.attn.in_proj_weight``, ``ln_final``,
  ``text_projection``), returning SDXL's two readings: the penultimate
  output (the last block's input, no ``ln_final``) and the pooled vector
  (``ln_final`` of the last output at the argmax of the ids, times
  ``text_projection``).
* :class:`SDXLConditioner` — SDXL base's two towers and its vector: the
  context is CLIP ViT-L/14's ``hidden_states[11]`` and OpenCLIP's
  penultimate output side by side (B, T, 768 + 1280); the vector is the
  pooled output followed by the 256-d [cos, sin] embeddings of
  ``original_size``, ``crop_coords_top_left`` and ``target_size`` (each two
  numbers) -> (B, 2816), generative-models' ``GeneralConditioner`` order.
* :class:`LDMBertEncoder` — LDM text2img-large's BERT-style x-transformer
  encoder: token + absolute position embeddings, depth x (pre-LN attention
  with bias-free q/k/v of 8 heads x 64 -> residual, pre-LN feed-forward with
  exact GELU, 4x -> residual), final LayerNorm, no mask.

Their attention is plain: 77 tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cyclediffusion_tpu_torch.models.nn import gd_timestep_embedding


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
    """``forward(input_ids (B, T) int)`` -> last hidden state (B, T, hidden),
    or with ``hidden_layer`` the output of the first ``hidden_layer`` layers
    (the weights of all of them are held, as published)."""

    def __init__(self, cfg: CLIPTextConfig, hidden_layer: Optional[int] = None):
        super().__init__()
        self.hidden_layer = hidden_layer
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
        for layer in self.layers[:self.hidden_layer]:
            x = layer(x, bias)
        return x if self.hidden_layer is not None else self.final_layer_norm(x)


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


@dataclasses.dataclass(frozen=True)
class OpenCLIPTextConfig:
    """OpenCLIP's text tower; the defaults are ViT-bigG/14's (SDXL's second)."""

    vocab_size: int = 49408
    width: int = 1280
    layers: int = 32
    heads: int = 20
    mlp: int = 5120
    context_length: int = 77
    embed_dim: int = 1280       # text_projection's output


class OpenCLIPBlock(nn.Module):
    """OpenCLIP's ``ResidualAttentionBlock`` (``nn.MultiheadAttention``'s
    fused ``in_proj``), exact GELU."""

    def __init__(self, cfg: OpenCLIPTextConfig):
        super().__init__()
        w = cfg.width
        self.heads = cfg.heads
        self.ln_1 = nn.LayerNorm(w, eps=1e-5)
        self.attn = nn.Module()
        self.attn.in_proj_weight = nn.Parameter(torch.zeros(3 * w, w))
        self.attn.in_proj_bias = nn.Parameter(torch.zeros(3 * w))
        self.attn.out_proj = nn.Linear(w, w)
        self.ln_2 = nn.LayerNorm(w, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(w, cfg.mlp)
        self.mlp.c_proj = nn.Linear(cfg.mlp, w)

    def forward(self, x, bias):
        a = self.attn
        q, k, v = F.linear(self.ln_1(x), a.in_proj_weight, a.in_proj_bias).chunk(3, dim=-1)
        x = x + a.out_proj(masked_multi_head_attention(q, k, v, self.heads, bias))
        return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x))))


class OpenCLIPTextEncoder(nn.Module):
    """``forward(input_ids (B, T) int)`` -> (penultimate output (B, T,
    width), pooled (B, embed_dim))."""

    def __init__(self, cfg: OpenCLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            OpenCLIPBlock(cfg) for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))

    def forward(self, input_ids):
        t = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.positional_embedding[None, :t]
        bias = causal_mask_bias(t, x.dtype, x.device)
        *first, last = self.transformer.resblocks
        for block in first:
            x = block(x, bias)
        penultimate = x
        out = self.ln_final(last(x, bias))
        eot = out[torch.arange(out.shape[0], device=out.device), input_ids.argmax(dim=-1)]
        return penultimate, eot @ self.text_projection


@dataclasses.dataclass(frozen=True)
class SDXLConditionerConfig:
    clip: CLIPTextConfig = CLIPTextConfig()
    clip_layer: int = 11            # hidden_states[11] of CLIP ViT-L/14
    open_clip: OpenCLIPTextConfig = OpenCLIPTextConfig()
    size_embed_dim: int = 256       # each size number's embedding
    # original_size (h, w), crop_coords_top_left (top, left), target_size
    # (h, w): the published defaults for 1024 px generation
    micro_conditioning: Tuple[int, ...] = (1024, 1024, 0, 0, 1024, 1024)

    @staticmethod
    def sdxl_base() -> "SDXLConditionerConfig":
        return SDXLConditionerConfig()

    @property
    def context_dim(self) -> int:
        return self.clip.hidden_size + self.open_clip.width

    @property
    def vector_dim(self) -> int:
        return self.open_clip.embed_dim + len(self.micro_conditioning) * self.size_embed_dim


class SDXLConditioner(nn.Module):
    """``forward(input_ids (B, T))`` -> (context (B, T, context_dim), pooled
    (B, embed_dim)): both towers read the same ids.  :meth:`vector` appends
    the size embeddings to a pooled output, :meth:`zeros` is the
    unconditional branch's (context, pooled), encoding nothing."""

    def __init__(self, cfg: SDXLConditionerConfig):
        super().__init__()
        self.cfg = cfg
        self.clip_l = CLIPTextEncoder(cfg.clip, hidden_layer=cfg.clip_layer)
        self.open_clip = OpenCLIPTextEncoder(cfg.open_clip)
        sizes = torch.tensor(cfg.micro_conditioning, dtype=torch.float32)
        self.register_buffer("size_embedding", gd_timestep_embedding(
            sizes, cfg.size_embed_dim).reshape(1, -1), persistent=False)

    def forward(self, input_ids):
        pooled_ctx, pooled = self.open_clip(input_ids)
        return torch.cat([self.clip_l(input_ids), pooled_ctx], dim=-1), pooled

    def vector(self, pooled):
        """(B, embed_dim) pooled -> the UNet's (B, vector_dim) vector."""
        sizes = self.size_embedding.to(pooled.dtype).expand(pooled.shape[0], -1)
        return torch.cat([pooled, sizes], dim=-1)

    def zeros(self, batch: int, length: int):
        """The unconditional branch's context and pooled output: zeros."""
        w = self.size_embedding
        return (torch.zeros(batch, length, self.cfg.context_dim, dtype=w.dtype,
                            device=w.device),
                torch.zeros(batch, self.cfg.open_clip.embed_dim, dtype=w.dtype,
                            device=w.device))
