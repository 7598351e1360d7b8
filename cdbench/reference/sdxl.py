"""The model family ``sdxl`` on the reference's side: Stable Diffusion XL
base 1.0 (generative-models ``configs/inference/sd_xl_base.yaml``) in plain
PyTorch.

Parts, under the published state-dict prefixes of generative-models'
``DiffusionEngine`` checkpoint (``sd_xl_base_1.0``): ``unet``
(``model.diffusion_model.``), ``first_stage`` (KL-f8,
``first_stage_model.``), ``text_l`` (Hugging Face's ``CLIPTextModel`` of
CLIP ViT-L/14, ``conditioner.embedders.0.transformer.text_model.``) and
``text_g`` (OpenCLIP ViT-bigG/14's text tower,
``conditioner.embedders.1.model.``).

The UNet (``openaimodel.UNetModel``): a transformer depth per level (the
middle block takes the last level's), heads of ``num_head_channels``,
linear ``proj_in`` / ``proj_out`` around the tokens, GEGLU with the exact
GELU, and the vector conditioning ``label_emb`` (Linear -> SiLU -> Linear)
added to the timestep embedding.  The conditioning of a batch of prompts is
``{"context": (B, T, 768 + 1280), "vector": (B, 1280 + 6 x 256)}``:
CLIP ViT-L/14's ``hidden_states[11]`` (11 of its 12 layers, no final
LayerNorm) beside OpenCLIP's penultimate output (the last block's input, no
``ln_final``); OpenCLIP's pooled output (``ln_final`` of the last block's
output at the argmax of the ids, times ``text_projection``) followed by the
[cos, sin] embeddings of ``original_size``, ``crop_coords_top_left`` and
``target_size``, generative-models' ``GeneralConditioner`` order.

Departures from the published description:

* prompts go through the benchmark's hashed tokenizer, one id sequence for
  both towers, zero-padded (the published CLIP tokenizer pads with its end
  token, OpenCLIP's with 0), pooled at the argmax of the ids as published;
* an empty prompt is the unconditional branch: zeros in the context and
  the pooled part of the vector, the size embeddings kept
  (generative-models' ``force_uc_zero_embeddings=["txt"]``, diffusers'
  ``force_zeros_for_empty_prompt``);
* the micro-conditioning is the configuration's (the published default for
  1024 px: original and target size 1024 x 1024, crop at 0, 0);
* attention is plain, in blocks of rows (``models.attention``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cdbench.counts import latent_size
from cdbench.reference import models, sampling
from cdbench.reference.clip import Attention
from cdbench.reference.models import (
    AutoencoderKL,
    CLIPText,
    Downsample,
    ResBlock,
    Sequence_,
    Upsample,
    group_norm,
    timestep_embedding,
)
from cdbench.reference.numerics import Conv2d, Linear

PREFIXES = {"unet": "model.diffusion_model.", "first_stage": "first_stage_model.",
            "text_l": "conditioner.embedders.0.transformer.text_model.",
            "text_g": "conditioner.embedders.1.model."}
PARTS = ("unet", "first_stage", "text_l", "text_g")


# ---- UNet ------------------------------------------------------------------ #

class GEGLU(models.GEGLU):
    """The GEGLU with the exact (erf) GELU, as ``sgm/modules/attention.py``."""

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, 4 * dim), nn.Dropout(0.0), Linear(4 * dim, dim))

    def forward(self, x):
        return self.net(x)


class TransformerBlock(models.TransformerBlock):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__(dim, heads, dim_head, context_dim)
        self.ff = FeedForward(dim)


class SpatialTransformer(nn.Module):
    """GroupNorm -> tokens -> linear in -> blocks -> linear out -> back,
    residual (``use_linear``)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = group_norm(channels, 1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth))
        self.proj_out = Linear(inner, channels)

    def forward(self, x, emb, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + self.proj_out(y).transpose(1, 2).reshape(b, c, h, w)


class UNet(nn.Module):
    """``forward(x NHWC, t (B,), context (B, T, ctx), y (B, adm))`` -> eps NHWC."""

    def __init__(self, in_channels: int, out_channels: int, model_channels: int,
                 channel_mult, num_res_blocks: int, attention_resolutions,
                 num_head_channels: int, transformer_depth, context_dim: int,
                 adm_in_channels: int, num_classes: str = "sequential",
                 use_linear_in_transformer: bool = True):
        super().__init__()
        if num_classes != "sequential" or not use_linear_in_transformer:
            raise ValueError("the SDXL UNet has a sequential vector embedding and linear "
                             "transformer projections")
        mc = model_channels
        emb_dim = 4 * mc
        self.model_channels, self.context_dim, self.adm_in_channels = (
            mc, context_dim, adm_in_channels)
        self.time_embed = nn.Sequential(Linear(mc, emb_dim), nn.SiLU(), Linear(emb_dim, emb_dim))
        self.label_emb = nn.Sequential(nn.Sequential(
            Linear(adm_in_channels, emb_dim), nn.SiLU(), Linear(emb_dim, emb_dim)))

        def attn(ch, depth):
            return SpatialTransformer(ch, ch // num_head_channels, num_head_channels, depth,
                                      context_dim)

        ch = mc
        self.input_blocks = nn.ModuleList([Sequence_([Conv2d(in_channels, mc, 3, padding=1)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb_dim)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch, transformer_depth[level]))
                self.input_blocks.append(Sequence_(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(Sequence_([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Sequence_([ResBlock(ch, ch, emb_dim),
                                       attn(ch, transformer_depth[-1]),
                                       ResBlock(ch, ch, emb_dim)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb_dim)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch, transformer_depth[level]))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Sequence_(layers))
        self.out = nn.Sequential(group_norm(ch, 1e-5), nn.SiLU(),
                                 Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x, t, context, y):
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(t, self.model_channels).to(dtype))
        emb = emb + self.label_emb(y.to(dtype))
        h = x.permute(0, 3, 1, 2).to(dtype)
        context = context.to(dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h).permute(0, 2, 3, 1).float()


def _attention_shapes(n: int, in_channels, out_channels, model_channels, channel_mult,
                      num_res_blocks, attention_resolutions, num_head_channels,
                      transformer_depth, **_) -> list:
    """(tokens, heads, head dim) of each self-attention of a UNet row at an
    n x n latent, in the order the UNet runs them."""
    def level(ds, mult, blocks, depth):
        ch = mult * model_channels
        if ds not in attention_resolutions:
            return []
        return [((n // ds) ** 2, ch // num_head_channels, num_head_channels)] * blocks * depth

    shapes, ds = [], 1
    for i, mult in enumerate(channel_mult):
        shapes += level(ds, mult, num_res_blocks, transformer_depth[i])
        if i != len(channel_mult) - 1:
            ds *= 2
    shapes += level(ds, channel_mult[-1], 1, transformer_depth[-1])
    for i, mult in list(enumerate(channel_mult))[::-1]:
        shapes += level(ds, mult, num_res_blocks + 1, transformer_depth[i])
        if i:
            ds //= 2
    return shapes


# ---- text towers ---------------------------------------------------------------- #

def clip_hidden(model: CLIPText, ids, layers: int):
    """Hugging Face's ``hidden_states[layers]`` of a :class:`CLIPText`: the
    output of its first ``layers`` layers, no final LayerNorm, fp32."""
    t = ids.shape[1]
    e = model.embeddings
    x = e.token_embedding(ids) + e.position_embedding.weight[None, :t]
    mask = torch.full((t, t), float("-inf"), device=ids.device).triu(1)
    for layer in model.encoder.layers[:layers]:
        x = layer(x, mask)
    return x.float()


class OpenCLIPBlock(nn.Module):
    """OpenCLIP's ``ResidualAttentionBlock``: exact GELU, no layer scale."""

    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.ln_1, self.ln_2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.attn = Attention(width, heads)
        self.mlp = nn.Module()
        self.mlp.c_fc, self.mlp.c_proj = Linear(width, mlp), Linear(mlp, width)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x))))


class OpenCLIPText(nn.Module):
    """OpenCLIP's text tower (its ``CLIP`` with the visual tower deleted, as
    generative-models keeps it: ``logit_scale`` included, unused).
    ``forward(ids (B, T))`` -> (penultimate output (B, T, width), pooled
    (B, embed_dim)), fp32."""

    def __init__(self, cfg: dict):
        super().__init__()
        w = cfg["width"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], w)
        self.positional_embedding = nn.Parameter(torch.empty(cfg["context_length"], w))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            OpenCLIPBlock(w, cfg["heads"], cfg["mlp"]) for _ in range(cfg["layers"]))
        self.ln_final = nn.LayerNorm(w)
        self.text_projection = nn.Parameter(torch.empty(w, cfg["embed_dim"]))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def forward(self, ids):
        t = ids.shape[1]
        x = self.token_embedding(ids) + self.positional_embedding[None, :t]
        mask = torch.full((t, t), float("-inf"), device=ids.device).triu(1)
        blocks = self.transformer.resblocks
        for block in blocks[:-1]:
            x = block(x, mask)
        out = self.ln_final(blocks[-1](x, mask))
        eot = out[torch.arange(out.shape[0], device=ids.device), ids.argmax(dim=-1)]
        return x.float(), (eot @ self.text_projection).float()


# ---- the family's entry points --------------------------------------------------- #

def build_parts(arch: dict, device="cpu", names=PARTS) -> dict:
    """{part: (state-dict prefix, module)} for the parts ``names`` of a
    configuration's ``arch`` block, on ``device`` (``"meta"`` for shapes)."""
    makers = {"unet": lambda: UNet(**arch["unet"]),
              "first_stage": lambda: AutoencoderKL(arch["first_stage"]),
              "text_l": lambda: CLIPText(arch["text_l"]),
              "text_g": lambda: OpenCLIPText(arch["text_g"])}
    with torch.device(device):
        return {name: (PREFIXES[name], makers[name]().eval().requires_grad_(False))
                for name in names}


def _ids(cfg: dict, texts, device):
    t = cfg["arch"]["text_l"]
    return torch.as_tensor(sampling.hash_tokens(list(texts), t["vocab_size"],
                                                t["context_length"]), device=device)


def size_embedding(cfg: dict, device) -> torch.Tensor:
    """(1, 6 x size_embed_dim): the micro-conditioning's embeddings."""
    a = cfg["arch"]
    sizes = torch.tensor(a["micro_conditioning"], dtype=torch.float32, device=device)
    return timestep_embedding(sizes, a["size_embed_dim"]).reshape(1, -1)


def encode(cfg: dict, parts: dict, ids):
    """Both towers on the ids -> (context, pooled), fp32."""
    context_g, pooled = parts["text_g"][1](ids)
    context_l = clip_hidden(parts["text_l"][1], ids, cfg["arch"]["text_l"]["layer_idx"])
    return torch.cat([context_l, context_g], dim=-1), pooled


def condition(cfg: dict, parts: dict, texts, device) -> dict:
    """The texts' conditioning ``{"context", "vector"}``, float32; an empty
    text's rows are the unconditional branch's zeros."""
    texts = list(texts)
    context, pooled = encode(cfg, parts, _ids(cfg, texts, device))
    keep = torch.tensor([t != "" for t in texts], device=device)
    context = context * keep[:, None, None]
    pooled = pooled * keep[:, None]
    sizes = size_embedding(cfg, device).expand(len(texts), -1)
    return {"context": context, "vector": torch.cat([pooled, sizes], dim=-1)}


def eps(cfg: dict, parts: dict, x, t, cond):
    """The UNet's eps (NHWC float32) at latents ``x`` and timesteps ``t``
    under the conditioning ``cond``."""
    return parts["unet"][1](x, t, cond["context"], cond["vector"])


def unit_calls(cfg: dict, parts: dict) -> dict:
    """{unit: call} on the meta device for the units of model work that
    ``counts.model_flops`` counts: ``unet_row`` (one row at the latent size,
    a full-length context and the vector), ``encode_image``,
    ``decode_image``, ``prompt`` (both towers and the pooling)."""
    arch = cfg["arch"]
    unet, fs = parts["unet"][1], parts["first_stage"][1]
    n, res = latent_size(cfg), cfg["resolution"]
    t = arch["text_l"]["context_length"]
    zc = arch["first_stage"]["embed_dim"]
    meta = dict(device="meta")
    return {
        "unet_row": lambda: unet(
            torch.empty(1, n, n, arch["unet"]["in_channels"], **meta),
            torch.zeros(1, dtype=torch.int64, **meta),
            torch.empty(1, t, unet.context_dim, **meta),
            torch.empty(1, unet.adm_in_channels, **meta)),
        "encode_image": lambda: fs.encode(
            torch.empty(1, res, res, 3, **meta), torch.empty(1, n, n, zc, **meta)),
        "decode_image": lambda: fs.decode(torch.empty(1, n, n, zc, **meta)),
        "prompt": lambda: encode(cfg, parts, torch.zeros(1, t, dtype=torch.int64, **meta)),
    }


def self_attention_shapes(cfg: dict) -> list:
    """(tokens, heads, head dim) of every self-attention of one UNet row,
    in the order the UNet runs them."""
    return _attention_shapes(latent_size(cfg), **cfg["arch"]["unet"])
