"""Plain PyTorch models under the published state-dict names.

* :class:`UNet`: CompVis ``openaimodel.UNetModel`` with spatial
  transformers (SD v1, LDM text2img-large): ``model.diffusion_model.*``.
* :class:`AutoencoderKL`: CompVis ``AutoencoderKL`` (KL-f8):
  ``first_stage_model.*``.
* :class:`CLIPText`: Hugging Face ``CLIPTextModel`` (ViT-L/14's text tower,
  SD v1's conditioning): ``cond_stage_model.transformer.text_model.*``.
* :class:`LDMBert`: the x-transformer ``TransformerWrapper(Encoder)`` of
  LDM text2img-large: ``cond_stage_model.transformer.*`` (its unused
  ``to_logits`` head left out).

Images and latents are NHWC at the boundary and NCHW inside.  Departures
from the published code, each shared with the measured system's
definition: the GEGLU feed-forward of the spatial transformer uses GELU's
tanh form.  Attention is plain: softmax over the full logits, in blocks of
batch rows so that 4,096-token maps fit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cdbench.reference.numerics import Conv2d, Linear


def attention(q, k, v, heads: int, rows_per_block: int = 16):
    """(B, Tq, H*d) x (B, Tk, H*d) -> (B, Tq, H*d), scale d^-1/2, fp32
    softmax; computed over at most ``rows_per_block`` (batch x head)
    slices at a time."""
    b, tq, width = q.shape
    d = width // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, d).transpose(1, 2).reshape(b * heads, x.shape[1], d)

    qh, kh, vh = split(q), split(k), split(v)
    out = torch.empty_like(qh)
    for i in range(0, b * heads, rows_per_block):
        s = slice(i, i + rows_per_block)
        logits = torch.bmm(qh[s], kh[s].transpose(1, 2)).float() * d ** -0.5
        out[s] = torch.bmm(torch.softmax(logits, dim=-1).to(vh.dtype), vh[s])
    return out.reshape(b, heads, tq, d).transpose(1, 2).reshape(b, tq, width)


def group_norm(num_channels: int, eps: float) -> nn.GroupNorm:
    return nn.GroupNorm(32, num_channels, eps=eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---- UNet ------------------------------------------------------------------ #

class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(group_norm(cin, 1e-5), nn.SiLU(),
                                       Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, cout))
        self.out_layers = nn.Sequential(group_norm(cout, 1e-5), nn.SiLU(), nn.Dropout(0.0),
                                        Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = nn.Identity() if cin == cout else Conv2d(cin, cout, 1)

    def forward(self, x, emb, context):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim or dim, inner, bias=False)
        self.to_v = Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        return self.to_out(attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, 4 * dim), nn.Dropout(0.0), Linear(4 * dim, dim))

    def forward(self, x):
        return self.net(x)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, depth: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = group_norm(channels, 1e-6)
        self.proj_in = Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth))
        self.proj_out = Conv2d(inner, channels, 1)

    def forward(self, x, emb, context):
        b, _, h, w = x.shape
        y = self.proj_in(self.norm(x))
        c = y.shape[1]
        y = y.flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x, emb, context):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, emb, context):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Sequence_(nn.ModuleList):
    """CompVis's ``TimestepEmbedSequential``: blocks take the embedding and
    the context, a bare convolution takes neither."""

    def forward(self, x, emb, context):
        for layer in self:
            x = layer(x) if isinstance(layer, Conv2d) else layer(x, emb, context)
        return x


class UNet(nn.Module):
    """``forward(x NHWC, t (B,), context (B, T, ctx))`` -> eps NHWC."""

    def __init__(self, cfg: dict):
        super().__init__()
        mc, heads = cfg["model_channels"], cfg["num_heads"]
        emb_dim = 4 * mc
        self.model_channels = mc
        self.time_embed = nn.Sequential(Linear(mc, emb_dim), nn.SiLU(), Linear(emb_dim, emb_dim))

        def attn(ch):
            return SpatialTransformer(ch, heads, ch // heads, cfg["transformer_depth"],
                                      cfg["context_dim"])

        ch = mc
        self.input_blocks = nn.ModuleList([Sequence_([Conv2d(cfg["in_channels"], mc, 3, padding=1)])])
        chans, ds = [ch], 1
        mults = cfg["channel_mult"]
        for level, mult in enumerate(mults):
            for _ in range(cfg["num_res_blocks"]):
                layers = [ResBlock(ch, mult * mc, emb_dim)]
                ch = mult * mc
                if ds in cfg["attention_resolutions"]:
                    layers.append(attn(ch))
                self.input_blocks.append(Sequence_(layers))
                chans.append(ch)
            if level != len(mults) - 1:
                self.input_blocks.append(Sequence_([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Sequence_([ResBlock(ch, ch, emb_dim), attn(ch),
                                       ResBlock(ch, ch, emb_dim)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(mults))[::-1]:
            for i in range(cfg["num_res_blocks"] + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb_dim)]
                ch = mult * mc
                if ds in cfg["attention_resolutions"]:
                    layers.append(attn(ch))
                if level and i == cfg["num_res_blocks"]:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Sequence_(layers))
        self.out = nn.Sequential(group_norm(ch, 1e-5), nn.SiLU(),
                                 Conv2d(ch, cfg["out_channels"], 3, padding=1))

    def forward(self, x, t, context):
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(t, self.model_channels).to(dtype))
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


# ---- KL autoencoder ---------------------------------------------------------- #

class AEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = group_norm(cin, 1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = group_norm(cout, 1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = group_norm(c, 1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        out = attention(q, k, v, 1)
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w))


class AEDown(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class AEUp(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Level(nn.Module):
    def __init__(self, blocks, resample_name: Optional[str], resample: Optional[nn.Module]):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList()
        if resample is not None:
            self.add_module(resample_name, resample)


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = AEResBlock(c, c), AttnBlock(c), AEResBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        self.conv_in = Conv2d(cfg["in_channels"], ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = ch
        for i, mult in enumerate(mults):
            blocks = []
            for _ in range(nres):
                blocks.append(AEResBlock(cin, ch * mult))
                cin = ch * mult
            last = i == len(mults) - 1
            self.down.append(Level(blocks, "downsample", None if last else AEDown(cin)))
        self.mid = Mid(cin)
        self.norm_out = group_norm(cin, 1e-6)
        self.conv_out = Conv2d(cin, 2 * cfg["z_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        cin = ch * mults[-1]
        self.conv_in = Conv2d(cfg["z_channels"], cin, 3, padding=1)
        self.mid = Mid(cin)
        levels = {}
        for i in reversed(range(len(mults))):
            blocks = []
            for _ in range(nres + 1):
                blocks.append(AEResBlock(cin, ch * mults[i]))
                cin = ch * mults[i]
            levels[i] = Level(blocks, "upsample", AEUp(cin) if i else None)
        self.up = nn.ModuleList(levels[i] for i in range(len(mults)))
        self.norm_out = group_norm(cin, 1e-6)
        self.conv_out = Conv2d(cin, cfg["out_ch"], 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.encoder, self.decoder = Encoder(cfg), Decoder(cfg)
        z, e = cfg["z_channels"], cfg["embed_dim"]
        self.quant_conv = Conv2d(2 * z, 2 * e, 1)
        self.post_quant_conv = Conv2d(e, z, 1)

    def _dtype(self):
        return self.quant_conv.weight.dtype

    def encode(self, image_m11, noise):
        """NHWC [-1, 1] image, NHWC noise -> NHWC posterior sample (fp32)."""
        moments = self.quant_conv(self.encoder(image_m11.permute(0, 3, 1, 2).to(self._dtype())))
        mean, logvar = moments.float().chunk(2, dim=1)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        return (mean + std * noise.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode(self, z):
        """NHWC latent -> NHWC [-1, 1] image (fp32)."""
        h = self.post_quant_conv(z.permute(0, 3, 1, 2).to(self._dtype()))
        return self.decoder(h).float().permute(0, 2, 3, 1)


# ---- text encoders ------------------------------------------------------------ #

class CLIPLayer(nn.Module):
    def __init__(self, width: int, heads: int, ff: int):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.self_attn.add_module(name, Linear(width, width))
        self.layer_norm1, self.layer_norm2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Linear(width, ff), Linear(ff, width)

    def forward(self, x, mask):
        a = self.self_attn
        h = self.layer_norm1(x)
        q, k, v = a.q_proj(h), a.k_proj(h), a.v_proj(h)
        b, t, w = q.shape
        d = w // self.heads
        qh, kh, vh = (y.reshape(b, t, self.heads, d).transpose(1, 2) for y in (q, k, v))
        logits = (qh @ kh.transpose(-1, -2)).float() * d ** -0.5 + mask
        o = (torch.softmax(logits, dim=-1).to(vh.dtype) @ vh).transpose(1, 2).reshape(b, t, w)
        x = x + a.out_proj(o)
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    """``forward(ids (B, T))`` -> the last hidden state (B, T, width), fp32."""

    def __init__(self, cfg: dict):
        super().__init__()
        w = cfg["width"]
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], w)
        self.embeddings.position_embedding = nn.Embedding(cfg["context_length"], w)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPLayer(w, cfg["heads"], cfg["ff"])
                                            for _ in range(cfg["layers"]))
        self.final_layer_norm = nn.LayerNorm(w)

    def forward(self, ids):
        t = ids.shape[1]
        e = self.embeddings
        x = e.token_embedding(ids) + e.position_embedding.weight[None, :t]
        mask = torch.full((t, t), float("-inf"), device=ids.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x).float()


class BertAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k, self.to_v = (Linear(dim, heads * dim_head, bias=False)
                                           for _ in range(3))
        self.to_out = Linear(heads * dim_head, dim)

    def forward(self, x):
        return self.to_out(attention(self.to_q(x), self.to_k(x), self.to_v(x), self.heads))


class BertFF(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(Linear(dim, dim * mult), nn.GELU()),
                                 nn.Dropout(0.0), Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class LDMBert(nn.Module):
    """``forward(ids (B, T))`` -> embeddings (B, T, dim), fp32."""

    def __init__(self, cfg: dict):
        super().__init__()
        dim = cfg["width"]
        self.token_emb = nn.Embedding(cfg["vocab_size"], dim)
        self.pos_emb = nn.Module()
        self.pos_emb.emb = nn.Embedding(cfg["context_length"], dim)
        self.attn_layers = nn.Module()
        layers = []
        for _ in range(cfg["layers"]):
            layers.append(nn.ModuleList([nn.LayerNorm(dim),
                                         BertAttention(dim, cfg["heads"], cfg["dim_head"])]))
            layers.append(nn.ModuleList([nn.LayerNorm(dim), BertFF(dim, cfg["ff_mult"])]))
        self.attn_layers.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim)

    def forward(self, ids):
        x = self.token_emb(ids) + self.pos_emb.emb.weight[None, :ids.shape[1]]
        for norm, fn in self.attn_layers.layers:
            x = x + fn(norm(x))
        return self.norm(x).float()


# ---- the three parts of a latent text-to-image model ------------------------------ #

PREFIXES = {"unet": "model.diffusion_model.", "first_stage": "first_stage_model.",
            "cond": {"clip": "cond_stage_model.transformer.text_model.",
                     "bert": "cond_stage_model.transformer."},
            "scorer": "scorer."}
PARTS = ("unet", "first_stage", "cond")


def build_parts(arch: dict, device="cpu", names=PARTS) -> dict:
    """{part: (state-dict prefix, module)} for the parts ``names`` of a
    configuration's ``arch`` block, on ``device`` (``"meta"`` for shapes):
    ``unet``, ``first_stage``, ``cond`` and, where ``arch`` has one, the
    ``scorer`` (OpenAI CLIP, its names under ``scorer.``)."""
    from cdbench.reference.clip import CLIP

    makers = {"unet": lambda: UNet(arch["unet"]),
              "first_stage": lambda: AutoencoderKL(arch["first_stage"]),
              "cond": lambda: {"clip": CLIPText, "bert": LDMBert}[arch["cond"]["kind"]](
                  arch["cond"]),
              "scorer": lambda: CLIP(arch["scorer"])}
    prefixes = dict(PREFIXES, cond=PREFIXES["cond"][arch["cond"]["kind"]])
    parts = {}
    with torch.device(device):
        for name in names:
            parts[name] = (prefixes[name], makers[name]().eval().requires_grad_(False))
    return parts
