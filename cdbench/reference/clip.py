"""OpenAI CLIP (ViT-B/32) under OpenAI's state-dict names, plain PyTorch,
and its image preprocessing: ``jax.image.resize``'s antialiased Keys cubic
(a = -0.5, half-pixel centres, the kernel widened by the scale when
shrinking, each output's weights summing to one), a clip to [0, 1], CLIP's
mean and std.  Text is pooled at the first position of the largest id."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cdbench.reference.numerics import Conv2d, Linear

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x < 1, near, np.where(x < 2, far, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 weights of one axis: ``out = in @ W``."""
    scale = n_out / n_in
    widen = max(1.0 / scale, 1.0)
    centres = (np.arange(n_out) + 0.5) / scale - 0.5
    w = keys_cubic((centres[None, :] - np.arange(n_in)[:, None]) / widen)
    return w / w.sum(axis=0, keepdims=True)


def preprocess(images01: torch.Tensor, resolution: int) -> torch.Tensor:
    """NHWC [0, 1] images -> CLIP's normalised input, float32."""
    b, h, w, _ = images01.shape
    x = images01.float()
    if (h, w) != (resolution, resolution):
        wh = torch.tensor(resize_matrix(h, resolution), dtype=torch.float32, device=x.device)
        ww = torch.tensor(resize_matrix(w, resolution), dtype=torch.float32, device=x.device)
        x = torch.einsum("bhwc,hy,wx->byxc", x, wh, ww).clamp(0.0, 1.0)
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return (x - mean) / std


class Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameters: one q/k/v projection."""

    quant = None

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        b, t, w = x.shape
        d = w // self.heads
        xin = x if self.quant is None else self.quant(x)
        q, k, v = torch.nn.functional.linear(xin, self.in_proj_weight,
                                             self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (y.reshape(b, t, self.heads, d).transpose(1, 2) for y in (q, k, v))
        logits = (q @ k.transpose(-1, -2)).float() * d ** -0.5
        if mask is not None:
            logits = logits + mask
        o = torch.softmax(logits, dim=-1).to(v.dtype) @ v
        return self.out_proj(o.transpose(1, 2).reshape(b, t, w))


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1, self.ln_2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.attn = Attention(width, heads)
        self.mlp = nn.Module()
        self.mlp.c_fc, self.mlp.c_proj = Linear(width, 4 * width), Linear(4 * width, width)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        h = self.mlp.c_fc(self.ln_2(x))
        return x + self.mlp.c_proj(h * torch.sigmoid(1.702 * h))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(Block(width, heads) for _ in range(layers))

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class Visual(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        w, p = cfg["vision_width"], cfg["patch_size"]
        grid = cfg["image_resolution"] // p
        self.conv1 = Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, w))
        self.ln_pre, self.ln_post = nn.LayerNorm(w), nn.LayerNorm(w)
        self.transformer = Transformer(w, cfg["vision_layers"], cfg["vision_heads"])
        self.proj = nn.Parameter(torch.empty(w, cfg["embed_dim"]))

    def forward(self, x):
        dtype = self.conv1.weight.dtype
        x = self.conv1(x.permute(0, 3, 1, 2).to(dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        return self.ln_post(self.transformer(x)[:, 0]) @ self.proj


class CLIP(nn.Module):
    """``embed_image(images01)`` / ``embed_text(ids)`` -> unit-norm float32."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.resolution = cfg["image_resolution"]
        self.visual = Visual(cfg)
        w = cfg["text_width"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], w)
        self.positional_embedding = nn.Parameter(torch.empty(cfg["context_length"], w))
        self.transformer = Transformer(w, cfg["text_layers"], cfg["text_heads"])
        self.ln_final = nn.LayerNorm(w)
        self.text_projection = nn.Parameter(torch.empty(w, cfg["embed_dim"]))

    def embed_image(self, images01):
        f = self.visual(preprocess(images01, self.resolution)).float()
        return f / f.norm(dim=-1, keepdim=True)

    def embed_text(self, ids):
        t = ids.shape[1]
        x = self.token_embedding(ids) + self.positional_embedding[:t]
        mask = torch.full((t, t), float("-inf"), device=ids.device).triu(1)
        x = self.ln_final(self.transformer(x, mask))
        f = (x[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
             @ self.text_projection).float()
        return f / f.norm(dim=-1, keepdim=True)
