"""The model family ``latent_text`` on the reference's side: a CompVis
latent text-to-image model (SD v1, LDM text2img-large) in plain PyTorch.

Parts, under their published state-dict prefixes: ``unet``
(``model.diffusion_model.``), ``first_stage`` (KL, ``first_stage_model.``),
``cond`` (by ``arch["cond"]["kind"]``: ``clip``, Hugging Face's
``CLIPTextModel`` under ``cond_stage_model.transformer.text_model.``, or
``bert``, LDM-BERT under ``cond_stage_model.transformer.``) and, where
``arch`` has one, the ``scorer`` (OpenAI CLIP, ``scorer.``).  The
conditioning is one tensor: the text encoder's last hidden state
(B, T, width), the UNet's cross-attention context.
"""

from __future__ import annotations

import torch

from cdbench.counts import latent_size
from cdbench.reference import sampling
from cdbench.reference.clip import CLIP
from cdbench.reference.models import AutoencoderKL, CLIPText, LDMBert, UNet

PREFIXES = {"unet": "model.diffusion_model.", "first_stage": "first_stage_model.",
            "cond": {"clip": "cond_stage_model.transformer.text_model.",
                     "bert": "cond_stage_model.transformer."},
            "scorer": "scorer."}
PARTS = ("unet", "first_stage", "cond")


def build_parts(arch: dict, device="cpu", names=PARTS) -> dict:
    """{part: (state-dict prefix, module)} for the parts ``names`` of a
    configuration's ``arch`` block, on ``device`` (``"meta"`` for shapes)."""
    makers = {"unet": lambda: UNet(**arch["unet"]),
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


def condition(cfg: dict, parts: dict, texts, device):
    """The texts' conditioning: their hashed token ids through the text
    encoder, (B, T, width) float32."""
    c = cfg["arch"]["cond"]
    ids = sampling.hash_tokens(texts, c["vocab_size"], c["context_length"])
    return parts["cond"][1](torch.as_tensor(ids, device=device))


def eps(cfg: dict, parts: dict, x, t, cond):
    """The UNet's eps (NHWC float32) at latents ``x`` and timesteps ``t``
    under the conditioning ``cond``."""
    return parts["unet"][1](x, t, cond)


def unit_calls(cfg: dict, parts: dict) -> dict:
    """{unit: call} on the meta device for the units of model work that
    ``counts.model_flops`` counts: ``unet_row`` (one row at the latent size,
    a full-length context), ``encode_image``, ``decode_image``, ``prompt``."""
    arch = cfg["arch"]
    unet, fs, cond = (parts[k][1] for k in PARTS)
    n, res = latent_size(cfg), cfg["resolution"]
    c = arch["cond"]
    zc = arch["first_stage"]["embed_dim"]
    meta = dict(device="meta")
    return {
        "unet_row": lambda: unet(
            torch.empty(1, n, n, arch["unet"]["in_channels"], **meta),
            torch.zeros(1, dtype=torch.int64, **meta),
            torch.empty(1, c["context_length"], arch["unet"]["context_dim"], **meta)),
        "encode_image": lambda: fs.encode(
            torch.empty(1, res, res, 3, **meta), torch.empty(1, n, n, zc, **meta)),
        "decode_image": lambda: fs.decode(torch.empty(1, n, n, zc, **meta)),
        "prompt": lambda: cond(torch.zeros(1, c["context_length"], dtype=torch.int64, **meta)),
    }


def self_attention_shapes(cfg: dict) -> list:
    """(tokens, heads, head dim) of every self-attention of one UNet row,
    in the order the UNet runs them."""
    u = cfg["arch"]["unet"]
    n, mc = latent_size(cfg), u["model_channels"]
    shapes, ds = [], 1
    mults = u["channel_mult"]
    for level, mult in enumerate(mults):
        if ds in u["attention_resolutions"]:
            shapes += [((n // ds) ** 2, u["num_heads"], mult * mc // u["num_heads"])] \
                * u["num_res_blocks"] * u["transformer_depth"]
        if level != len(mults) - 1:
            ds *= 2
    mid = ((n // ds) ** 2, u["num_heads"], mults[-1] * mc // u["num_heads"])
    ups = []
    for level, mult in list(enumerate(mults))[::-1]:
        if ds in u["attention_resolutions"]:
            ups += [((n // ds) ** 2, u["num_heads"], mult * mc // u["num_heads"])] \
                * (u["num_res_blocks"] + 1) * u["transformer_depth"]
        if level:
            ds //= 2
    return shapes + [mid] * u["transformer_depth"] + ups
