"""Synthetic text-conditioned latent-diffusion assets (Stable Diffusion v1,
LDM text2img-large) in the layouts the port reads, for tests and smoke runs
where the real files are absent.

* :func:`compvis_state_dict` / :func:`write_compvis_checkpoint`: a core's
  weights under CompVis's ``LatentDiffusion`` names
  (``model.diffusion_model.*``, ``first_stage_model.*``, and the cond stage:
  SD's ``cond_stage_model.transformer.text_model.*`` with HF's CLIP names,
  or text2img-large's x-transformer ``cond_stage_model.transformer.*`` with
  its unused ``to_logits`` head, zeros), saved as ``{"state_dict": ...}`` in
  the core's dtype: the inverse of ``convert.from_torch``.
* :func:`write_bpe_merges`: a short CLIP BPE merges file (the tokenizer takes
  short files).
* :func:`write_bert_vocab`: a short WordPiece ``vocab.txt`` with
  bert-base-uncased's special-token ids, covering given texts without
  ``[UNK]`` (long words as a stem and a ``##`` piece).
* :func:`seeded_scorer`: a DirectionalCLIP with a seeded random ViT-B/32 at
  its published widths.

The factory finds an SD checkpoint at ``<root>/ckpts/stable_diffusion/<name>``
and text2img-large's at ``<root>/ckpts/ldm_models/text2img-large/model.ckpt``
with ``CYCLEDIFFUSION_CKPT_ROOT=<root>``, the merges file through
``CYCLEDIFFUSION_CLIP_BPE`` and the vocab through
``CYCLEDIFFUSION_BERT_VOCAB``; install the scorer with
``runtime.context.set_directional_clip``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable

import torch

from cyclediffusion_tpu_torch.convert.from_torch import (
    COND_PREFIX,
    FIRST_STAGE_PREFIX,
    UNET_PREFIX,
)

CLIP_TEXT_PREFIX = COND_PREFIX + "transformer.text_model."
BERT_PREFIX = COND_PREFIX + "transformer."

# port CLIPTextEncoder name -> HF CLIPTextModel name
_HF_NAMES = (
    (r"^token_embedding\.", "embeddings.token_embedding."),
    (r"^position_embedding$", "embeddings.position_embedding.weight"),
    (r"^layers\.(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.", r"encoder.layers.\1.self_attn.\2."),
    (r"^layers\.(\d+)\.(fc1|fc2)\.", r"encoder.layers.\1.mlp.\2."),
    (r"^layers\.(\d+)\.", r"encoder.layers.\1."),
)

# a few merges over the letters of everyday prompts
MERGES = "#version: synthetic\nt h\nth e</w>\na n\ni n\ne r\no n\nr e\na t\ne n\ns t\n"


def hf_clip_text_name(port_name: str) -> str:
    for pat, rep in _HF_NAMES:
        name, n = re.subn(pat, rep, port_name)
        if n:
            return name
    return port_name


def compvis_bert_name(port_name: str) -> str:
    """A port ``LDMBertEncoder`` name -> its x-transformer name (attention
    and feed-forward layers alternate: layer j's are 2j and 2j+1)."""
    if port_name == "pos_emb":
        return "pos_emb.emb.weight"
    m = re.match(r"^(attn_norm|attn|ff_norm|ff_in|ff_out)\.(\d+)\.(.+)$", port_name)
    if not m:
        return port_name
    kind, j, leaf = m.group(1), int(m.group(2)), m.group(3)
    layer = 2 * j + kind.startswith("ff")
    slot = {"attn_norm": "0", "attn": "1", "ff_norm": "0", "ff_in": "1.net.0.0",
            "ff_out": "1.net.2"}[kind]
    return f"attn_layers.layers.{layer}.{slot}.{leaf}"


def compvis_state_dict(core) -> Dict[str, torch.Tensor]:
    """A ``LatentDiffusionCore``'s weights (on the CPU, in its dtype; a VQ
    codebook in fp32) under CompVis names: with HF's CLIP names and
    ``position_ids`` buffer, or the x-transformer's names and a zero
    ``to_logits`` head, or no cond stage for an unconditional model."""
    sd = {UNET_PREFIX + k: v for k, v in core.unet.state_dict().items()}
    sd.update({FIRST_STAGE_PREFIX + k: v for k, v in core.first_stage.state_dict().items()})
    if core.cond_model is None:
        return {k: v.detach().cpu() for k, v in sd.items()}
    cond = core.cond_model.state_dict()
    if core.spec.cond_kind == "clip":
        sd.update({CLIP_TEXT_PREFIX + hf_clip_text_name(k): v for k, v in cond.items()})
        sd[CLIP_TEXT_PREFIX + "embeddings.position_ids"] = torch.arange(
            core.spec.cond_cfg.max_positions)[None]
    else:
        sd.update({BERT_PREFIX + compvis_bert_name(k): v for k, v in cond.items()})
        emb = cond["token_emb.weight"]
        sd[BERT_PREFIX + "to_logits.weight"] = torch.zeros_like(emb, device="cpu")
        sd[BERT_PREFIX + "to_logits.bias"] = torch.zeros(emb.shape[0], dtype=emb.dtype)
    return {k: v.detach().cpu() for k, v in sd.items()}


def write_compvis_checkpoint(core, path: str) -> int:
    """``{"state_dict": compvis_state_dict(core)}`` -> ``path``; returns its bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": compvis_state_dict(core)}, path)
    return os.path.getsize(path)


def write_bpe_merges(path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(MERGES)
    return path


# bert-base-uncased's special tokens sit at these ids; [unused*] fill 1-99
BERT_SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}


def write_bert_vocab(path: str, texts: Iterable[str]) -> str:
    """A WordPiece ``vocab.txt`` under which every text of ``texts``
    tokenises without ``[UNK]``: the special tokens at bert-base-uncased's
    ids, then each word of the texts, a word longer than 6 characters as its
    first 4 and a ``##`` piece of the rest (whole where that would not
    tokenise back), and ``.``/``,`` and the like as their own tokens."""
    from cyclediffusion_tpu_torch.text.tokenizer import BertWordPieceTokenizer

    words = sorted({w for text in texts for w in BertWordPieceTokenizer._basic(text)})
    tokens = [BERT_SPECIALS.get(i, f"[unused{i - 1}]") for i in range(104)]
    for w in words:
        for piece in ([w[:4], "##" + w[4:]] if len(w) > 6 else [w]):
            if piece not in tokens:
                tokens.append(piece)
    while True:     # a word that a longer prefix captures is added whole
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(tokens) + "\n")
        tok = BertWordPieceTokenizer(path)
        missing = [w for w in words if tok.unk in tok._wordpiece(w)]
        if not missing:
            return path
        tokens += missing


def seeded_scorer(seed: int, tokenizer, device="cuda"):
    """DirectionalCLIP over a seeded random ViT-B/32 (published widths)."""
    from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
    from cyclediffusion_tpu_torch.models.clip import CLIPConfig

    return DirectionalCLIP(CLIPScorer.random_init(seed, CLIPConfig.vit_b_32(), device),
                           tokenizer)
