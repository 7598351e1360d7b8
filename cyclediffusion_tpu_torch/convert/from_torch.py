"""CompVis latent diffusion checkpoints (Stable Diffusion v1, LDM
text2img-large, the unconditional FFHQ / CelebA-HQ LDMs) and the pixel
DDPMs' checkpoints -> the port's modules (counterpart of
``load_torch_state_dict``, ``select_ema_weights``,
``split_latent_diffusion_state``, ``convert_gd_unet``, ``convert_vae``,
``convert_clip_text``, ``convert_ldm_bert`` and ``convert_ddpm_unet`` in
``cyclediffusion_tpu.convert.torch_import``).

The pixel checkpoints are a bare UNet state dict, no prefix: the
improved-diffusion UNet's (``cat_ema_0.9999_050000.pt``, ``afhq_dog_4m.pt``;
``qkv`` / ``proj_out`` 1-tap Conv1d weights, ``skip_connection`` a 1x1
conv, ``label_emb`` the class embedding) or the CompVis DDPM's
(``celeba_hq.ckpt``: ``temb.dense.0``, ``down.0.block.1``, ``mid.attn_1``,
q / k / v / ``proj_out`` 1x1 convs).  The port's UNets carry those names
and shapes, so the keys map as they are.

A Lightning ``LatentDiffusion`` state dict holds up to three subtrees:
``model.diffusion_model.*`` (the UNet), ``first_stage_model.*`` (the KL
VAE, or the VQ model with its codebook ``quantize.embedding.weight``) and,
for a text model, ``cond_stage_model.*``: SD's ``transformer.text_model.*``
(HF's ``CLIPTextModel``) or text2img-large's ``transformer.*``
(x-transformer's ``TransformerWrapper``); its other entries (the schedule
buffers, the LitEma state ``model_ema.*``) are not weights of the core,
unless ``use_ema`` takes the UNet from the LitEma shadows (the FFHQ /
CelebA-HQ models).  The port's UNet and first stages carry CompVis's own
module names and leaf shapes (1x1 convolutions and the attention blocks'
1-tap Conv1d ``qkv`` / ``proj_out`` stay convolutions), so their keys map
by stripping the prefix.  The CLIP text
tower's HF names map onto the port's ``CLIPTextEncoder``
(``encoder.layers.i.self_attn.q_proj`` -> ``layers.i.q_proj``,
``embeddings.position_embedding.weight`` -> ``position_embedding``); HF's
``position_ids`` buffer is not a weight.  The x-transformer's layers
alternate attention and feed-forward: ``attn_layers.layers.{2j}.{0,1}`` ->
``attn_norm.j`` / ``attn.j``, ``attn_layers.layers.{2j+1}.0`` ->
``ff_norm.j``, its ``1.net.0.0`` -> ``ff_in.j`` and ``1.net.2`` ->
``ff_out.j``; ``pos_emb.emb.weight`` -> ``pos_emb``; the unused
``to_logits`` head is skipped.

SDXL's checkpoint (generative-models' ``DiffusionEngine``, e.g.
``sd_xl_base_1.0``) holds the UNet and the first stage under the same
prefixes and its two text towers under ``conditioner.``:
``embedders.0.transformer.text_model.*`` (HF's CLIP ViT-L/14, mapped as
SD's tower under ``clip_l.``) and ``embedders.1.model.*`` (OpenCLIP
ViT-bigG/14's text tower, whose names the port's ``OpenCLIPTextEncoder``
carries under ``open_clip.``; its ``logit_scale`` is no weight of the
core).  The UNet's ``label_emb.0.0`` / ``label_emb.0.2`` and its linear
``proj_in`` / ``proj_out`` map as they are.
A key that maps to no parameter, a parameter that no key sets, or a shape
that disagrees raises, naming the key.  Values are cast to the module's
dtype as they are copied into it.
"""

from __future__ import annotations

import re
from typing import Dict

import torch
from torch import nn

UNET_PREFIX = "model.diffusion_model."
FIRST_STAGE_PREFIX = "first_stage_model."
COND_PREFIX = "cond_stage_model."
CONDITIONER_PREFIX = "conditioner."

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A torch checkpoint's tensors (on the CPU, memory-mapped), unwrapping
    ``{"state_dict": ...}``.  Loaded with ``weights_only=True``: tensors and
    plain containers only, nothing else is unpickled."""
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def ema_key(key: str) -> str:
    """LitEma's name of a parameter's shadow: its name below the root module
    with the dots deleted (``model.diffusion_model.out.2.weight`` ->
    ``model_ema.diffusion_modelout2weight``)."""
    return "model_ema." + key.split(".", 1)[1].replace(".", "")


def select_ema_weights(sd: StateDict, prefix: str = UNET_PREFIX) -> StateDict:
    """Replace ``prefix`` weights with their LitEma shadows (:func:`ema_key`).
    Raises if there is none."""
    out = dict(sd)
    hits = 0
    for k in sd:
        if k.startswith(prefix) and ema_key(k) in sd:
            out[k] = sd[ema_key(k)]
            hits += 1
    if hits == 0:
        ema_prefix = "model_ema." + prefix.split(".", 1)[1].split(".")[0]
        raise ValueError(f"no EMA shadows found under {ema_prefix}*")
    return out


def split_latent_diffusion_state(sd: StateDict, use_ema: bool = False,
                                 cond_prefix: str = COND_PREFIX):
    """-> (unet, first stage, cond stage) state dicts, prefixes stripped;
    the cond stage is under ``cond_prefix`` (``CONDITIONER_PREFIX`` for
    SDXL)."""
    if use_ema:
        sd = select_ema_weights(sd)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    return sub(UNET_PREFIX), sub(FIRST_STAGE_PREFIX), sub(cond_prefix)


def _to_module(sd: StateDict, module: nn.Module, rename, label: str,
               prefix: str) -> StateDict:
    """Map ``sd``'s keys (``prefix`` stripped) onto ``module``'s names."""
    targets = module.state_dict()
    out = {}
    for key, value in sd.items():
        name = rename(key)
        if name is None:
            continue
        if name not in targets:
            raise KeyError(f"unmapped {label} key: {prefix}{key}")
        if tuple(value.shape) != tuple(targets[name].shape):
            raise ValueError(f"{label} key {prefix}{key}: shape {tuple(value.shape)}, "
                             f"the port's {name} is {tuple(targets[name].shape)}")
        out[name] = value
    missing = [n for n in targets if n not in out]
    if missing:
        raise KeyError(f"{label} checkpoint lacks {len(missing)} weight(s), first "
                       f"{missing[:4]}")
    return out


def convert_gd_unet(unet_sd: StateDict, module: nn.Module) -> StateDict:
    """``openaimodel.UNetModel`` weights (prefix stripped) -> the port's GDUNet."""
    return _to_module(unet_sd, module, lambda k: k, "gd-unet", UNET_PREFIX)


def convert_pixel_gd_unet(sd: StateDict, module: nn.Module) -> StateDict:
    """An improved-diffusion ``UNetModel`` state dict -> the port's GDUNet."""
    return _to_module(sd, module, lambda k: k, "improved-diffusion unet", "")


def convert_ddpm_unet(sd: StateDict, module: nn.Module) -> StateDict:
    """A CompVis pixel ``DDPM`` state dict -> the port's DDPMUNet."""
    return _to_module(sd, module, lambda k: k, "ddpm-unet", "")


def convert_vae(first_stage_sd: StateDict, module: nn.Module) -> StateDict:
    """``AutoencoderKL`` / ``VQModelInterface`` weights (prefix stripped) ->
    the port's AutoencoderKL / VQModel."""
    return _to_module(first_stage_sd, module, lambda k: k, "first-stage", FIRST_STAGE_PREFIX)


_CLIP_TEXT_RENAMES = (
    (r"^embeddings\.token_embedding\.", "token_embedding."),
    (r"^embeddings\.position_embedding\.weight$", "position_embedding"),
    (r"^encoder\.layers\.(\d+)\.(?:self_attn|mlp)\.", r"layers.\1."),
    (r"^encoder\.layers\.(\d+)\.", r"layers.\1."),
)


def clip_text_name(hf_key: str):
    """An HF ``CLIPTextModel`` key, with or without ``transformer.`` /
    ``text_model.``, -> the port's ``CLIPTextEncoder`` name (None for the
    ``position_ids`` buffer)."""
    k = hf_key
    for p in ("transformer.", "text_model."):
        if k.startswith(p):
            k = k[len(p):]
    if k == "embeddings.position_ids":
        return None
    for pat, rep in _CLIP_TEXT_RENAMES:
        k, n = re.subn(pat, rep, k)
        if n:
            break
    return k


def convert_clip_text(cond_sd: StateDict, module: nn.Module) -> StateDict:
    """The cond stage's HF CLIP text weights -> the port's CLIPTextEncoder."""
    return _to_module(cond_sd, module, clip_text_name, "clip-text", COND_PREFIX)


_LDM_BERT_FF = {"net.0.0": "ff_in", "net.2": "ff_out"}


def ldm_bert_name(key: str):
    """An x-transformer ``TransformerWrapper`` key, with or without
    ``transformer.``, -> the port's ``LDMBertEncoder`` name (None for the
    ``to_logits`` head); an unknown key maps to itself, which no parameter
    has."""
    k = key[len("transformer."):] if key.startswith("transformer.") else key
    if k.startswith("to_logits."):
        return None
    if k == "pos_emb.emb.weight":
        return "pos_emb"
    m = re.match(r"^attn_layers\.layers\.(\d+)\.([01])\.(.+)$", k)
    if not m:
        return k
    layer, slot, rest = int(m.group(1)), m.group(2), m.group(3)
    j, is_ff = layer // 2, layer % 2 == 1
    if slot == "0":
        return f"{'ff_norm' if is_ff else 'attn_norm'}.{j}.{rest}"
    if not is_ff:
        return f"attn.{j}.{rest}"
    sub, leaf = rest.rsplit(".", 1)
    return f"{_LDM_BERT_FF[sub]}.{j}.{leaf}" if sub in _LDM_BERT_FF else k


def convert_ldm_bert(cond_sd: StateDict, module: nn.Module) -> StateDict:
    """The cond stage's x-transformer weights -> the port's LDMBertEncoder."""
    return _to_module(cond_sd, module, ldm_bert_name, "ldm-bert", COND_PREFIX)


_SDXL_TOWERS = (("embedders.0.transformer.", "clip_l.", clip_text_name),
                ("embedders.1.model.", "open_clip.", lambda k: None if k == "logit_scale" else k))


def sdxl_conditioner_name(key: str):
    """A key under SDXL's ``conditioner.`` -> the port's ``SDXLConditioner``
    name (None for OpenCLIP's ``logit_scale`` and HF's ``position_ids``);
    an unknown key maps to itself, which no parameter has."""
    for prefix, port, rename in _SDXL_TOWERS:
        if key.startswith(prefix):
            name = rename(key[len(prefix):])
            return None if name is None else port + name
    return key


def convert_sdxl_conditioner(cond_sd: StateDict, module: nn.Module) -> StateDict:
    """SDXL's ``conditioner.*`` text towers -> the port's SDXLConditioner."""
    return _to_module(cond_sd, module, sdxl_conditioner_name, "sdxl-conditioner",
                      CONDITIONER_PREFIX)
