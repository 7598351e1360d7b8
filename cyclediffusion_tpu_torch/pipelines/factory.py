"""Pipeline factory: a config's ``[gan]`` section -> a pipeline (counterpart
of ``cyclediffusion_tpu.pipelines.factory``).

``source_*`` keys feed the source wrapper and ``target_*`` keys are renamed
to ``source_*`` when ``target=True``; ``gan_type`` picks what is built.  This
port builds the text gan_types, ``SDStochasticText`` (CLIP-conditioned),
``LatentDiffStochasticText`` (LDM-BERT-conditioned) and the port's own
``SDXLStochasticText`` (SDXL base's two towers), and the unconditional
``LatentDiffStochastic`` (unpaired translation):

* ``source_model_type = tiny*``: the CPU-runnable miniature of that
  conditioning with seeded random weights (``source_init_seed``), the hashed
  tokenizer, and a seeded miniature DirectionalCLIP scorer that is installed
  in ``runtime.context`` for the evaluators, unless one is installed already.
* any other value: the model at its published widths from a CompVis
  checkpoint under ``CYCLEDIFFUSION_CKPT_ROOT`` (default ``.``) — SD v1 from
  ``ckpts/stable_diffusion/<source_model_type>``, tokenised with the CLIP
  BPE merges file that ``CYCLEDIFFUSION_CLIP_BPE`` names; LDM text2img-large
  (``text2img-large``, the only LDM text model) from
  ``ckpts/ldm_models/text2img-large/model.ckpt``, tokenised with the
  WordPiece ``vocab.txt`` that ``CYCLEDIFFUSION_BERT_VOCAB`` names; SDXL
  base (``LatentCoreSpec.sdxl_base``) from
  ``ckpts/stable_diffusion_xl/<source_model_type>`` (a torch-saved state
  dict under generative-models' names), both towers reading the ids of the
  CLIP BPE tokenizer.  A missing file raises.  The scorer is the shared one from
  ``runtime.context`` (``CYCLEDIFFUSION_CLIP_CKPT``, or one a caller
  installed); without it the pipeline is built and its ranking raises.

``LatentDiffStochastic`` builds ``tiny`` (a KL first stage at 32 px) and
``tiny_vq`` (VQ at 16 px) with seeded random weights, and ``ffhq256`` /
``celeba256`` from ``ckpts/ldm_models/ldm/<type>/model.ckpt`` with the UNet's
EMA weights (a missing file raises; there are no random weights).

``DDPM_DDIM`` (the pixel DDPMs of unpaired translation, AFHQ cat/wild ->
dog) builds ``tiny_improved_<res>`` / ``tiny_compvis_<res>`` with seeded
random weights, and a model of the zoo (``pipelines.zoo.PIXEL_ZOO``) from
``source_model_path``, or else the spec's ``default_ckpt``, under the
checkpoint root (a missing file raises).  ``enforce_class_input`` is
dropped, as in JAX.

``fast_key_every`` (> 1) turns on the encoder-caching fast mode.
``jax_params`` (tests only) replaces either model's weights with the JAX
pipeline's.  ``CYCLEDIFFUSION_FOLDED_ATTN`` (``qo`` or ``1``; anything else
is off) is read here, once per build, as the JAX program reads it, and
passed down as the core's ``folded_attn``: the modules never read the
environment.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
from cyclediffusion_tpu_torch.models.clip import CLIPConfig
from cyclediffusion_tpu_torch.pipelines.ddpm_ddim import DDPMDDIMPipeline
from cyclediffusion_tpu_torch.pipelines.latent import (
    LatentCoreSpec,
    LatentDiffStochasticPipeline,
    LatentDiffusionCore,
)
from cyclediffusion_tpu_torch.pipelines.latent_text import (
    StochasticTextPipeline,
    latentdiff_stochastic_text_pipeline,
    sd_stochastic_text_pipeline,
    sdxl_stochastic_text_pipeline,
)
from cyclediffusion_tpu_torch.pipelines.zoo import PIXEL_ZOO, tiny_pixel_spec
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.text import BertWordPieceTokenizer, CLIPBPETokenizer, HashTokenizer

FOLDED_ATTN_ENV = "CYCLEDIFFUSION_FOLDED_ATTN"

# gan_type -> (conditioning, pipeline constructor of the published model)
_TEXT_GAN_TYPES = {
    "SDStochasticText": ("clip", sd_stochastic_text_pipeline),
    "LatentDiffStochasticText": ("bert", latentdiff_stochastic_text_pipeline),
    "SDXLStochasticText": ("sdxl", sdxl_stochastic_text_pipeline),
}
# the published text models by conditioning: (spec, checkpoint directory)
_TEXT_MODELS = {"clip": (LatentCoreSpec.sd_v1, ("ckpts", "stable_diffusion")),
                "sdxl": (LatentCoreSpec.sdxl_base, ("ckpts", "stable_diffusion_xl"))}
LDM_TEXT_MODEL = "text2img-large"
# LatentDiffStochastic's published models, loaded with their EMA weights
LATENT_MODELS = {"ffhq256": LatentCoreSpec.ldm_ffhq256,
                 "celeba256": LatentCoreSpec.ldm_celeba256}

# the tiny pipeline's scorer: the JAX factory's miniature ViT
TINY_CLIP = CLIPConfig(embed_dim=16, image_resolution=32, vision_width=32,
                       vision_layers=2, vision_heads=2, patch_size=8, vocab_size=96,
                       context_length=16, text_width=32, text_layers=2, text_heads=2)


def folded_attn_from_env() -> Optional[str]:
    value = os.environ.get(FOLDED_ATTN_ENV)
    return value if value in ("qo", "1") else None


def _collect_kwargs(gan_args, target: bool) -> dict:
    kwargs = {}
    for kw, arg in gan_args:
        if kw == "gan_type":
            continue
        if not kw.startswith("source_") and not kw.startswith("target_"):
            kwargs[kw] = arg
        elif target and kw.startswith("target_"):
            kwargs["source_" + kw[len("target_"):]] = arg
        elif not target and kw.startswith("source_"):
            kwargs[kw] = arg
    return kwargs


def ckpt_root() -> str:
    return os.environ.get("CYCLEDIFFUSION_CKPT_ROOT", ".")


def _resolve_ckpt(path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(ckpt_root(), path)


def _tokenizer(cond_kind: str):
    """The published model's tokenizer, from the file its variable names."""
    if cond_kind in ("clip", "sdxl"):
        bpe = os.environ.get("CYCLEDIFFUSION_CLIP_BPE")
        if not bpe:
            raise FileNotFoundError("SD text pipelines need the CLIP BPE merges file: set "
                                    "CYCLEDIFFUSION_CLIP_BPE to bpe_simple_vocab_16e6.txt.gz")
        return CLIPBPETokenizer(bpe)
    vocab = os.environ.get("CYCLEDIFFUSION_BERT_VOCAB")
    if not vocab:
        raise FileNotFoundError("LDM text pipelines need the WordPiece vocab: set "
                                "CYCLEDIFFUSION_BERT_VOCAB to bert-base-uncased's vocab.txt")
    return BertWordPieceTokenizer(vocab)


def _published(cond_kind: str, model_type: str):
    """-> (spec, checkpoint path under the checkpoint root)."""
    if cond_kind in _TEXT_MODELS:
        spec, directory = _TEXT_MODELS[cond_kind]
        return spec(), os.path.join(*directory, model_type)
    if model_type != LDM_TEXT_MODEL:
        raise ValueError(f"unknown LDM text model {model_type!r}: the port has "
                         f"{LDM_TEXT_MODEL!r}")
    return (LatentCoreSpec.ldm_text2img_large(),
            os.path.join("ckpts", "ldm_models", model_type, "model.ckpt"))


def _checkpoint(gan_type: str, path: str) -> str:
    """``path`` under the checkpoint root; raises if there is no such file."""
    path = _resolve_ckpt(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{gan_type} checkpoint not found: {path} (set "
                                "CYCLEDIFFUSION_CKPT_ROOT to the directory holding ckpts/)")
    return path


def _default_dtype(dtype, tiny: bool, device):
    """bf16 for a published latent model on CUDA, fp32 otherwise, unless
    given.  The pixel family (``DDPM_DDIM``) does not use it: it runs fp32
    unless given, as the JAX pipeline does (its eta-DDIM eps recovery
    amplifies the UNet's error)."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if not tiny and torch.device(device).type == "cuda" \
        else torch.float32


def _tiny_scorer(seed: int, params, device) -> DirectionalCLIP:
    if params is not None:
        scorer = CLIPScorer.from_jax_params(params, TINY_CLIP, device)
    else:
        scorer = CLIPScorer.random_init(seed, TINY_CLIP, device)
    return DirectionalCLIP(scorer, HashTokenizer(96, 16))


def _build_text(gan_type: str, kwargs: dict, device, dtype,
                jax_params) -> StochasticTextPipeline:
    cond_kind, make_pipeline = _TEXT_GAN_TYPES[gan_type]
    model_type = kwargs.pop("source_model_type")
    seed = int(kwargs.pop("source_init_seed", 0))     # tiny models only
    pipe_kw = dict(
        custom_steps=kwargs.pop("custom_steps"),
        eta=kwargs.pop("eta"),
        white_box_steps=kwargs.pop("white_box_steps"),
        skip_steps=kwargs.pop("skip_steps"),
        encoder_unconditional_guidance_scales=kwargs.pop(
            "encoder_unconditional_guidance_scales"),
        decoder_unconditional_guidance_scales=kwargs.pop(
            "decoder_unconditional_guidance_scales"),
        n_trials=kwargs.pop("n_trials"),
        candidate_chunk=kwargs.pop("candidate_chunk", None),
        fast_key_every=kwargs.pop("fast_key_every", None),
    )
    if kwargs:
        raise ValueError(f"unused gan kwargs: {kwargs}")
    tiny = model_type.startswith("tiny")
    dtype = _default_dtype(dtype, tiny, device)
    folded = folded_attn_from_env()
    jax_params = jax_params or {}
    if tiny:
        spec = LatentCoreSpec.tiny(cond_kind)
        if "core" in jax_params:
            core = LatentDiffusionCore.from_jax_params(spec, jax_params["core"], device,
                                                       dtype, folded)
        else:
            core = LatentDiffusionCore.random_init(spec, seed, device, dtype, folded)
        dclip = context.get_directional_clip(required=False, device=device)
        if dclip is None:
            dclip = _tiny_scorer(seed + 1, jax_params.get("clip"), device)
            context.set_directional_clip(dclip)
        return StochasticTextPipeline(core, HashTokenizer(96, 16), dclip, **pipe_kw)

    spec, path = _published(cond_kind, model_type)
    path = _checkpoint(gan_type, path)
    tokenizer = _tokenizer(cond_kind)
    core = LatentDiffusionCore.from_torch_ckpt(spec, path, device, dtype, folded)
    dclip = context.get_directional_clip(required=False, device=device)
    return make_pipeline(core, tokenizer, dclip, **pipe_kw)


def _build_latent(kwargs: dict, device, dtype, jax_params) -> LatentDiffStochasticPipeline:
    model_type = kwargs.pop("source_model_type")
    seed = int(kwargs.pop("source_init_seed", 0))     # tiny models only
    pipe_kw = dict(
        custom_steps=kwargs.pop("custom_steps"),
        eta=kwargs.pop("eta"),
        white_box_steps=kwargs.pop("white_box_steps"),
        refine_steps=kwargs.pop("refine_steps", 0),
        enforce_class_input=kwargs.pop("enforce_class_input", None),
        unconditional_guidance_scale=kwargs.pop("unconditional_guidance_scale", None),
        fast_key_every=kwargs.pop("fast_key_every", None),
    )
    if kwargs:
        raise ValueError(f"unused gan kwargs: {kwargs}")
    tiny = model_type.startswith("tiny")
    dtype = _default_dtype(dtype, tiny, device)
    if tiny:
        vq = model_type == "tiny_vq"
        spec = LatentCoreSpec.tiny(cond_kind=None, fs_kind="vq" if vq else "kl",
                                   resolution=16 if vq else 32)
        if jax_params and "core" in jax_params:
            core = LatentDiffusionCore.from_jax_params(spec, jax_params["core"], device,
                                                       dtype)
        else:
            core = LatentDiffusionCore.random_init(spec, seed, device, dtype)
    else:
        if model_type not in LATENT_MODELS:
            raise ValueError(f"unknown latent model type {model_type!r}: the port has "
                             f"{sorted(LATENT_MODELS)}")
        path = _checkpoint("LatentDiffStochastic",
                           os.path.join("ckpts", "ldm_models", "ldm", model_type, "model.ckpt"))
        core = LatentDiffusionCore.from_torch_ckpt(LATENT_MODELS[model_type](), path, device,
                                                   dtype, use_ema=True)
    return LatentDiffStochasticPipeline(core, **pipe_kw)


def _build_ddpm_ddim(kwargs: dict, device, dtype, jax_params) -> DDPMDDIMPipeline:
    model_type = kwargs.pop("source_model_type")
    model_path = kwargs.pop("source_model_path", None)
    seed = int(kwargs.pop("source_init_seed", 0))     # tiny models only
    pipe_kw = dict(
        sample_type=kwargs.pop("sample_type"),
        custom_steps=kwargs.pop("custom_steps"),
        es_steps=kwargs.pop("es_steps"),
        eta=kwargs.pop("eta", None),
        refine_steps=kwargs.pop("refine_steps", 0),
        refine_iterations=kwargs.pop("refine_iterations", 1),
        t_0=kwargs.pop("t_0", None),
        device=device,
        dtype=torch.float32 if dtype is None else dtype,
    )
    kwargs.pop("enforce_class_input", None)
    if kwargs:
        raise ValueError(f"unused gan kwargs: {kwargs}")
    if model_type.startswith("tiny"):
        _, kind, res = model_type.split("_")    # tiny_improved_16 / tiny_compvis_16
        spec = tiny_pixel_spec(resolution=int(res), kind=kind)
        if jax_params and "unet" in jax_params:
            return DDPMDDIMPipeline.from_jax_params(spec, jax_params["unet"], **pipe_kw)
        return DDPMDDIMPipeline.random_init(spec, seed, **pipe_kw)
    if model_type not in PIXEL_ZOO:
        raise ValueError(f"unknown pixel model type {model_type!r}: the zoo has "
                         f"{sorted(PIXEL_ZOO)}")
    spec = PIXEL_ZOO[model_type]
    path = model_path or spec.default_ckpt
    if not path:
        raise ValueError(f"{model_type} needs source_model_path (no default checkpoint)")
    return DDPMDDIMPipeline.from_torch_ckpt(spec, _checkpoint("DDPM_DDIM", path), **pipe_kw)


def get_gan_wrapper(gan_args, target: bool = False, *, device="cuda", dtype=None,
                    jax_params: Optional[dict] = None):
    """Build the pipeline a ``[gan]`` section describes.

    ``jax_params`` (tests, tiny models only): ``{"core": {"unet",
    "first_stage"[, "cond"]}, "clip": <CLIPModel tree>}``, or for
    ``DDPM_DDIM`` ``{"unet": <tree>}``, with numpy leaves, the JAX
    pipeline's weights.  ``dtype`` defaults to bf16 for a published latent
    model on CUDA, fp32 otherwise (and always for ``DDPM_DDIM``).
    """
    gan_type = dict(list(gan_args))["gan_type"]
    kwargs = _collect_kwargs(gan_args, target)
    if gan_type in _TEXT_GAN_TYPES:
        return _build_text(gan_type, kwargs, device, dtype, jax_params)
    if gan_type == "LatentDiffStochastic":
        return _build_latent(kwargs, device, dtype, jax_params)
    if gan_type == "DDPM_DDIM":
        return _build_ddpm_ddim(kwargs, device, dtype, jax_params)
    raise ValueError(f"unknown gan_type {gan_type}")
