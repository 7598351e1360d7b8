"""LatentDiffusion core: UNet + first stage (KL or VQ) + optional text
conditioning, CLIP (SD v1), LDM-BERT (LDM text2img-large) or SDXL's two
towers and vector, and the unconditional stochastic latent pipeline of
unpaired translation (FFHQ -> CelebA-HQ) (counterpart of ``LatentCoreSpec``,
``LatentDiffusionCore`` and ``LatentDiffStochasticPipeline`` in
``cyclediffusion_tpu.pipelines.latent``; SDXL is the port's own).

SDXL's conditioning is a dict ``{"context": (B, T, 2048), "vector": (B,
2816)}``: the UNet takes the context as its cross-attention input and the
vector as ``y``.  Its unconditional branch is zeros in the context and the
pooled part of the vector, the size embeddings kept, as generative-models
(``force_uc_zero_embeddings``) and diffusers (``force_zeros_for_empty_prompt``)
make it: no prompt is encoded for it.

The modules run in the core's dtype (bf16 on the card); the sampler around
them stays fp32: :meth:`LatentDiffusionCore.apply_model` casts the latent
to the core's dtype and its eps back to fp32, the KL posterior is sampled in
fp32, and the VQ codebook lookup runs in fp32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.convert.to_jax import module_to_flax
from cyclediffusion_tpu_torch.models.autoencoder import (
    AutoencoderKL,
    DDConfig,
    DiagonalGaussian,
    VQModel,
)
from cyclediffusion_tpu_torch.models.nn import fill_random_, resolve_device
from cyclediffusion_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextEncoder,
    LDMBertConfig,
    LDMBertEncoder,
    OpenCLIPTextConfig,
    SDXLConditioner,
    SDXLConditionerConfig,
)
from cyclediffusion_tpu_torch.models.unet_gd import GDUNet, GDUNetConfig
from cyclediffusion_tpu_torch.ops import schedule
from cyclediffusion_tpu_torch.ops.fold import SplitInputParams, split_first_stage_apply
from cyclediffusion_tpu_torch.parallel import tp
from cyclediffusion_tpu_torch.runtime import graphs, profiling, yaml_subset
from cyclediffusion_tpu_torch.samplers import (
    ddim_decode,
    ddim_decode_cached,
    ddim_refine,
    dpm_encode,
    dpm_encode_cached,
)


@dataclasses.dataclass(frozen=True)
class LatentCoreSpec:
    """One latent diffusion model: UNet + first stage (``fs_kind`` ``"kl"``
    or ``"vq"``) + optional conditioning (``cond_kind`` ``"clip"``,
    ``"bert"``, ``"sdxl"`` or None)."""

    name: str
    unet: GDUNetConfig
    first_stage: DDConfig
    fs_kind: str                   # "kl" | "vq"
    embed_dim: int
    scale_factor: float
    linear_start: float
    linear_end: float
    num_timesteps: int = 1000
    n_embed: int = 8192            # vq codebook size
    cond_kind: Optional[str] = None
    cond_cfg: Optional[object] = None   # CLIPTextConfig, LDMBertConfig, SDXLConditionerConfig
    resolution: int = 256          # pixel-space resolution

    @property
    def image_size(self) -> int:
        """Latent spatial size."""
        return self.resolution // 2 ** (len(self.first_stage.ch_mult) - 1)

    @property
    def channels(self) -> int:
        return self.unet.in_channels

    @staticmethod
    def sd_v1() -> "LatentCoreSpec":
        return LatentCoreSpec(
            name="sd_v1", unet=GDUNetConfig.sd_v1(), first_stage=DDConfig.sd_f8(),
            fs_kind="kl", embed_dim=4, scale_factor=0.18215,
            linear_start=0.00085, linear_end=0.0120,
            cond_kind="clip", cond_cfg=CLIPTextConfig.vit_l_14(), resolution=512,
        )

    @staticmethod
    def ldm_text2img_large() -> "LatentCoreSpec":
        """LDM text2img-large (txt2img-1p4B-eval.yaml) at 256 px."""
        return LatentCoreSpec(
            name="ldm_text2img_large", unet=GDUNetConfig.ldm_text2img_large(),
            first_stage=DDConfig.sd_f8(), fs_kind="kl", embed_dim=4,
            scale_factor=0.18215, linear_start=0.00085, linear_end=0.012,
            cond_kind="bert", cond_cfg=LDMBertConfig.text2img_large(),
            resolution=256,
        )

    @staticmethod
    def sdxl_base() -> "LatentCoreSpec":
        """SDXL base 1.0 at 1024 px (generative-models
        ``configs/inference/sd_xl_base.yaml``): eps on SD's discrete
        schedule, KL-f8 at scale 0.13025, two text towers and a vector."""
        return LatentCoreSpec(
            name="sdxl_base", unet=GDUNetConfig.sdxl_base(), first_stage=DDConfig.sd_f8(),
            fs_kind="kl", embed_dim=4, scale_factor=0.13025,
            linear_start=0.00085, linear_end=0.012,
            cond_kind="sdxl", cond_cfg=SDXLConditionerConfig.sdxl_base(), resolution=1024,
        )

    @staticmethod
    def ldm_ffhq256() -> "LatentCoreSpec":
        """The unconditional FFHQ LDM (ffhq-ldm-vq-4.yaml): VQ-f4 first
        stage, 64x64x3 latent, no conditioning."""
        return LatentCoreSpec(
            name="ldm_ffhq256", unet=GDUNetConfig.ldm_ffhq256(),
            first_stage=DDConfig.vq_f4(), fs_kind="vq", embed_dim=3,
            scale_factor=1.0, linear_start=0.0015, linear_end=0.0195,
            resolution=256,
        )

    @staticmethod
    def ldm_celeba256() -> "LatentCoreSpec":
        """The CelebA-HQ LDM: the FFHQ model's architecture."""
        return dataclasses.replace(LatentCoreSpec.ldm_ffhq256(), name="ldm_celeba256")

    @staticmethod
    def from_yaml(path: str, name: Optional[str] = None) -> "LatentCoreSpec":
        """A spec from a reference LatentDiffusion yaml (the OmegaConf files
        under ``configs/`` and ``models/ldm/*/config.yaml``), read by
        :mod:`runtime.yaml_subset`: the UNet, the KL or VQ first stage (by
        its ``target``), CLIP or LDM-BERT conditioning (by the cond
        stage's ``target``).  ``resolution`` is the first stage's, as the
        file has it (SD's wrapper runs at 512, which its file does not
        say)."""
        cfg = yaml_subset.load_file(path)["model"]["params"]
        u = cfg["unet_config"]["params"]
        unet = GDUNetConfig(
            in_channels=u["in_channels"],
            model_channels=u["model_channels"],
            out_channels=u["out_channels"],
            num_res_blocks=u["num_res_blocks"],
            attention_resolutions=tuple(u["attention_resolutions"]),
            channel_mult=tuple(u["channel_mult"]),
            num_heads=u.get("num_heads", -1),
            num_head_channels=u.get("num_head_channels", -1),
            use_spatial_transformer=u.get("use_spatial_transformer", False),
            transformer_depth=u.get("transformer_depth", 1),
            context_dim=u.get("context_dim"),
            legacy=u.get("legacy", True),
        )
        fs = cfg["first_stage_config"]
        dd = fs["params"]["ddconfig"]
        first_stage = DDConfig(
            ch=dd["ch"], out_ch=dd["out_ch"], ch_mult=tuple(dd["ch_mult"]),
            num_res_blocks=dd["num_res_blocks"],
            attn_resolutions=tuple(dd.get("attn_resolutions", ())),
            in_channels=dd["in_channels"], resolution=dd["resolution"],
            z_channels=dd["z_channels"], double_z=dd.get("double_z", False),
        )
        fs_kind = "kl" if "AutoencoderKL" in fs["target"] else "vq"
        cond_kind = None
        cond_cfg = None
        cs = cfg.get("cond_stage_config")
        if isinstance(cs, dict):
            target = cs.get("target", "")
            if "CLIP" in target:
                cond_kind, cond_cfg = "clip", CLIPTextConfig.vit_l_14()
            elif "BERT" in target:
                p = cs.get("params", {})
                cond_kind = "bert"
                cond_cfg = LDMBertConfig(dim=p.get("n_embed", 1280),
                                         depth=p.get("n_layer", 32))
        return LatentCoreSpec(
            name=name or "from_yaml", unet=unet, first_stage=first_stage,
            fs_kind=fs_kind, embed_dim=fs["params"]["embed_dim"],
            scale_factor=cfg.get("scale_factor", 1.0),
            linear_start=cfg["linear_start"], linear_end=cfg["linear_end"],
            num_timesteps=cfg.get("timesteps", 1000),
            n_embed=fs["params"].get("n_embed", 8192),
            cond_kind=cond_kind, cond_cfg=cond_cfg,
            resolution=dd["resolution"],
        )

    @staticmethod
    def tiny(cond_kind: Optional[str] = "clip", resolution: int = 32,
             fs_kind: str = "kl") -> "LatentCoreSpec":
        """CPU-runnable miniature — the JAX package's ``LatentCoreSpec.tiny``:
        text-conditioned (``cond_kind``) or, with None, the unconditional
        UNet's attention blocks; ``fs_kind="vq"`` miniaturises the
        FFHQ/CelebA first stage (single z, codebook of 64, scale 1).
        ``"sdxl"`` (the port's own) is SDXL base's shape: two towers, a
        vector, depth by level, linear projections, exact GELU."""
        unet = GDUNetConfig.tiny(context_dim=None if cond_kind is None else 24)
        if cond_kind == "sdxl":
            cond_cfg = SDXLConditionerConfig(
                clip=CLIPTextConfig(vocab_size=96, hidden_size=16, num_layers=3, num_heads=2,
                                    max_positions=16, intermediate_size=32),
                clip_layer=2,
                open_clip=OpenCLIPTextConfig(vocab_size=96, width=24, layers=3, heads=4,
                                             mlp=48, context_length=16, embed_dim=16),
                size_embed_dim=8,
                micro_conditioning=(resolution, resolution, 0, 0, resolution, resolution))
            unet = GDUNetConfig.tiny_sdxl(cond_cfg.context_dim, cond_cfg.vector_dim)
        elif cond_kind == "clip":
            cond_cfg = CLIPTextConfig(vocab_size=96, hidden_size=24, num_layers=2,
                                      num_heads=4, max_positions=16, intermediate_size=48)
        elif cond_kind == "bert":
            cond_cfg = LDMBertConfig(vocab_size=96, dim=24, depth=2, heads=2,
                                     dim_head=12, max_seq_len=16)
        elif cond_kind is None:
            cond_cfg = None
        else:
            raise ValueError(f"cond_kind={cond_kind!r} is not 'clip', 'bert', 'sdxl' or None")
        if fs_kind not in ("kl", "vq"):
            raise ValueError(f"fs_kind={fs_kind!r} is not 'kl' or 'vq'")
        return LatentCoreSpec(
            name=f"tiny_latent_{cond_kind}_{fs_kind}",
            unet=unet,
            first_stage=DDConfig(ch=16, ch_mult=(1, 2, 4), num_res_blocks=1,
                                 resolution=resolution, z_channels=4,
                                 double_z=fs_kind == "kl", attn_resolutions=()),
            fs_kind=fs_kind, embed_dim=4, n_embed=64,
            scale_factor=0.18215 if fs_kind == "kl" else 1.0,
            linear_start=0.00085, linear_end=0.012, num_timesteps=100,
            cond_kind=cond_kind, cond_cfg=cond_cfg, resolution=resolution,
        )

    @property
    def context_length(self) -> Optional[int]:
        """Tokens of the conditioning text (None without conditioning)."""
        cfg = self.cond_cfg
        if self.cond_kind is None:
            return None
        if self.cond_kind == "sdxl":
            return cfg.clip.max_positions
        return cfg.max_positions if self.cond_kind == "clip" else cfg.max_seq_len


def _ctx(context, dtype) -> tuple:
    """(context, UNet keywords) in ``dtype``: SDXL's dict gives its vector
    as ``y``."""
    if isinstance(context, dict):
        return context["context"].to(dtype), {"y": context["vector"].to(dtype)}
    return (None if context is None else context.to(dtype)), {}


def _unet_eps(unet, dtype, x, t, context):
    ctx, kw = _ctx(context, dtype)
    return unet(x.to(dtype), t, ctx, **kw).float()


def _unet_cached(unet, dtype, x, t, context, encoder_cache):
    ctx, kw = _ctx(context, dtype)
    eps, cache = unet(x.to(dtype), t, ctx, encoder_cache=encoder_cache,
                      return_cache=True, **kw)
    return eps.float(), cache


def _unet_reuse(unet, dtype, x, t, context, encoder_cache):
    return _unet_cached(unet, dtype, x, t, context, encoder_cache)[0]


def _first_stage_apply(fn, x, sip: Optional[SplitInputParams], spec: LatentCoreSpec,
                       upsample: bool):
    """``fn(x)``, or tiled over ``sip`` where that is set, at ``sip.vqf``
    where given, else the model's factor 2^(levels - 1)."""
    if sip is None or not sip.patch_distributed_vq:
        return fn(x)
    factor = 2 ** (len(spec.first_stage.ch_mult) - 1) if sip.vqf is None else sip.vqf
    return split_first_stage_apply(fn, x, sip, scale=factor, upsample=upsample)


def _encode_first_stage(first_stage, spec: LatentCoreSpec, dtype, image_m11, noise, sip):
    image = image_m11.to(dtype)
    if spec.fs_kind == "vq":
        z = _first_stage_apply(first_stage.encode, image, sip, spec, False)
        return z.float() * spec.scale_factor
    moments = _first_stage_apply(first_stage.encode_moments, image, sip, spec, False).float()
    return DiagonalGaussian(moments).sample(noise) * spec.scale_factor


def _decode_first_stage(first_stage, spec: LatentCoreSpec, dtype, z, sip):
    z = z / spec.scale_factor
    z = z if spec.fs_kind == "vq" else z.to(dtype)
    return _first_stage_apply(first_stage.decode, z, sip, spec, True).float()


class LatentDiffusionCore:
    """The model's modules (UNet, first stage and, for a text model, the
    conditioning model) on one device, in one dtype, frozen.

    ``folded_attn`` (``None``, ``"qo"``, ``"1"``) selects the UNet's long
    self-attention path (see ``models.transformer.CrossAttention``)."""

    def __init__(self, spec: LatentCoreSpec, device="cuda", dtype=torch.float32,
                 folded_attn: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = dtype
        self.folded_attn = folded_attn
        # tiled first-stage inference (ops/fold.py), read at each call
        self.split_input_params: Optional[SplitInputParams] = None
        with self.device:
            self.unet = GDUNet(spec.unet, folded_attn)
            self.first_stage = (
                AutoencoderKL(spec.first_stage, spec.embed_dim) if spec.fs_kind == "kl"
                else VQModel(spec.first_stage, spec.n_embed, spec.embed_dim))
            self.cond_model = None
            if spec.cond_kind is not None:
                self.cond_model = {"clip": CLIPTextEncoder, "bert": LDMBertEncoder,
                                   "sdxl": SDXLConditioner}[spec.cond_kind](spec.cond_cfg)
        for m in self.modules():
            m.to(dtype=dtype).eval().requires_grad_(False)
        # the UNet's, the first stage's and the text encoder's calls as CUDA
        # graphs (functions of the modules, not of the core, so that no cycle
        # keeps a deleted core's memory alive), in one pool: they replay one
        # after another on one stream and each result is copied out at once,
        # so the pool is the largest capture's, not the sum of them
        pool = graphs.GraphPool()
        self._graphed_apply = graphs.GraphedCall(
            functools.partial(_unet_eps, self.unet, dtype), pool, name="unet")
        self._graphed_key = graphs.GraphedCall(
            functools.partial(_unet_cached, self.unet, dtype), pool, name="unet.key")
        self._graphed_reuse = graphs.GraphedCall(
            functools.partial(_unet_reuse, self.unet, dtype), pool, name="unet.reuse")
        self._graphed_encode = graphs.GraphedCall(
            functools.partial(_encode_first_stage, self.first_stage, spec, dtype), pool,
            name="first_stage.encode")
        self._graphed_decode = graphs.GraphedCall(
            functools.partial(_decode_first_stage, self.first_stage, spec, dtype), pool,
            name="first_stage.decode")
        self._graphed_cond = (None if self.cond_model is None
                              else graphs.GraphedCall(self.cond_model, pool, name="text",
                                                      time_device=True))

    def modules(self):
        return tuple(m for _, m in self._named_modules())

    # ---- constructors -------------------------------------------------- #

    @classmethod
    def random_init(cls, spec: LatentCoreSpec, seed: int = 0, device="cuda",
                    dtype=torch.float32, folded_attn: Optional[str] = None
                    ) -> "LatentDiffusionCore":
        """Seeded random weights (see :func:`models.nn.fill_random_`), drawn on the
        core's device."""
        core = cls(spec, device, dtype, folded_attn)
        gen = torch.Generator(device=core.device).manual_seed(seed)
        for m in core.modules():
            fill_random_(m, gen)
        return core

    @classmethod
    def from_jax_params(cls, spec: LatentCoreSpec, params: dict, device="cuda",
                        dtype=torch.float32, folded_attn: Optional[str] = None
                        ) -> "LatentDiffusionCore":
        """Weights from the JAX core's parameter tree (numpy leaves):
        ``{"unet": ..., "first_stage": ...[, "cond": ...]}``."""
        core = cls(spec, device, dtype, folded_attn)
        core.load_jax_params(params)
        return core

    def load_jax_params(self, params: dict) -> None:
        """The JAX core's parameter tree into this core's modules in place."""
        load_flax_params(self.unet, params["unet"])
        load_flax_params(self.first_stage, params["first_stage"])
        if self.cond_model is not None:
            load_flax_params(self.cond_model, params["cond"])

    def jax_params(self) -> dict:
        """This core's weights as the JAX core's parameter tree (on the host,
        in the core's dtype): :meth:`load_jax_params`' inverse."""
        params = {"unet": module_to_flax(self.unet),
                  "first_stage": module_to_flax(self.first_stage)}
        if self.cond_model is not None:
            params["cond"] = module_to_flax(self.cond_model)
        return params

    @classmethod
    @torch.no_grad()
    def from_torch_ckpt(cls, spec: LatentCoreSpec, path: str, device="cuda",
                        dtype=torch.float32, folded_attn: Optional[str] = None,
                        use_ema: bool = False) -> "LatentDiffusionCore":
        """Weights from a CompVis ``LatentDiffusion`` checkpoint (SD v1's
        ``sd-v1-4.ckpt``, LDM text2img-large's or the FFHQ/CelebA LDMs'
        ``model.ckpt`` layout) or generative-models' ``DiffusionEngine``
        (SDXL's), see ``convert.from_torch``; ``use_ema`` takes the UNet's
        LitEma shadows.  Raises on a missing file, an unmapped or missing
        key, or a shape mismatch."""
        core = cls(spec, device, dtype, folded_attn)
        core.load_torch_state_dict(from_torch.load_torch_state_dict(path), use_ema)
        return core

    @torch.no_grad()
    def load_torch_state_dict(self, sd: dict, use_ema: bool = False) -> None:
        """A checkpoint's state dict (published names) into this core's
        modules in place (see :meth:`from_torch_ckpt`)."""
        cond_prefix = (from_torch.CONDITIONER_PREFIX if self.spec.cond_kind == "sdxl"
                       else from_torch.COND_PREFIX)
        unet_sd, fs_sd, cond_sd = from_torch.split_latent_diffusion_state(sd, use_ema,
                                                                          cond_prefix)
        parts = [(self.unet, from_torch.convert_gd_unet, unet_sd),
                 (self.first_stage, from_torch.convert_vae, fs_sd)]
        if self.cond_model is not None:
            parts.append((self.cond_model, {"clip": from_torch.convert_clip_text,
                                            "bert": from_torch.convert_ldm_bert,
                                            "sdxl": from_torch.convert_sdxl_conditioner
                                            }[self.spec.cond_kind], cond_sd))
        elif cond_sd:
            raise KeyError(f"unmapped cond-stage key of an unconditional model: "
                           f"{from_torch.COND_PREFIX}{next(iter(cond_sd))}")
        for module, convert, part in parts:
            module.load_state_dict(convert(part, module), strict=True)

    # ---- the driver's checkpoints ---------------------------------------- #

    def state_dict(self) -> dict:
        """The three modules' weights, keyed ``unet.*``, ``first_stage.*``
        and ``cond_model.*``."""
        return {f"{prefix}.{k}": v for prefix, m in self._named_modules()
                for k, v in m.state_dict().items()}

    def load_state_dict(self, state: dict) -> None:
        for prefix, m in self._named_modules():
            m.load_state_dict({k[len(prefix) + 1:]: v for k, v in state.items()
                               if k.startswith(prefix + ".")}, strict=True)

    def _named_modules(self):
        named = (("unet", self.unet), ("first_stage", self.first_stage),
                 ("cond_model", self.cond_model))
        return tuple((name, m) for name, m in named if m is not None)

    # ---- model surface -------------------------------------------------- #

    def apply_model(self, x, t, context=None):
        """fp32 NHWC latent -> fp32 eps, the UNet running in the core dtype.
        On a CUDA device the call replays a CUDA graph of
        :meth:`apply_model_eager` captured at the first call of each
        signature (``runtime.graphs``); on the CPU it is that call.  A UNet
        sharded by ``parallel.tp`` runs eagerly: its sharded layers
        all-gather through the host, which a graph cannot hold."""
        if tp.is_sharded(self.unet):
            return self.apply_model_eager(x, t, context)
        return self._graphed_apply(x, t, context)

    @torch.no_grad()
    def apply_model_eager(self, x, t, context=None):
        """:meth:`apply_model` as eager launches, never a graph."""
        return _unet_eps(self.unet, self.dtype, x, t, context)

    def apply_model_cached(self, x, t, context=None, encoder_cache=None):
        """The fast mode's UNet call: ``(fp32 eps, cache)``; given a cache,
        the decoder half alone runs on it (see ``GDUNet.forward``) and the
        cache given is returned.  Graphed as :meth:`apply_model` is: the key
        call (no cache) and the reuse call are two graphs, the cache an input
        of the second."""
        if tp.is_sharded(self.unet):
            return self.apply_model_cached_eager(x, t, context, encoder_cache)
        if encoder_cache is None:
            return self._graphed_key(x, t, context, None)
        return self._graphed_reuse(x, t, context, encoder_cache), encoder_cache

    @torch.no_grad()
    def apply_model_cached_eager(self, x, t, context=None, encoder_cache=None):
        """:meth:`apply_model_cached` as eager launches, never a graph."""
        return _unet_cached(self.unet, self.dtype, x, t, context, encoder_cache)

    def get_learned_conditioning(self, token_ids, unconditional: bool = False):
        """(B, T) token ids -> the text context (B, T, width) in the core
        dtype, or SDXL's ``{"context", "vector"}``.  The ids are copied to
        the device first; on a CUDA device the text encoder then replays a
        CUDA graph of its call (JAX's ``_cond_jit``), one per (B, T); SDXL's
        holds both towers and the pooling.  ``unconditional`` says the ids
        are the empty prompt of the unconditional branch: SD v1 and LDM
        encode them, SDXL gives zeros and encodes nothing."""
        if self.spec.cond_kind != "sdxl":
            return self._graphed_cond(self._token_ids(token_ids))
        return self._sdxl_conditioning(token_ids, unconditional, self._graphed_cond)

    @torch.no_grad()
    def get_learned_conditioning_eager(self, token_ids, unconditional: bool = False):
        """:meth:`get_learned_conditioning` as eager launches, never a graph."""
        if self.spec.cond_kind != "sdxl":
            return self.cond_model(self._token_ids(token_ids))
        return self._sdxl_conditioning(token_ids, unconditional, self.cond_model)

    def _sdxl_conditioning(self, token_ids, unconditional: bool, encode) -> dict:
        """SDXL's conditioning: the towers through ``encode`` (or zeros for
        the unconditional rows, counted as ``cond.zero_rows``), then the
        vector, assembled in the ``cond.vector`` span."""
        n, length = len(token_ids), self.spec.context_length
        if unconditional:
            profiling.count("cond.zero_rows", n)
            context, pooled = self.cond_model.zeros(n, length)
        else:
            context, pooled = encode(self._token_ids(token_ids))
        with profiling.span("cond.vector", n):
            return {"context": context, "vector": self.cond_model.vector(pooled)}

    def _token_ids(self, token_ids) -> torch.Tensor:
        if self.cond_model is None:
            raise ValueError(f"{self.spec.name} has no conditioning model")
        # a pageable host copy: the host waits for the device's queue
        with profiling.span("sync.token_ids"):
            return torch.as_tensor(np.asarray(token_ids), dtype=torch.int64,
                                   device=self.device)

    def encode_first_stage(self, image_m11, noise=None):
        """[-1,1] NHWC image -> x0 latent (fp32), times the scale factor: the
        KL posterior sampled with ``noise``, or the VQ encoder's
        pre-quantisation latent (no noise).  Tiled with
        ``split_input_params``: a KL first stage's moments are tiled, then the
        stitched posterior is sampled.  On a CUDA device the call replays a
        CUDA graph (JAX's ``_x0_jit``), one per signature: the image's and
        the noise's shapes (a VQ encode's noise is None) and the tiling."""
        if self.spec.fs_kind == "kl" and noise is None:
            raise ValueError("the KL first stage's posterior sample needs noise")
        noise = noise if self.spec.fs_kind == "kl" else None
        return self._graphed_encode(image_m11, noise, self.split_input_params)

    @torch.no_grad()
    def encode_first_stage_eager(self, image_m11, noise=None):
        """:meth:`encode_first_stage` as eager launches, never a graph."""
        if self.spec.fs_kind == "kl" and noise is None:
            raise ValueError("the KL first stage's posterior sample needs noise")
        return _encode_first_stage(self.first_stage, self.spec, self.dtype, image_m11,
                                   noise, self.split_input_params)

    def decode_first_stage(self, z):
        """Latent -> [-1,1] NHWC image (fp32), tiled with
        ``split_input_params``.  The VQ decoder quantises the fp32 latent,
        then runs in the core dtype.  On a CUDA device the call replays a
        CUDA graph (JAX's ``_decode_jit``), one per signature: the latent's
        shape and the tiling.  Differentiable in ``z``: a ``z`` that requires
        a gradient, in grad mode, takes :meth:`decode_first_stage_eager`
        (a replay has no backward), as the guided energy does."""
        if torch.is_grad_enabled() and z.requires_grad:
            return self.decode_first_stage_eager(z)
        return self._graphed_decode(z, self.split_input_params)

    def decode_first_stage_eager(self, z):
        """:meth:`decode_first_stage` as eager launches, never a graph, and
        differentiable in ``z`` (the weights are frozen, so a ``z`` that
        needs no gradient builds no autograd graph)."""
        return _decode_first_stage(self.first_stage, self.spec, self.dtype, z,
                                   self.split_input_params)

    def make_ddim_schedule(self, custom_steps: int, eta: float):
        betas = schedule.make_beta_schedule(
            "linear", self.spec.num_timesteps,
            linear_start=self.spec.linear_start, linear_end=self.spec.linear_end)
        return schedule.DDIMSchedule.create(betas, custom_steps, eta)


class LatentDiffStochasticPipeline:
    """Unconditional latent DPM-Encoder pipeline (FFHQ / CelebA-HQ).

    * ``encode(image01, generator)`` -> ``z = (x_T, eps_1..eps_n)`` per image,
      flattened to ``latent_dim = image_size^2 * channels * white_box_steps``
      (x_T first, every entry NHWC-flattened).
    * ``sample(z, generator)`` -> the latent that ``generate`` decodes: the
      eps replay (``ddim_decode``), then, with ``refine_steps > 0``,
      ``ddim_refine`` at the pipeline's own ``eta`` (the JAX pipeline passes
      its one schedule to the refine; see ROADMAP §C).
    * ``generate(z, generator)`` -> [-1, 1] NHWC images; ``__call__`` maps
      them to [0, 1].

    The noise seams replace the generator's draws: ``vae_noise`` (a KL first
    stage's posterior), ``xT_noise`` and ``posterior_noises`` of the encode
    chain, and the refine's ``q_noise`` and ``chain_eps``.  The draws come in
    that order from one generator.  ``fast_key_every > 1`` runs both chains
    with encoder caching; the refine runs exact, as in JAX.
    ``unconditional_guidance_scale`` is accepted and unused, as in JAX."""

    def __init__(self, core: LatentDiffusionCore, *, custom_steps: int, eta: float,
                 white_box_steps: int, refine_steps: int = 0,
                 enforce_class_input: Optional[bool] = None,
                 unconditional_guidance_scale: Optional[float] = None,
                 fast_key_every: Optional[int] = None):
        if enforce_class_input:
            raise NotImplementedError("class-conditional latent sampling is plumbed but not "
                                      "implemented, as in the reference")
        if eta <= 0:
            raise ValueError("the DPM-Encoder needs eta > 0 (it divides by sigma)")
        if white_box_steps > custom_steps + 1:
            raise ValueError(f"white_box_steps={white_box_steps} > custom_steps + 1")
        self.core = core
        self.custom_steps = custom_steps
        self.eta = eta
        self.white_box_steps = white_box_steps
        self.refine_steps = refine_steps
        self.fast_key_every = fast_key_every
        self.sched = core.make_ddim_schedule(custom_steps, eta)
        spec = core.spec
        self.resolution = spec.resolution
        self.latent_dim = spec.image_size ** 2 * spec.channels * white_box_steps

    @property
    def device(self) -> torch.device:
        return self.core.device

    @property
    def _fast(self) -> bool:
        return (self.fast_key_every or 0) > 1

    def _cached_fns(self):
        """(key_fn, reuse_fn) of the unconditional cached UNet call."""
        core = self.core
        return (lambda x, t: core.apply_model_cached(x, t),
                lambda x, t, cache: core.apply_model_cached(x, t, None, cache)[0])

    def encode(self, image01, generator: Optional[torch.Generator] = None,
               class_label=None, *, vae_noise=None, xT_noise=None,
               posterior_noises=None) -> torch.Tensor:
        """[0, 1] NHWC images -> z (B, latent_dim)."""
        if class_label is not None:
            raise NotImplementedError("class-conditional translation is not implemented")
        core, spec = self.core, self.core.spec
        image01 = torch.as_tensor(image01, dtype=torch.float32, device=core.device)
        if not image01.shape[1] == image01.shape[2] == self.resolution:
            raise ValueError(f"image {tuple(image01.shape)} is not "
                             f"{self.resolution}x{self.resolution}")
        image = (image01 - 0.5) * 2.0
        if spec.fs_kind == "kl" and vae_noise is None:
            vae_noise = torch.randn((image.shape[0], spec.image_size, spec.image_size,
                                     spec.embed_dim), generator=generator,
                                    device=core.device)
        x0 = core.encode_first_stage(image, vae_noise)
        kw = dict(white_box_steps=self.white_box_steps, xT_noise=xT_noise,
                  posterior_noises=posterior_noises)
        if self._fast:
            xT, eps = dpm_encode_cached(*self._cached_fns(), self.sched, x0, generator,
                                        key_every=self.fast_key_every, **kw)
        else:
            xT, eps = dpm_encode(core.apply_model, self.sched, x0, generator, **kw)
        z = torch.cat([xT[None], eps], dim=0)
        return z.transpose(0, 1).reshape(x0.shape[0], -1)

    def sample(self, z, generator: Optional[torch.Generator] = None, *,
               q_noise=None, chain_eps=None) -> torch.Tensor:
        """z -> the latent sample: the replay, then the refine."""
        spec = self.core.spec
        if z.shape[1] != self.latent_dim:
            raise ValueError(f"z of {z.shape[1]} values per image, expected {self.latent_dim}")
        z = z.reshape(z.shape[0], self.white_box_steps, spec.image_size, spec.image_size,
                      spec.channels)
        xT, eps = z[:, 0], z[:, 1:].transpose(0, 1)
        if self._fast:
            x = ddim_decode_cached(*self._cached_fns(), self.sched, xT, eps, generator,
                                   key_every=self.fast_key_every)
        else:
            x = ddim_decode(self.core.apply_model, self.sched, xT, eps, generator)
        if self.refine_steps > 0:
            x = ddim_refine(self.core.apply_model, self.sched, x, generator,
                            refine_steps=self.refine_steps, q_noise=q_noise,
                            chain_eps=chain_eps)
        return x

    def generate(self, z, generator: Optional[torch.Generator] = None, class_label=None,
                 **noises) -> torch.Tensor:
        """z -> [-1, 1] NHWC images (fp32); ``noises`` as in :meth:`sample`."""
        if class_label is not None:
            raise NotImplementedError("class-conditional translation is not implemented")
        return self.core.decode_first_stage(self.sample(z, generator, **noises))

    def __call__(self, z, generator: Optional[torch.Generator] = None, class_label=None,
                 **noises) -> torch.Tensor:
        return (self.generate(z, generator, class_label, **noises) + 1.0) / 2.0
