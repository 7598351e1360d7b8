"""LatentDiffusion core: UNet + KL first stage + text conditioning, CLIP
(SD v1) or LDM-BERT (LDM text2img-large) (counterpart of ``LatentCoreSpec``
/ ``LatentDiffusionCore`` in ``cyclediffusion_tpu.pipelines.latent``).

The modules run in the core's dtype (bf16 on the card); the sampler around
them stays fp32: :meth:`LatentDiffusionCore.apply_model` casts the latent
to the core's dtype and its eps back to fp32, and the first-stage posterior
is sampled in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.models.autoencoder import (
    AutoencoderKL,
    DDConfig,
    DiagonalGaussian,
)
from cyclediffusion_tpu_torch.models.nn import fill_random_, resolve_device
from cyclediffusion_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextEncoder,
    LDMBertConfig,
    LDMBertEncoder,
)
from cyclediffusion_tpu_torch.models.unet_gd import GDUNet, GDUNetConfig
from cyclediffusion_tpu_torch.ops import schedule


@dataclasses.dataclass(frozen=True)
class LatentCoreSpec:
    """One text-conditioned latent diffusion model (KL first stage; CLIP or
    LDM-BERT conditioning, ``cond_kind`` ``"clip"`` or ``"bert"``)."""

    name: str
    unet: GDUNetConfig
    first_stage: DDConfig
    embed_dim: int
    scale_factor: float
    linear_start: float
    linear_end: float
    num_timesteps: int = 1000
    cond_kind: str = "clip"
    cond_cfg: Optional[object] = None   # CLIPTextConfig or LDMBertConfig
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
            embed_dim=4, scale_factor=0.18215,
            linear_start=0.00085, linear_end=0.0120,
            cond_cfg=CLIPTextConfig.vit_l_14(), resolution=512,
        )

    @staticmethod
    def ldm_text2img_large() -> "LatentCoreSpec":
        """LDM text2img-large (txt2img-1p4B-eval.yaml) at 256 px."""
        return LatentCoreSpec(
            name="ldm_text2img_large", unet=GDUNetConfig.ldm_text2img_large(),
            first_stage=DDConfig.sd_f8(), embed_dim=4,
            scale_factor=0.18215, linear_start=0.00085, linear_end=0.012,
            cond_kind="bert", cond_cfg=LDMBertConfig.text2img_large(),
            resolution=256,
        )

    @staticmethod
    def tiny(cond_kind: str = "clip", resolution: int = 32) -> "LatentCoreSpec":
        """CPU-runnable miniature (latent 8x8) — the JAX package's
        ``LatentCoreSpec.tiny(cond_kind=...)`` with a KL first stage."""
        if cond_kind == "clip":
            cond_cfg = CLIPTextConfig(vocab_size=96, hidden_size=24, num_layers=2,
                                      num_heads=4, max_positions=16, intermediate_size=48)
        elif cond_kind == "bert":
            cond_cfg = LDMBertConfig(vocab_size=96, dim=24, depth=2, heads=2,
                                     dim_head=12, max_seq_len=16)
        else:
            raise ValueError(f"cond_kind={cond_kind!r} is not 'clip' or 'bert'")
        return LatentCoreSpec(
            name=f"tiny_latent_{cond_kind}_kl",
            unet=GDUNetConfig.tiny(context_dim=24),
            first_stage=DDConfig(ch=16, ch_mult=(1, 2, 4), num_res_blocks=1,
                                 resolution=resolution, z_channels=4,
                                 double_z=True, attn_resolutions=()),
            embed_dim=4, scale_factor=0.18215,
            linear_start=0.00085, linear_end=0.012, num_timesteps=100,
            cond_kind=cond_kind, cond_cfg=cond_cfg, resolution=resolution,
        )

    @property
    def context_length(self) -> int:
        """Tokens of the conditioning text."""
        cfg = self.cond_cfg
        return cfg.max_positions if self.cond_kind == "clip" else cfg.max_seq_len


class LatentDiffusionCore:
    """The three modules of the model on one device, in one dtype, frozen.

    ``folded_attn`` (``None``, ``"qo"``, ``"1"``) selects the UNet's long
    self-attention path (see ``models.transformer.CrossAttention``)."""

    def __init__(self, spec: LatentCoreSpec, device="cuda", dtype=torch.float32,
                 folded_attn: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = dtype
        self.folded_attn = folded_attn
        with self.device:
            self.unet = GDUNet(spec.unet, folded_attn)
            self.first_stage = AutoencoderKL(spec.first_stage, spec.embed_dim)
            self.cond_model = (CLIPTextEncoder(spec.cond_cfg) if spec.cond_kind == "clip"
                               else LDMBertEncoder(spec.cond_cfg))
        for m in self.modules():
            m.to(dtype=dtype).eval().requires_grad_(False)

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
        ``{"unet": ..., "first_stage": ..., "cond": ...}``."""
        core = cls(spec, device, dtype, folded_attn)
        load_flax_params(core.unet, params["unet"])
        load_flax_params(core.first_stage, params["first_stage"])
        load_flax_params(core.cond_model, params["cond"])
        return core

    @classmethod
    @torch.no_grad()
    def from_torch_ckpt(cls, spec: LatentCoreSpec, path: str, device="cuda",
                        dtype=torch.float32, folded_attn: Optional[str] = None,
                        use_ema: bool = False) -> "LatentDiffusionCore":
        """Weights from a CompVis ``LatentDiffusion`` checkpoint (SD v1's
        ``sd-v1-4.ckpt`` or LDM text2img-large's ``model.ckpt`` layout, see
        ``convert.from_torch``); ``use_ema`` takes the UNet's LitEma
        shadows.  Raises on a missing file, an unmapped or missing key, or a
        shape mismatch."""
        core = cls(spec, device, dtype, folded_attn)
        sd = from_torch.load_torch_state_dict(path)
        unet_sd, fs_sd, cond_sd = from_torch.split_latent_diffusion_state(sd, use_ema)
        convert_cond = (from_torch.convert_clip_text if spec.cond_kind == "clip"
                        else from_torch.convert_ldm_bert)
        for module, convert, part in ((core.unet, from_torch.convert_gd_unet, unet_sd),
                                      (core.first_stage, from_torch.convert_vae, fs_sd),
                                      (core.cond_model, convert_cond, cond_sd)):
            module.load_state_dict(convert(part, module), strict=True)
        return core

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
        return (("unet", self.unet), ("first_stage", self.first_stage),
                ("cond_model", self.cond_model))

    # ---- model surface -------------------------------------------------- #

    @torch.no_grad()
    def apply_model(self, x, t, context):
        """fp32 NHWC latent -> fp32 eps, the UNet running in the core dtype."""
        return self.unet(x.to(self.dtype), t, context.to(self.dtype)).float()

    @torch.no_grad()
    def apply_model_cached(self, x, t, context, encoder_cache=None):
        """The fast mode's UNet call: ``(fp32 eps, cache)``; given a cache,
        the decoder half alone runs on it (see ``GDUNet.forward``)."""
        eps, cache = self.unet(x.to(self.dtype), t, context.to(self.dtype),
                               encoder_cache=encoder_cache, return_cache=True)
        return eps.float(), cache

    @torch.no_grad()
    def get_learned_conditioning(self, token_ids):
        ids = torch.as_tensor(np.asarray(token_ids), dtype=torch.int64,
                              device=self.device)
        return self.cond_model(ids)

    @torch.no_grad()
    def encode_first_stage(self, image_m11, noise):
        """[-1,1] NHWC image -> x0 latent: the KL posterior sampled with
        ``noise`` (fp32), times the scale factor."""
        moments = self.first_stage.encode_moments(image_m11.to(self.dtype)).float()
        return DiagonalGaussian(moments).sample(noise) * self.spec.scale_factor

    @torch.no_grad()
    def decode_first_stage(self, z):
        """Latent -> [-1,1] NHWC image (fp32)."""
        z = (z / self.spec.scale_factor).to(self.dtype)
        return self.first_stage.decode(z).float()

    def make_ddim_schedule(self, custom_steps: int, eta: float):
        betas = schedule.make_beta_schedule(
            "linear", self.spec.num_timesteps,
            linear_start=self.spec.linear_start, linear_end=self.spec.linear_end)
        return schedule.DDIMSchedule.create(betas, custom_steps, eta)
