"""The pixel diffusion model zoo: ``source_model_type`` -> architecture and
schedule (counterpart of ``cyclediffusion_tpu.pipelines.zoo``).

The CompVis DDPMs (``celeba256``, ``bedroom256``, ``church_outdoor256``)
and the improved-DDPM UNets (``afhq{dog,cat,wild}256``, ``ffhq256``,
``imagenet512``), with the SDEdit / DiffusionCLIP settings the reference
reads from its ``ckpts/ddpm/configs/*.yml``.  ``learn_sigma`` is False
throughout, as the reference runs the zoo: the improved-DDPM UNets' 2C
output loses its variance half.  ``imagenet512`` builds, but no pipeline
runs it: it is class-conditional and the pipeline passes no label, so its
UNet raises, where the JAX package's fails.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.models.nn import fill_random_
from cyclediffusion_tpu_torch.models.unet_ddpm import DDPMUNet, DDPMUNetConfig
from cyclediffusion_tpu_torch.models.unet_gd import GDUNet, GDUNetConfig
from cyclediffusion_tpu_torch.runtime import yaml_subset


@dataclasses.dataclass(frozen=True)
class PixelModelSpec:
    """One pixel-space diffusion backbone."""

    name: str
    kind: str                      # "compvis" (DDPM) | "improved" (improved-DDPM)
    resolution: int
    channels: int
    var_type: str                  # "fixedsmall" | "fixedlarge"
    beta_start: float
    beta_end: float
    num_diffusion_timesteps: int
    unet: Union[DDPMUNetConfig, GDUNetConfig]
    learn_sigma: bool = False
    default_ckpt: Optional[str] = None


def _compvis(name, default_ckpt=None, var_type="fixedsmall"):
    return PixelModelSpec(
        name=name, kind="compvis", resolution=256, channels=3, var_type=var_type,
        beta_start=0.0001, beta_end=0.02, num_diffusion_timesteps=1000,
        unet=DDPMUNetConfig(ch=128, out_ch=3, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
                            attn_resolutions=(16,), in_channels=3, resolution=256),
        default_ckpt=default_ckpt)


def _improved(name, default_ckpt=None):
    return PixelModelSpec(
        name=name, kind="improved", resolution=256, channels=3, var_type="fixedsmall",
        beta_start=0.0001, beta_end=0.02, num_diffusion_timesteps=1000,
        unet=GDUNetConfig.afhq256(), default_ckpt=default_ckpt)


PIXEL_ZOO = {
    "celeba256": _compvis("celeba256", "ckpts/ddpm/celeba_hq.ckpt", var_type="fixedlarge"),
    "bedroom256": _compvis("bedroom256", "ckpts/ddpm/bedroom.ckpt", var_type="fixedlarge"),
    "church_outdoor256": _compvis("church_outdoor256", "ckpts/ddpm/church_outdoor.ckpt",
                                  var_type="fixedlarge"),
    "afhqdog256": _improved("afhqdog256"),
    "afhqcat256": _improved("afhqcat256"),
    "afhqwild256": _improved("afhqwild256"),
    "ffhq256": _improved("ffhq256", "ckpts/ddpm/ffhq_10m.pt"),
    "imagenet512": PixelModelSpec(
        name="imagenet512", kind="improved", resolution=512, channels=3,
        var_type="fixedsmall", beta_start=0.0001, beta_end=0.02,
        num_diffusion_timesteps=1000,
        unet=GDUNetConfig(
            in_channels=3, model_channels=256, out_channels=6, num_res_blocks=2,
            attention_resolutions=(16, 32, 64), channel_mult=(0.5, 1, 1, 2, 2, 4, 4),
            num_heads=4, num_head_channels=64, use_scale_shift_norm=True,
            resblock_updown=True, num_classes=1000),
        default_ckpt="ckpts/ddpm/512x512_diffusion.pt"),
}


def tiny_pixel_spec(resolution: int = 16, kind: str = "improved") -> PixelModelSpec:
    """A CPU-runnable miniature for tests and smoke runs."""
    if kind == "improved":
        unet = GDUNetConfig(
            in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
            attention_resolutions=(4,), channel_mult=(1, 2), num_heads=2,
            num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True)
    elif kind == "compvis":
        unet = DDPMUNetConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                              attn_resolutions=(resolution // 2,), in_channels=3,
                              resolution=resolution)
    else:
        raise ValueError(f"tiny pixel model kind {kind!r}: improved or compvis")
    return PixelModelSpec(
        name=f"tiny_{kind}_{resolution}", kind=kind, resolution=resolution, channels=3,
        var_type="fixedsmall", beta_start=0.0001, beta_end=0.02,
        num_diffusion_timesteps=100, unet=unet)


def pixel_spec_from_yml(path: str, name: Optional[str] = None) -> PixelModelSpec:
    """A spec from an SDEdit / DiffusionCLIP-style yml (the files the
    reference reads at ``ddpm_ddim_wrapper.py:96-98``), read by
    :mod:`runtime.yaml_subset`: the CompVis DDPM for ``CelebA_HQ`` and
    ``LSUN`` (its widths from the file), the improved-DDPM ``afhq256`` UNet
    for ``FFHQ`` and ``AFHQ``."""
    cfg = yaml_subset.load_file(path)
    data, model, diff = cfg["data"], cfg["model"], cfg["diffusion"]
    dataset = data["dataset"]
    if dataset in ("CelebA_HQ", "LSUN"):
        kind = "compvis"
        unet = DDPMUNetConfig(
            ch=model["ch"], out_ch=model["out_ch"],
            ch_mult=tuple(model["ch_mult"]),
            num_res_blocks=model["num_res_blocks"],
            attn_resolutions=tuple(model["attn_resolutions"]),
            dropout=model.get("dropout", 0.0),
            in_channels=model["in_channels"],
            resolution=data["image_size"],
            resamp_with_conv=model.get("resamp_with_conv", True),
        )
    elif dataset in ("FFHQ", "AFHQ"):
        kind = "improved"
        unet = GDUNetConfig.afhq256()
    else:
        raise NotImplementedError(dataset)
    return PixelModelSpec(
        name=name or dataset.lower(), kind=kind,
        resolution=data["image_size"], channels=data["channels"],
        var_type=model.get("var_type", "fixedsmall"),
        beta_start=diff["beta_start"], beta_end=diff["beta_end"],
        num_diffusion_timesteps=diff["num_diffusion_timesteps"],
        unet=unet,
    )


def build_pixel_model(spec: PixelModelSpec) -> nn.Module:
    """The spec's UNet module (on the current default device)."""
    if spec.kind == "compvis":
        return DDPMUNet(spec.unet)
    if spec.kind == "improved":
        return GDUNet(spec.unet)
    raise ValueError(f"pixel model kind {spec.kind!r}")


def init_random_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in place (:func:`models.nn.fill_random_`)."""
    fill_random_(model, generator)


def load_pixel_params(spec: PixelModelSpec, model: nn.Module, ckpt_path: str) -> None:
    """A reference checkpoint's weights into ``model`` (strict): the CompVis
    DDPM's or the improved-diffusion UNet's state dict."""
    sd = from_torch.load_torch_state_dict(ckpt_path)
    convert = (from_torch.convert_ddpm_unet if spec.kind == "compvis"
               else from_torch.convert_pixel_gd_unet)
    model.load_state_dict(convert(sd, model), strict=True)
