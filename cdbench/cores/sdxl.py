"""The model family ``sdxl`` on the program's side: the port's
``LatentDiffusionCore`` of SDXL base (``LatentCoreSpec.sdxl_base``'s shape,
sized by the configuration's ``arch``), built from the benchmark's seeded
state dict as ``LatentDiffusionCore.from_torch_ckpt`` builds it after
reading a file (``convert.from_torch``'s split and converters), with nothing
written to disk."""

from __future__ import annotations

import dataclasses

from cyclediffusion_tpu_torch.models.autoencoder import DDConfig
from cyclediffusion_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    OpenCLIPTextConfig,
    SDXLConditionerConfig,
)
from cyclediffusion_tpu_torch.models.unet_gd import GDUNetConfig
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.text import HashTokenizer


def core_spec(cfg: dict) -> LatentCoreSpec:
    """The port's spec of a configuration file's ``arch``: the SDXL base
    preset with the file's sizes (its ``unet`` keys are ``GDUNetConfig``'s
    fields)."""
    a = cfg["arch"]
    f, tl, tg = a["first_stage"], a["text_l"], a["text_g"]
    unet = dataclasses.replace(GDUNetConfig.sdxl_base(), **{
        k: tuple(v) if isinstance(v, list) else v for k, v in a["unet"].items()})
    first_stage = DDConfig(ch=f["ch"], out_ch=f["out_ch"], ch_mult=tuple(f["ch_mult"]),
                           num_res_blocks=f["num_res_blocks"], attn_resolutions=(),
                           in_channels=f["in_channels"], resolution=f["resolution"],
                           z_channels=f["z_channels"], double_z=True)
    cond = SDXLConditionerConfig(
        clip=CLIPTextConfig(vocab_size=tl["vocab_size"], hidden_size=tl["width"],
                            num_layers=tl["layers"], num_heads=tl["heads"],
                            max_positions=tl["context_length"], intermediate_size=tl["ff"]),
        clip_layer=tl["layer_idx"],
        open_clip=OpenCLIPTextConfig(vocab_size=tg["vocab_size"], width=tg["width"],
                                     layers=tg["layers"], heads=tg["heads"], mlp=tg["mlp"],
                                     context_length=tg["context_length"],
                                     embed_dim=tg["embed_dim"]),
        size_embed_dim=a["size_embed_dim"],
        micro_conditioning=tuple(a["micro_conditioning"]))
    return LatentCoreSpec(
        name=cfg["preset"], unet=unet, first_stage=first_stage, fs_kind="kl",
        embed_dim=f["embed_dim"], scale_factor=a["scale_factor"],
        linear_start=a["linear_start"], linear_end=a["linear_end"],
        num_timesteps=a["timesteps"], cond_kind="sdxl", cond_cfg=cond,
        resolution=cfg["resolution"])


def load_core(cfg: dict, state_dict: dict, device, dtype) -> LatentDiffusionCore:
    """A frozen core holding ``state_dict``'s values (generative-models'
    names)."""
    core = LatentDiffusionCore(core_spec(cfg), device, dtype)
    core.load_torch_state_dict(state_dict)
    return core


def tokenizer(cfg: dict) -> HashTokenizer:
    """The prompts' token ids, one sequence for both towers, as the
    reference's ``sampling.hash_tokens``."""
    t = cfg["arch"]["text_l"]
    return HashTokenizer(t["vocab_size"], t["context_length"])
