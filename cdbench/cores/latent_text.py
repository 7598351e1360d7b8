"""The model family ``latent_text`` on the program's side: the port's
``LatentDiffusionCore`` of a CompVis latent text-to-image model (SD v1,
LDM text2img-large), built from the benchmark's seeded state dict as
``LatentDiffusionCore.from_torch_ckpt`` builds it after reading a file
(``convert.from_torch``'s split and converters), with nothing written to
disk."""

from __future__ import annotations

from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.models.autoencoder import DDConfig
from cyclediffusion_tpu_torch.models.text_encoders import CLIPTextConfig, LDMBertConfig
from cyclediffusion_tpu_torch.models.unet_gd import GDUNetConfig
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.text import HashTokenizer


def core_spec(cfg: dict) -> LatentCoreSpec:
    """The port's spec of a configuration file's ``arch``."""
    a = cfg["arch"]
    u, f, c = a["unet"], a["first_stage"], a["cond"]
    unet = GDUNetConfig(
        in_channels=u["in_channels"], model_channels=u["model_channels"],
        out_channels=u["out_channels"], num_res_blocks=u["num_res_blocks"],
        attention_resolutions=tuple(u["attention_resolutions"]),
        channel_mult=tuple(u["channel_mult"]), num_heads=u["num_heads"],
        use_spatial_transformer=True, transformer_depth=u["transformer_depth"],
        context_dim=u["context_dim"], legacy=False)
    first_stage = DDConfig(ch=f["ch"], out_ch=f["out_ch"], ch_mult=tuple(f["ch_mult"]),
                           num_res_blocks=f["num_res_blocks"], attn_resolutions=(),
                           in_channels=f["in_channels"], resolution=f["resolution"],
                           z_channels=f["z_channels"], double_z=True)
    if c["kind"] == "clip":
        cond = CLIPTextConfig(vocab_size=c["vocab_size"], hidden_size=c["width"],
                              num_layers=c["layers"], num_heads=c["heads"],
                              max_positions=c["context_length"], intermediate_size=c["ff"])
    else:
        cond = LDMBertConfig(vocab_size=c["vocab_size"], dim=c["width"], depth=c["layers"],
                             heads=c["heads"], dim_head=c["dim_head"],
                             max_seq_len=c["context_length"], ff_mult=c["ff_mult"])
    return LatentCoreSpec(
        name=cfg["preset"], unet=unet, first_stage=first_stage, fs_kind="kl",
        embed_dim=f["embed_dim"], scale_factor=a["scale_factor"],
        linear_start=a["linear_start"], linear_end=a["linear_end"],
        num_timesteps=a["timesteps"], cond_kind=c["kind"], cond_cfg=cond,
        resolution=cfg["resolution"])


def load_core(cfg: dict, state_dict: dict, device, dtype) -> LatentDiffusionCore:
    """A frozen core holding ``state_dict``'s values (CompVis names)."""
    spec = core_spec(cfg)
    core = LatentDiffusionCore(spec, device, dtype)
    unet_sd, fs_sd, cond_sd = from_torch.split_latent_diffusion_state(state_dict)
    convert_cond = {"clip": from_torch.convert_clip_text,
                    "bert": from_torch.convert_ldm_bert}[spec.cond_kind]
    for module, convert, part in ((core.unet, from_torch.convert_gd_unet, unet_sd),
                                  (core.first_stage, from_torch.convert_vae, fs_sd),
                                  (core.cond_model, convert_cond, cond_sd)):
        module.load_state_dict(convert(part, module), strict=True)
    return core


def tokenizer(cfg: dict) -> HashTokenizer:
    """The prompts' token ids, as the reference's ``sampling.hash_tokens``."""
    c = cfg["arch"]["cond"]
    return HashTokenizer(c["vocab_size"], c["context_length"])
