"""The port's YAML-subset reader (``runtime/yaml_subset.py``) against
``yaml.safe_load``, and the spec loaders built on it
(``LatentCoreSpec.from_yaml``, ``zoo.pixel_spec_from_yml``) against the JAX
package's, on files the test writes in the layouts of the reference's
specs: SD's ``v1-inference.yaml``, the LDMs' ``config.yaml`` (FFHQ and
text2img-large) and the SDEdit / DiffusionCLIP ``.yml`` files.  Values
equal exactly (no tolerance)."""

from __future__ import annotations

import dataclasses
import math

import pytest
import yaml

from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu.pipelines.zoo import PIXEL_ZOO as JZOO
from cyclediffusion_tpu.pipelines.zoo import pixel_spec_from_yml as jpixel_spec_from_yml
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec
from cyclediffusion_tpu_torch.pipelines.zoo import PIXEL_ZOO, pixel_spec_from_yml
from cyclediffusion_tpu_torch.runtime import yaml_subset
from cyclediffusion_tpu_torch.runtime.yaml_subset import YAMLSubsetError
from test_torch_common import port_fields

SD_V1_INFERENCE = """\
model:
  base_learning_rate: 1.0e-04
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.00085
    linear_end: 0.0120
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: "jpg"
    cond_stage_key: "txt"
    image_size: 64
    channels: 4
    cond_stage_trainable: false   # Note: different from the one we trained before
    conditioning_key: crossattn
    monitor: val/loss_simple_ema
    scale_factor: 0.18215
    use_ema: False

    scheduler_config: # 10000 warmup steps
      target: ldm.lr_scheduler.LambdaLinearScheduler
      params:
        warm_up_steps: [ 10000 ]
        cycle_lengths: [ 10000000000000 ] # incredibly large number to prevent corner cases
        f_start: [ 1.e-6 ]
        f_max: [ 1. ]
        f_min: [ 1. ]

    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        image_size: 32 # unused
        in_channels: 4
        out_channels: 4
        model_channels: 320
        attention_resolutions: [ 4, 2, 1 ]
        num_res_blocks: 2
        channel_mult: [ 1, 2, 4, 4 ]
        num_heads: 8
        use_spatial_transformer: True
        transformer_depth: 1
        context_dim: 768
        use_checkpoint: True
        legacy: False

    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: 128
          ch_mult:
          - 1
          - 2
          - 4
          - 4
          num_res_blocks: 2
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      target: ldm.modules.encoders.modules.FrozenCLIPEmbedder
"""

FFHQ_LDM = """\
model:
  base_learning_rate: 2.0e-06
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.0015
    linear_end: 0.0195
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: image
    image_size: 64
    channels: 3
    monitor: val/loss_simple_ema
    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        image_size: 64
        in_channels: 3
        out_channels: 3
        model_channels: 224
        attention_resolutions:
        # note: this is the downsampling factor, not the resolution:
        # attention at 8, 16 and 32 for the 64x64 latent of f4
        - 8
        - 4
        - 2
        num_res_blocks: 2
        channel_mult:
        - 1
        - 2
        - 3
        - 4
        num_head_channels: 32
    first_stage_config:
      target: ldm.models.autoencoder.VQModelInterface
      params:
        embed_dim: 3
        n_embed: 8192
        ckpt_path: configs/first_stage_models/vq-f4/model.ckpt
        ddconfig:
          double_z: false
          z_channels: 3
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: 128
          ch_mult:
          - 1
          - 2
          - 4
          num_res_blocks: 2
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity
    cond_stage_config: __is_unconditional__
data:
  target: main.DataModuleFromConfig
  params:
    batch_size: 42
    num_workers: 5
    wrap: false
    train:
      target: taming.data.faceshq.FFHQTrain
      params:
        size: 256
    validation:
      target: taming.data.faceshq.FFHQValidation
      params:
        size: 256
"""

TEXT2IMG_LARGE = """\
model:
  base_learning_rate: 5.0e-05
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.00085
    linear_end: 0.012
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: image
    cond_stage_key: caption
    image_size: 32
    channels: 4
    cond_stage_trainable: true
    conditioning_key: crossattn
    monitor: val/loss_simple_ema
    scale_factor: 0.18215
    use_ema: False

    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        image_size: 32
        in_channels: 4
        out_channels: 4
        model_channels: 320
        attention_resolutions:
        - 4
        - 2
        - 1
        num_res_blocks: 2
        channel_mult:
        - 1
        - 2
        - 4
        - 4
        num_heads: 8
        use_spatial_transformer: true
        transformer_depth: 1
        context_dim: 1280
        use_checkpoint: true
        legacy: False

    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: 128
          ch_mult:
          - 1
          - 2
          - 4
          - 4
          num_res_blocks: 2
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      target: ldm.modules.encoders.modules.BERTEmbedder
      params:
        n_embed: 1280
        n_layer: 32
"""

CELEBA_YML = """\
data:
    dataset: "CelebA_HQ"
    category: "celeba_hq"
    image_size: 256
    channels: 3
    logit_transform: false
    uniform_dequantization: false
    gaussian_dequantization: false
    random_flip: true
    rescaled: true
    num_workers: 0

model:
    type: "simple"
    in_channels: 3
    out_ch: 3
    ch: 128
    ch_mult: [1, 1, 2, 2, 4, 4]
    num_res_blocks: 2
    attn_resolutions: [16, ]
    dropout: 0.0
    var_type: fixedlarge
    ema_rate: 0.999
    ema: True
    resamp_with_conv: True

diffusion:
    beta_schedule: linear
    beta_start: 0.0001
    beta_end: 0.02
    num_diffusion_timesteps: 1000

sampling:
    batch_size: 4
    last_only: True
"""

AFHQ_YML = """\
data:
    dataset: "AFHQ"
    category: "dog"
    image_size: 256
    channels: 3
    logit_transform: false
    random_flip: true
    rescaled: true
    num_workers: 0

model:
    type: "simple"
    in_channels: 3
    out_ch: 3
    ch: 128
    ch_mult: [1, 1, 2, 2, 4, 4]
    num_res_blocks: 2
    attn_resolutions: [16, ]
    dropout: 0.1
    var_type: fixedsmall
    ema_rate: 0.9999
    ema: True
    resamp_with_conv: True

diffusion:
    beta_schedule: linear
    beta_start: 0.0001
    beta_end: 0.02
    num_diffusion_timesteps: 1000
"""

LSUN_FLOW_YML = """\
data: {dataset: LSUN, category: church_outdoor, image_size: 256, channels: 3}
model: {type: simple, in_channels: 3, out_ch: 3, ch: 128, ch_mult: [1, 1, 2, 2, 4, 4],
        num_res_blocks: 2, attn_resolutions: [16], dropout: 0.0, var_type: fixedlarge,
        resamp_with_conv: yes}
diffusion: {beta_schedule: linear, beta_start: 0.0001, beta_end: 0.02,
            num_diffusion_timesteps: 1000}
"""

DOCUMENTS = {"sd_v1_inference": SD_V1_INFERENCE, "ffhq_ldm": FFHQ_LDM,
             "text2img_large": TEXT2IMG_LARGE, "celeba_yml": CELEBA_YML,
             "afhq_yml": AFHQ_YML, "lsun_flow_yml": LSUN_FLOW_YML}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_reader_equals_safe_load(name):
    got = yaml_subset.safe_load(DOCUMENTS[name])
    assert got == yaml.safe_load(DOCUMENTS[name])
    assert repr(got) == repr(yaml.safe_load(DOCUMENTS[name]))      # bool is not int


SCALARS = [
    # floats need a dot (and a signed exponent); otherwise strings
    "1.0e-04", "1.e-6", "1e-4", "1.0e4", "5.0e-05", "1.", ".5", "-2.5", "+3.0",
    "1_000.5", "1:30.5", ".inf", "-.Inf", ".NaN",
    # bools, in YAML 1.1's words and casings
    "yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF",
    "true", "True", "TRUE", "false", "False", "FALSE", "y", "n", "tRUE",
    # nulls
    "~", "null", "Null", "NULL", "",
    # ints: decimal, hex, binary, leading-zero octal, underscores, base 60
    "0", "-0", "42", "+42", "-17", "0x1F", "0b101", "017", "08", "0o17", "1_000", "1:30",
    # strings
    "fixedsmall", "__is_unconditional__", "ldm.models.autoencoder.AutoencoderKL",
    "val/loss_simple_ema", "a b  c", "http://x.y/z#frag", "a:b", "'quoted: yes'",
    "\"esc\\taped\\u0041\"", "'it''s'",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_pyyaml(text):
    doc = f"key: {text}\n"
    want, got = yaml.safe_load(doc), yaml_subset.safe_load(doc)
    assert type(got["key"]) is type(want["key"]), text
    assert repr(got) == repr(want), text
    if isinstance(want["key"], float) and math.isnan(want["key"]):
        assert math.isnan(got["key"])
    # and as a flow sequence's item
    if text and "#" not in text:
        flow = f"key: [{text}, 2]\n"
        assert repr(yaml_subset.safe_load(flow)) == repr(yaml.safe_load(flow)), text


def test_layout_corner_cases_equal_safe_load():
    doc = ("top:\n  - a\n  - - b\n    - c\n  - k: v\n    k2: [1, {x: y}]\n  -\n    - z\n"
           "  -\nmulti: [1,\n   2, 3\n   ]\nempty_map: {}\nempty_seq: []\n"
           "nested: {a: 1, b: [1, 2], 'q': \"r\"}\n1: int key\nyes: bool key\n"
           "dup: 1\ndup: 2\n# trailing comment\n")
    assert repr(yaml_subset.safe_load(doc)) == repr(yaml.safe_load(doc))
    for doc in ("", "# only a comment\n", "---\na: 1\n...\n", "just a scalar\n"):
        assert repr(yaml_subset.safe_load(doc)) == repr(yaml.safe_load(doc)), doc


@pytest.mark.parametrize("doc,line,match", [
    ("a: 1\nb: &anchor 2\n", 2, "anchors"),
    ("a: 1\nb: *alias\n", 2, "aliases"),
    ("a: !!str 1\n", 1, "tags"),
    ("a: 1\nb: |\n  text\n", 2, "block scalars"),
    ("a: >\n  text\n", 1, "block scalars"),
    ("a: first\n  continued\n", 2, "multi-line"),
    ("a: 1\n? complex\n: v\n", 2, "complex keys"),
    ("when: 2001-12-14\n", 1, "timestamp"),
    ("a: 1\n---\nb: 2\n", 2, "several documents"),
    ("a: 'open\n  quote'\n", 1, "quoted"),
    ("<<: {a: 1}\n", 1, "merge"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directives"),
])
def test_unsupported_yaml_raises_with_its_line(doc, line, match):
    with pytest.raises(YAMLSubsetError, match=match) as err:
        yaml_subset.safe_load(doc)
    assert err.value.lineno == line and str(err.value).startswith(f"line {line}:")


def _fields(spec):
    """A spec as a dict, each nested config as a dict."""
    return {f.name: (dataclasses.asdict(getattr(spec, f.name))
                     if dataclasses.is_dataclass(getattr(spec, f.name))
                     else getattr(spec, f.name)) for f in dataclasses.fields(spec)}


def _assert_same_latent_spec(spec, jspec):
    """Field by field; a nested config on the port's fields (JAX's UNet also
    has ``dropout`` / ``conv_resample``, its first stage
    ``resamp_with_conv``, at their defaults)."""
    got, want = _fields(spec), _fields(jspec)
    got["unet"] = port_fields(spec.unet, want["unet"])
    for key in ("unet", "first_stage", "cond_cfg"):
        if isinstance(got[key], dict):
            assert got[key] == {k: want[key][k] for k in got[key]}, key
            got.pop(key), want.pop(key)
    assert got == want


@pytest.mark.parametrize("name,preset", [("sd_v1_inference", "sd_v1"),
                                         ("ffhq_ldm", "ldm_ffhq256"),
                                         ("text2img_large", "ldm_text2img_large")])
def test_from_yaml_equals_jax_and_the_preset(tmp_path, name, preset):
    path = tmp_path / "config.yaml"
    path.write_text(DOCUMENTS[name])
    spec = LatentCoreSpec.from_yaml(str(path), name=preset)
    _assert_same_latent_spec(spec, JSpec.from_yaml(str(path), name=preset))
    # the preset, but the resolution: the file's is the first stage's 256
    # (SD's wrapper runs its model at 512, which its file does not say)
    want = getattr(LatentCoreSpec, preset)()
    assert spec.resolution == 256
    assert spec == dataclasses.replace(want, resolution=256)
    assert LatentCoreSpec.from_yaml(str(path)).name == "from_yaml"


@pytest.mark.parametrize("name,zoo_entry,kind", [("celeba_yml", "celeba256", "compvis"),
                                                 ("afhq_yml", "afhqdog256", "improved"),
                                                 ("lsun_flow_yml", "church_outdoor256",
                                                  "compvis")])
def test_pixel_spec_from_yml_equals_jax_and_the_zoo(tmp_path, name, zoo_entry, kind):
    path = tmp_path / "model.yml"
    path.write_text(DOCUMENTS[name])
    spec, jspec = pixel_spec_from_yml(str(path)), jpixel_spec_from_yml(str(path))
    got, want = _fields(spec), _fields(jspec)
    got.pop("unet")
    theirs = want.pop("unet")
    ours = port_fields(spec.unet, theirs)
    assert got == want and ours == {k: theirs[k] for k in ours}
    assert spec.kind == kind and spec.unet == PIXEL_ZOO[zoo_entry].unet
    assert dataclasses.replace(spec, name=zoo_entry, default_ckpt=PIXEL_ZOO[zoo_entry]
                               .default_ckpt) == PIXEL_ZOO[zoo_entry]
    assert JZOO[zoo_entry].unet.__class__.__name__ == spec.unet.__class__.__name__


def test_pixel_spec_from_yml_refuses_what_jax_refuses(tmp_path):
    path = tmp_path / "other.yml"
    path.write_text(AFHQ_YML.replace('"AFHQ"', '"CIFAR10"'))
    for load in (pixel_spec_from_yml, jpixel_spec_from_yml):
        with pytest.raises(NotImplementedError, match="CIFAR10"):
            load(str(path))
