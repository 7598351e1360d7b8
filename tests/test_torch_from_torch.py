"""The port's CompVis checkpoint loader against the JAX package's converter,
and the factory's handling of the SD assets.

A CompVis-layout ``.ckpt`` of the tiny text-conditioned core is written by
``tools/sd_assets.py`` from the port's seeded random weights; the JAX
package's ``LatentDiffusionCore.from_torch_ckpt`` and the port's load it,
and the two cores' UNet eps, VAE encode and decode and text embedding agree
at fp32 to 1e-4 absolute (the tolerance of ``test_torch_models.py``: the
same arithmetic, sums in other orders).  The port's load gives back the
written weights bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu.pipelines.latent import LatentDiffusionCore as JCore
from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.pipelines import factory
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.tools import sd_assets
from test_torch_common import max_abs, to_torch

ATOL = 1e-4


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(the seeded port core, the path of its CompVis checkpoint)."""
    core = LatentDiffusionCore.random_init(LatentCoreSpec.tiny(), seed=5, device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    assert sd_assets.write_compvis_checkpoint(core, path) > 0
    return core, path


@pytest.fixture(scope="module")
def loaded(written):
    """(JAX core, port core), each loaded by its own converter."""
    _, path = written
    return (JCore.from_torch_ckpt(JSpec.tiny(cond_kind="clip"), path),
            LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny(), path, device="cpu"))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_checkpoint_layout_and_bitwise_reload(written, loaded):
    core, path = written
    sd = from_torch.load_torch_state_dict(path)
    assert {k.split(".")[0] for k in sd} == {"model", "first_stage_model", "cond_stage_model"}
    assert "cond_stage_model.transformer.text_model.encoder.layers.1.self_attn.q_proj.weight" in sd
    assert "cond_stage_model.transformer.text_model.embeddings.position_ids" in sd
    want, got = core.state_dict(), loaded[1].state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_unet_eps_matches_jax(loaded):
    jcore, core = loaded
    x, ctx = _rand((2, 8, 8, 4), 0), _rand((2, 16, 24), 1)
    t = np.array([5, 60])
    want = jcore.apply_model(jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(ctx))
    got = core.apply_model(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    assert float(jnp.abs(want).max()) > 0.1
    assert max_abs(got, want) < ATOL


def test_vae_encode_decode_match_jax(loaded):
    jcore, core = loaded
    img, noise, z = _rand((2, 32, 32, 3), 2), _rand((2, 8, 8, 4), 3), _rand((2, 8, 8, 4), 4)
    want = jcore.encode_first_stage(jnp.asarray(img), jnp.asarray(noise))
    assert max_abs(core.encode_first_stage(to_torch(img), to_torch(noise)), want) < ATOL
    want = jcore.decode_first_stage(jnp.asarray(z))
    assert max_abs(core.decode_first_stage(to_torch(z)), want) < ATOL


def test_text_embedding_matches_jax(loaded):
    jcore, core = loaded
    ids = np.random.default_rng(6).integers(0, 96, (2, 16))
    want = jcore.get_learned_conditioning(jnp.asarray(ids, jnp.int32))
    assert max_abs(core.get_learned_conditioning(ids), want) < ATOL


def _rewrite(path, tmp_path, edit):
    sd = dict(torch.load(path, weights_only=True)["state_dict"])
    edit(sd)
    out = str(tmp_path / "edited.ckpt")
    torch.save({"state_dict": sd}, out)
    return out


def test_missing_key_raises_like_jax(written, tmp_path):
    key = "model.diffusion_model.out.2.weight"
    path = _rewrite(written[1], tmp_path, lambda sd: sd.pop(key))
    jcore = JCore.from_torch_ckpt(JSpec.tiny(cond_kind="clip"), path)
    with pytest.raises(Exception, match="out_2"):          # Flax: at the first call
        jcore.apply_model(jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 16, 24)))
    with pytest.raises(KeyError, match="lacks 1 weight"):
        LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny(), path, device="cpu")


@pytest.mark.parametrize("key", ["model.diffusion_model.extra_head.weight",
                                 "cond_stage_model.transformer.text_model.pooler.weight"])
def test_extra_key_raises_like_jax(written, tmp_path, key):
    path = _rewrite(written[1], tmp_path, lambda sd: sd.__setitem__(key, torch.ones(3)))
    with pytest.raises(KeyError, match="unmapped"):
        JCore.from_torch_ckpt(JSpec.tiny(cond_kind="clip"), path)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny(), path, device="cpu")


def test_non_weight_entries_are_ignored_like_jax(written, tmp_path):
    """The schedule buffers and LitEma's counters sit outside the three
    subtrees: both loaders skip them."""
    def edit(sd):
        sd["betas"] = torch.ones(100)
        sd["model_ema.num_updates"] = torch.tensor(3)
    path = _rewrite(written[1], tmp_path, edit)
    JCore.from_torch_ckpt(JSpec.tiny(cond_kind="clip"), path)
    core = LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny(), path, device="cpu")
    assert torch.equal(core.unet.out[2].weight, written[0].unet.out[2].weight)


def test_ema_checkpoint_like_jax(written, tmp_path):
    """``use_ema`` swaps in LitEma's shadows (dots deleted from the name
    below ``model.``): both cores then compute with them; a checkpoint
    without shadows raises in both."""
    core, path = written
    shadow = torch.full_like(core.unet.out[2].weight, 0.01)

    def edit(sd):
        sd["model_ema.diffusion_modelout2weight"] = shadow
    ema_path = _rewrite(path, tmp_path, edit)
    jcore = JCore.from_torch_ckpt(JSpec.tiny(cond_kind="clip"), ema_path, use_ema=True)
    port = LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny(), ema_path, device="cpu",
                                               use_ema=True)
    assert torch.equal(port.unet.out[2].weight, shadow)
    np.testing.assert_array_equal(
        np.asarray(jcore.params["unet"]["params"]["out_2"]["kernel"]),
        shadow.permute(2, 3, 1, 0).numpy())
    x, ctx = _rand((1, 8, 8, 4), 7), _rand((1, 16, 24), 8)
    want = jcore.apply_model(jnp.asarray(x), jnp.asarray([30], jnp.int32), jnp.asarray(ctx))
    assert max_abs(port.apply_model(to_torch(x), torch.tensor([30]), to_torch(ctx)), want) < ATOL
    with pytest.raises(ValueError, match="no EMA shadows"):
        JCore.from_torch_ckpt(JSpec.tiny(cond_kind="clip"), path, use_ema=True)
    with pytest.raises(ValueError, match="no EMA shadows"):
        LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny(), path, device="cpu",
                                            use_ema=True)


@pytest.mark.parametrize("name", ["token_embedding.weight", "position_embedding",
                                  "layers.3.v_proj.bias", "layers.0.fc2.weight",
                                  "layers.11.layer_norm1.weight", "final_layer_norm.bias"])
def test_hf_clip_names_round_trip(name):
    hf = sd_assets.hf_clip_text_name(name)
    assert from_torch.clip_text_name("transformer.text_model." + hf) == name


SD_CFG = "experiments/translate_text2img256_stable_diffusion_stochastic_1.cfg"


def test_factory_refuses_a_missing_sd_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("CYCLEDIFFUSION_CKPT_ROOT", str(tmp_path))
    want = os.path.join(str(tmp_path), "ckpts", "stable_diffusion", "sd-v1-4.ckpt")
    with pytest.raises(FileNotFoundError, match=want.replace(".", r"\.")):
        factory.get_gan_wrapper(get_config(SD_CFG).gan, device="cpu")


def test_factory_requires_the_bpe_file(tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpts" / "stable_diffusion" / "sd-v1-4.ckpt"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(b"")      # found; the tokenizer is checked before it is read
    monkeypatch.setenv("CYCLEDIFFUSION_CKPT_ROOT", str(tmp_path))
    monkeypatch.delenv("CYCLEDIFFUSION_CLIP_BPE", raising=False)
    with pytest.raises(FileNotFoundError, match="CYCLEDIFFUSION_CLIP_BPE"):
        factory.get_gan_wrapper(get_config(SD_CFG).gan, device="cpu")
    monkeypatch.setenv("CYCLEDIFFUSION_CLIP_BPE", str(tmp_path / "no_such_bpe.txt.gz"))
    with pytest.raises(FileNotFoundError, match="no_such_bpe"):
        factory.get_gan_wrapper(get_config(SD_CFG).gan, device="cpu")


def test_tiny_factory_installs_its_scorer(monkeypatch):
    for var in ("CYCLEDIFFUSION_CLIP_CKPT", "CYCLEDIFFUSION_CLIP_BPE"):
        monkeypatch.delenv(var, raising=False)
    context.reset()
    pipe = factory.get_gan_wrapper(get_config("experiments/tiny_text_translation.cfg").gan,
                                   device="cpu")
    assert pipe.directional_clip is not None
    assert context.get_directional_clip(required=False) is pipe.directional_clip
    assert pipe.directional_clip.scorer.config == factory.TINY_CLIP
    context.reset()
