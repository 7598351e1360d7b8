"""The unpaired latent translation slice (FFHQ -> CelebA-HQ,
``LatentDiffStochastic``) of the port against the JAX package at fp32: the
attention block, the FFHQ UNet topology (exact and with the encoder
cache), the VQ first stage, ``ddim_refine``, the tiny VQ pipeline through
the factory (exact and fast, fed JAX's own draws), the full-width specs,
the CompVis loader with EMA shadows, the preprocessors, the task model and
the CLI.

Tolerances: a module's output 1e-4 absolute (fp32, summation order; the
UNet's 1e-4 as ``test_torch_fast_mode.py``); the latent code z 2e-4 and the
[0, 1] images 2e-4 (as ``test_torch_pipeline.py``: each UNet call of a
chain adds ~1e-5); ``ddim_refine`` on a closed-form eps model 1e-5; the VQ
code indices equal.  Images of the preprocessors within 1/255 (Pillow's
fixed-point resize, as ``test_torch_data.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.models import autoencoder as jae
from cyclediffusion_tpu.models import nn as jnn
from cyclediffusion_tpu.models import unet_gd as jug
from cyclediffusion_tpu.ops.schedule import DDIMSchedule as JSchedule
from cyclediffusion_tpu.ops.schedule import make_beta_schedule
from cyclediffusion_tpu.pipelines.factory import get_gan_wrapper as jget_gan_wrapper
from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu.pipelines.latent import LatentDiffusionCore as JCore
from cyclediffusion_tpu.pipelines.latent import LatentDiffStochasticPipeline as JPipe
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu.samplers import ddim_refine as jrefine
from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.models import autoencoder as ae
from cyclediffusion_tpu_torch.models import unet_gd as ug
from cyclediffusion_tpu_torch.models.nn import GDAttentionBlock
from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.pipelines import factory
from cyclediffusion_tpu_torch.pipelines.latent import (
    LatentCoreSpec,
    LatentDiffStochasticPipeline,
    LatentDiffusionCore,
)
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.samplers import ddim_refine
from cyclediffusion_tpu_torch.tasks.unsupervised_translation import UnsupervisedTranslation
from cyclediffusion_tpu_torch.tools import ldm_assets
from test_torch_common import REPO, fill_flax_tree, max_abs, to_torch

ATOL = 1e-4
Z_TOL = 2e-4
IMG_TOL = 2e-4
TINY_CFG = "experiments/tiny_unpaired_latent.cfg"
FFHQ_CFG = "experiments/translate_ffhq256_to_celeba256_latentdiff_ddim_eta01.cfg"


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---- the attention block and the UNet ------------------------------------- #

@pytest.mark.parametrize("hw,c,heads,head_ch", [
    (32, 64, 1, 32),     # 1024 tokens: the K1 route (its plain version here), d = 32
    (8, 64, 4, -1),      # 64 tokens, plain attention, heads by count
])
def test_attention_block_matches_jax(hw, c, heads, head_ch):
    jmod = jnn.GDAttentionBlock(num_heads=heads, num_head_channels=head_ch)
    x = _rand((2, hw, hw, c), 0)
    tree = fill_flax_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, hw, hw, c))), 1)
    want = jmod.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    mod = GDAttentionBlock(c, heads, head_ch)
    load_flax_params(mod, tree)
    assert mod.qkv.weight.shape == (3 * c, c, 1) and mod.proj_out.weight.shape == (c, c, 1)
    assert mod.heads == (c // head_ch if head_ch != -1 else heads)
    with torch.no_grad():
        got = mod(to_torch(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert max_abs(got, want) < ATOL
    assert max_abs(got, x) > 0.1        # the attention reaches the output


def _narrow_ffhq():
    """The FFHQ UNet's topology at narrow widths: attention at ds (8, 4, 2)
    of 4 levels, 32-channel heads (1 to 4 heads), a 16x16 latent."""
    return dataclasses.replace(jug.GDUNetConfig.ldm_ffhq256(), model_channels=32)


@pytest.fixture(scope="module")
def narrow_unets():
    cfg = _narrow_ffhq()
    jmod = jug.GDUNet(cfg)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                            jnp.zeros((1,), jnp.int32))
    tree = fill_flax_tree(shapes, 5)
    jtree = jax.tree.map(jnp.asarray, tree)
    fields = {f.name for f in dataclasses.fields(ug.GDUNetConfig)}
    mod = ug.GDUNet(ug.GDUNetConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                       if k in fields}))
    load_flax_params(mod, tree)
    mod.eval().requires_grad_(False)

    def japply(x, t, cache=None, return_cache=False):
        return jmod.apply(jtree, x, t, encoder_cache=cache, return_cache=return_cache)
    return japply, mod


def test_ffhq_topology_matches_jax_exact_and_cached(narrow_unets):
    """Exactly, and with the encoder cache: the cached call at another t
    runs the decoder half on JAX's features, as in JAX."""
    japply, mod = narrow_unets
    assert sum(isinstance(m, GDAttentionBlock) for m in mod.modules()) == 2 * 3 + 3 * 3 + 1
    x = _rand((2, 16, 16, 3), 2)
    t, t2 = np.array([7, 400], np.int32), np.array([30, 30], np.int32)
    want, jcache = japply(jnp.asarray(x), jnp.asarray(t), return_cache=True)
    with torch.no_grad():
        full, cache = mod(to_torch(x), torch.as_tensor(t, dtype=torch.int64),
                          return_cache=True)
        at_t2 = mod(to_torch(x), torch.as_tensor(t2, dtype=torch.int64), encoder_cache=cache)
    assert float(jnp.abs(want).max()) > 0.1
    assert max_abs(full, want) < ATOL
    want_t2 = japply(jnp.asarray(x), jnp.asarray(t2), jcache)
    assert max_abs(at_t2, want_t2) < ATOL
    assert max_abs(at_t2, full) > 1e-3


def test_output_blocks_take_num_heads_upsample():
    """The output blocks' attention binds to ``num_heads_upsample`` (by
    default the original ``num_heads``), the input blocks' to ``num_heads``,
    as in the JAX module."""
    cfg = ug.GDUNetConfig(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
                          attention_resolutions=(1,), channel_mult=(1, 2), num_heads=4,
                          num_heads_upsample=2)
    mod = ug.GDUNet(cfg)
    assert mod.input_blocks[1][1].heads == 4 and mod.output_blocks[2][1].heads == 2
    assert mod.middle_block[1].heads == 4


def test_full_width_specs_match_jax():
    """``ldm_ffhq256`` / ``ldm_celeba256`` field by field, and the published
    parameter counts (on the meta device; JAX's by ``jax.eval_shape``)."""
    for name in ("ldm_ffhq256", "ldm_celeba256"):
        spec, jspec = getattr(LatentCoreSpec, name)(), getattr(JSpec, name)()
        got, want = dataclasses.asdict(spec), dataclasses.asdict(jspec)
        want["first_stage"].pop("resamp_with_conv")
        for key in ("unet", "first_stage"):
            ours, theirs = got.pop(key), want.pop(key)
            assert {k: ours[k] for k in theirs if k in ours} == {
                k: theirs[k] for k in theirs if k in ours}, key
        assert got == want
        assert (spec.image_size, spec.channels, spec.context_length) == (64, 3, None)
    spec = LatentCoreSpec.ldm_ffhq256()
    with torch.device("meta"):
        unet = ug.GDUNet(spec.unet)
        vq = ae.VQModel(spec.first_stage, spec.n_embed, spec.embed_dim)
    n_unet, n_vq = (sum(p.numel() for p in m.parameters()) for m in (unet, vq))
    assert (n_unet, n_vq) == (274_056_163, 55_322_782)
    assert vq.quantize.embedding.weight.shape == (8192, 3)
    jshapes = jax.eval_shape(jug.GDUNet(JSpec.ldm_ffhq256().unet).init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,), jnp.int32))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes)) == n_unet
    heads = {m.heads for m in unet.modules() if isinstance(m, GDAttentionBlock)}
    assert heads == {14, 21, 28}        # 448, 672 and 896 channels of 32


def test_ffhq_ds2_attention_routes_to_k1_at_head_dim_32():
    """At the published widths the ds-2 attention (1024 tokens of 14 x 32)
    goes to K1, which takes head dim 32; K3/K4 keep their own head dims."""
    assert fa.attention_route(32 * 32, 32 * 32) == "bhtd"
    assert fa.attention_route(16 * 16, 16 * 16) == "plain"
    assert 32 in fa.SUPPORTED_HEAD_DIMS and 32 not in fa.FOLDED_HEAD_DIMS


# ---- the VQ first stage ----------------------------------------------------- #

@pytest.fixture(scope="module")
def vq_models():
    cfg = JSpec.tiny(cond_kind=None, fs_kind="vq", resolution=16).first_stage
    jmod = jae.VQModel(cfg, n_embed=64, embed_dim=4)
    tree = fill_flax_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 16, 16, 3))), 7)
    jtree = jax.tree.map(jnp.asarray, tree)
    mod = ae.VQModel(LatentCoreSpec.tiny(None, 16, "vq").first_stage, 64, 4)
    load_flax_params(mod, tree)
    mod.eval().requires_grad_(False)
    return jmod, jtree, mod


def test_vq_encode_decode_match_jax_with_equal_codes(vq_models):
    jmod, jtree, mod = vq_models
    x = _rand((2, 16, 16, 3), 8)
    want = jmod.apply(jtree, jnp.asarray(x), method=jmod.encode)
    with torch.no_grad():
        h = mod.encode(to_torch(x))
        assert max_abs(h, want) < ATOL
        _, jidx = jmod.apply(jtree, want, method=lambda m, z: m.quantize(z))
        _, idx = mod.quantize(to_torch(np.asarray(want)))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert len(np.unique(idx.numpy())) > 4
        for force in (False, True):
            jdec = jmod.apply(jtree, want, force, method=jmod.decode)
            assert max_abs(mod.decode(to_torch(np.asarray(want)), force), jdec) < ATOL


def test_vq_codebook_stays_fp32_in_a_bf16_core():
    core = LatentDiffusionCore(LatentCoreSpec.tiny(None, 16, "vq"), device="cpu",
                               dtype=torch.bfloat16)
    assert core.first_stage.quantize.embedding.weight.dtype == torch.float32
    assert core.first_stage.post_quant_conv.weight.dtype == torch.bfloat16
    img = core.decode_first_stage(torch.randn(1, 4, 4, 4))
    assert img.dtype == torch.float32 and img.shape == (1, 16, 16, 3)


# ---- the refine and the pipeline -------------------------------------------- #

def _fake_eps(x, t):
    return 0.1 * x * jnp.cos(t.astype(jnp.float32) / 100.0).reshape(-1, 1, 1, 1)


def _fake_eps_t(x, t):
    return 0.1 * x * torch.cos(t.float() / 100.0).reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("refine_steps,eta", [(3, 0.1), (7, 1.0)])
def test_ddim_refine_matches_jax_with_its_draws(refine_steps, eta):
    betas = make_beta_schedule("linear", 100, 0.00085, 0.012)
    jsched, sched = JSchedule.create(betas, 8, eta), DDIMSchedule.create(betas, 8, eta)
    x0 = _rand((2, 4, 4, 3), 9)
    key = jax.random.PRNGKey(3)
    want = jrefine(_fake_eps, jsched, jnp.asarray(x0), key, refine_steps=refine_steps)
    k_q, k_chain = jax.random.split(key)
    q_noise = jax.random.normal(k_q, x0.shape)
    chain = jax.random.normal(k_chain, (refine_steps,) + x0.shape)
    got = ddim_refine(_fake_eps_t, sched, to_torch(x0), refine_steps=refine_steps,
                      q_noise=to_torch(q_noise), chain_eps=to_torch(chain))
    assert max_abs(got, want) < 1e-5
    again = ddim_refine(_fake_eps_t, sched, to_torch(x0), torch.Generator().manual_seed(0),
                        refine_steps=refine_steps)
    assert again.shape == got.shape and max_abs(again, got) > 1e-3
    with pytest.raises(ValueError):
        ddim_refine(_fake_eps_t, sched, to_torch(x0), refine_steps=8)


@pytest.fixture(scope="module")
def tiny_pipes():
    """(JAX source pipeline, port pipeline with its weights) from each
    factory on ``tiny_unpaired_latent.cfg``."""
    jpipe = jget_gan_wrapper(jget_config(TINY_CFG).gan)
    params = {"core": _np_tree(jpipe.core.params)}
    pipe = factory.get_gan_wrapper(get_config(TINY_CFG).gan, device="cpu", jax_params=params)
    return jpipe, pipe


def _jax_draws(jpipe, key_enc, key_dec, x0_shape):
    """The draws of JAX's encode and generate: (x_T noise, posterior noises)
    and the refine's (q noise, chain eps)."""
    n = jpipe.white_box_steps - 1
    _, k_chain = jax.random.split(key_enc)
    k_xT, k_post = jax.random.split(k_chain)
    _, k_refine = jax.random.split(key_dec)
    k_q, k_rchain = jax.random.split(k_refine)
    return dict(xT_noise=to_torch(jax.random.normal(k_xT, x0_shape)),
                posterior_noises=to_torch(jax.random.normal(k_post, (n,) + x0_shape))), dict(
        q_noise=to_torch(jax.random.normal(k_q, x0_shape)),
        chain_eps=to_torch(jax.random.normal(k_rchain, (jpipe.refine_steps,) + x0_shape)))


@pytest.mark.parametrize("key_every", [None, 2])
def test_tiny_vq_pipeline_matches_jax(tiny_pipes, key_every):
    """z, the refined latent and the [0, 1] image, exact and in fast mode,
    the port fed JAX's draws."""
    jpipe0, pipe0 = tiny_pipes
    kw = dict(custom_steps=8, eta=0.1, white_box_steps=9, refine_steps=3,
              fast_key_every=key_every)
    jpipe = JPipe(jpipe0.core, **kw)
    pipe = LatentDiffStochasticPipeline(pipe0.core, **kw)
    assert pipe.latent_dim == jpipe.latent_dim == 4 * 4 * 4 * 9
    img = np.random.default_rng(10).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    k_enc, k_dec = jax.random.split(jax.random.PRNGKey(5))
    enc_noise, dec_noise = _jax_draws(jpipe, k_enc, k_dec, (2, 4, 4, 4))
    jz = jpipe.encode(jnp.asarray(img), k_enc)
    z = pipe.encode(img, **enc_noise)
    assert max_abs(z, jz) < Z_TOL
    want = jpipe(jz, k_dec)
    got = pipe(to_torch(np.asarray(jz)), **dec_noise)
    assert got.shape == (2, 16, 16, 3)
    assert max_abs(got, want) < IMG_TOL


def test_pipeline_refuses_what_jax_refuses(tiny_pipes):
    core = tiny_pipes[1].core
    kw = dict(custom_steps=8, eta=0.1, white_box_steps=9)
    with pytest.raises(NotImplementedError, match="class-conditional"):
        LatentDiffStochasticPipeline(core, enforce_class_input=True, **kw)
    with pytest.raises(ValueError):
        LatentDiffStochasticPipeline(core, custom_steps=8, eta=0.0, white_box_steps=9)
    pipe = LatentDiffStochasticPipeline(core, **kw)
    with pytest.raises(ValueError, match="16x16"):
        pipe.encode(torch.zeros(1, 8, 8, 3))


def test_round_trip_recovers_x0(tiny_pipes):
    """The DPM-Encoder's invariant on the VQ latent: encode, then replay
    without refine, gives back x0 (fp32)."""
    core = tiny_pipes[1].core
    pipe = LatentDiffStochasticPipeline(core, custom_steps=8, eta=0.1, white_box_steps=9)
    img = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    z = pipe.encode(img, gen)
    x0 = core.encode_first_stage(img * 2 - 1)
    assert max_abs(pipe.sample(z), x0) < 2e-5


# ---- checkpoints, factory, task, data, CLI ---------------------------------- #

def test_compvis_ema_loader_matches_jax(tmp_path):
    """A synthetic ``use_ema`` checkpoint (raw UNet, distinct EMA shadows,
    VQ first stage) loads as JAX's converter reads it; the raw UNet is not
    what is loaded; an unmapped key is refused by both loaders' contract."""
    spec = LatentCoreSpec.tiny(None, 16, "vq")
    core = LatentDiffusionCore.random_init(spec, seed=4, device="cpu")
    path = str(tmp_path / "model.ckpt")
    ldm_assets.write_ema_checkpoint(core, path, raw_seed=2)
    loaded = LatentDiffusionCore.from_torch_ckpt(spec, path, device="cpu", use_ema=True)
    want, got = core.state_dict(), loaded.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    raw = LatentDiffusionCore.from_torch_ckpt(spec, path, device="cpu")
    assert not torch.equal(raw.unet.out[2].weight, core.unet.out[2].weight)

    jcore = JCore.from_torch_ckpt(JSpec.tiny(cond_kind=None, fs_kind="vq", resolution=16),
                                  path, use_ema=True)
    x, t = _rand((2, 4, 4, 4), 11), np.array([5, 60], np.int32)
    jeps = jcore.apply_model(jnp.asarray(x), jnp.asarray(t))
    eps = loaded.apply_model(to_torch(x), torch.as_tensor(t, dtype=torch.int64))
    assert max_abs(eps, jeps) < ATOL
    img = _rand((1, 16, 16, 3), 12)
    assert max_abs(loaded.encode_first_stage(to_torch(img)),
                   jcore.encode_first_stage(jnp.asarray(img))) < ATOL

    sd = dict(from_torch.load_torch_state_dict(path))
    for i, (key, match) in enumerate((("model_ema.diffusion_modelinput_blocks11qkvxweight",
                                       None),
                                      ("first_stage_model.quantize.extra", "quantize.extra"),
                                      ("cond_stage_model.transformer.x", "cond_stage_model"))):
        bad = str(tmp_path / f"bad{i}.ckpt")
        torch.save({"state_dict": {**sd, key: torch.zeros(1)}}, bad)
        if match is None:   # a shadow with no raw weight is not a weight: ignored
            LatentDiffusionCore.from_torch_ckpt(spec, bad, device="cpu", use_ema=True)
            continue
        with pytest.raises(KeyError, match=match):
            LatentDiffusionCore.from_torch_ckpt(spec, bad, device="cpu", use_ema=True)
    bad = str(tmp_path / "bad_unet.ckpt")
    torch.save({"state_dict": {**sd, "model.diffusion_model.input_blocks.1.1.qkvx.weight":
                               torch.zeros(1)}}, bad)
    with pytest.raises(KeyError, match="qkvx"):
        LatentDiffusionCore.from_torch_ckpt(spec, bad, device="cpu", use_ema=True)


@pytest.mark.parametrize("model_type", ["ffhq256", "celeba256"])
def test_factory_needs_the_published_checkpoint(model_type, tmp_path, monkeypatch):
    """No random weights for the published models: the factory names the
    missing ``ckpts/ldm_models/ldm/<type>/model.ckpt``."""
    monkeypatch.setenv("CYCLEDIFFUSION_CKPT_ROOT", str(tmp_path))
    gan = get_config(FFHQ_CFG).gan
    want = os.path.join(str(tmp_path), "ckpts", "ldm_models", "ldm", model_type, "model.ckpt")
    with pytest.raises(FileNotFoundError, match=want.replace(".", r"\.")):
        factory.get_gan_wrapper(gan, target=model_type == "celeba256", device="cpu")


def test_factory_loads_the_ema_weights(tmp_path, monkeypatch):
    """With a (tiny-width) checkpoint at the published path, the factory
    loads the EMA shadows; tiny, tiny_vq and the pipeline's settings as in
    JAX."""
    spec = dataclasses.replace(LatentCoreSpec.tiny(None, 16, "vq"), num_timesteps=1000)
    core = LatentDiffusionCore.random_init(spec, seed=3, device="cpu")
    path = tmp_path / "ckpts" / "ldm_models" / "ldm" / "ffhq256" / "model.ckpt"
    ldm_assets.write_ema_checkpoint(core, str(path))
    monkeypatch.setenv("CYCLEDIFFUSION_CKPT_ROOT", str(tmp_path))
    monkeypatch.setitem(factory.LATENT_MODELS, "ffhq256", lambda: spec)
    pipe = factory.get_gan_wrapper(get_config(FFHQ_CFG).gan, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pipe.core.state_dict().values(),
                                                 core.state_dict().values()))
    assert (pipe.custom_steps, pipe.white_box_steps, pipe.eta, pipe.refine_steps) == (
        999, 1000, 0.1, 400)
    for model_type, fs_kind, res in (("tiny", "kl", 32), ("tiny_vq", "vq", 16)):
        gan = [("gan_type", "LatentDiffStochastic"), ("source_model_type", model_type),
               ("custom_steps", 4), ("eta", 0.1), ("white_box_steps", 5)]
        built = factory.get_gan_wrapper(gan, device="cpu")
        jspec = JSpec.tiny(cond_kind=None, fs_kind=fs_kind, resolution=res)
        assert built.core.spec == LatentCoreSpec.tiny(None, res, fs_kind)
        assert (built.core.spec.fs_kind, built.resolution) == (jspec.fs_kind, jspec.resolution)
        assert built.latent_dim == jspec.image_size ** 2 * jspec.channels * 5
        assert built.core.cond_model is None


def test_task_model_translates_a_batch(tiny_pipes):
    """Source encode, target decode: one generator per batch from the first
    sample id, so the same batch gives the same images."""
    context_cfg = get_config(TINY_CFG)
    model = UnsupervisedTranslation(context_cfg, base_seed=3, device="cpu")
    assert model.resolution == 16
    assert not torch.equal(model.source_gan_wrapper.core.unet.out[2].weight,
                           model.target_gan_wrapper.core.unet.out[2].weight)
    imgs = [np.random.default_rng(i).uniform(size=(16, 16, 3)).astype(np.float32)
            for i in range(2)]
    (orig, out), loss, losses = model.forward(np.array([4, 5]), original_image=imgs)
    (_, again), _, _ = model(np.array([4, 5]), original_image=imgs)
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert loss.shape == (2,) and float(loss.abs().sum()) == 0 and losses == {}
    np.testing.assert_array_equal(orig.numpy(), np.stack(imgs))
    with pytest.raises(NotImplementedError):
        model.forward(np.array([0]), class_label=np.array([1]), original_image=imgs[:1])


def _dev(get_cfg, get_pre, args_cls, task):
    task_args = get_cfg(f"tasks/{task}.cfg")
    meta = args_cls(raw_data=args_cls(upsample_temp=1))
    pre = get_pre(task_args.preprocess.preprocess_program)(task_args, meta)
    return pre.preprocess({"train": [], "validation": [], "test": []}, cache_root="unused")


@pytest.mark.parametrize("task,res", [("translate_ffhq_celeba", 256), ("tiny_cat_dog", 16)])
def test_preprocessors_match_jax(task, res, tmp_path, monkeypatch):
    """ffhq256 on three synthetic 1024 px PNGs (written by the port's codec,
    read by Pillow on the JAX side) and tiny_images, against JAX's."""
    from cyclediffusion_tpu.runtime.config import Args as JArgs
    from cyclediffusion_tpu.runtime.registry import get_preprocessor as jget_preprocessor
    from cyclediffusion_tpu_torch.data.png import write_png
    from cyclediffusion_tpu_torch.runtime.config import Args
    from cyclediffusion_tpu_torch.runtime.registry import get_preprocessor

    root = tmp_path / "data" / "images1024x1024"
    root.mkdir(parents=True)
    yy, xx = np.mgrid[0:1024, 0:1024]
    for i, pick in enumerate((1, 11, 15)):
        rng = np.random.default_rng(pick)
        img = np.stack([(xx * (i + 1) // 5 + yy // 7) % 256, (yy * 3 // 11) % 256,
                        rng.integers(0, 256, (1024, 1024))], -1).astype(np.uint8)
        write_png(str(root / f"{pick:05d}.png"), img)
    monkeypatch.setenv("CYCLEDIFFUSION_DATA_ROOT", str(tmp_path))
    want = _dev(jget_config, jget_preprocessor, JArgs, task)
    got = _dev(get_config, get_preprocessor, Args, task)
    assert len(got["train"]) == len(want["train"]) == 0
    assert len(got["dev"]) == len(want["dev"]) == (3 if res == 256 else 4)
    for i in range(len(want["dev"])):
        a, b = got["dev"][i], want["dev"][i]
        assert a.keys() == b.keys() and a["model_kwargs"] == b["model_kwargs"]
        assert int(a["sample_id"]) == int(b["sample_id"]) == i
        assert a["original_image"].shape == b["original_image"].shape == (res, res, 3)
        assert np.abs(a["original_image"] - b["original_image"]).max() <= 1.0 / 255 + 1e-7


def test_tiny_unpaired_cli_writes_what_jax_writes(tmp_path):
    """The CLI on ``tiny_unpaired_latent.cfg`` writes the files that the JAX
    package's CLI (``main.py``, the same flags) writes on it: the metric
    files and the two grids; the ``empty`` task evaluator writes no CSV and
    no sample PNGs.  ``chip_smoke.py`` phase 10 expects that list.
    eval_samples 2, as ``test_e2e_main.py`` asserts."""
    import json
    import sys

    from cyclediffusion_tpu_torch import main as cli

    sys.path.insert(0, REPO)
    import chip_smoke

    out = str(tmp_path / "out")
    metrics = cli.main(["--cfg", TINY_CFG, "--output_dir", out, "--do_eval",
                        "--per_device_eval_batch_size", "2"], device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert files == ["all_results.json", "eval_results.json",
                     "visualization/eval_000000.png", "visualization/eval_256_000000.png"]
    assert files == chip_smoke.expected_cli_files(2, per_sample=False)
    with open(os.path.join(out, "eval_results.json")) as f:
        assert json.load(f)["eval_samples"] == metrics["eval_samples"] == 2


@pytest.mark.parametrize("name", ["experiments/translate_ffhq256_to_celeba256_latentdiff_ddim_eta01",
                                  "experiments/tiny_unpaired_latent",
                                  "tasks/translate_ffhq_celeba", "tasks/tiny_cat_dog"])
def test_packaged_unpaired_configs_equal_the_jax_packages(name):
    assert get_config(f"{name}.cfg").to_dict() == jget_config(f"{name}.cfg").to_dict()

