"""The encoder-caching fast mode of the port against the JAX package, at
fp32 on the CPU: the UNet's cache round trip, ``cfg_model_fn_pair``, the
cached DPM-Encoder and replay (with the same noises, at ``key_every`` 2
and 3 and a custom key schedule), ``key_every=1`` against the exact chain,
the cached round-trip identity, ``temperature``, and the tiny SD ensemble
with ``fast_key_every=2`` through the factory.

Tolerances: the UNet's eps 1e-4 absolute (``test_torch_models.py``: the same
fp32 arithmetic, sums in other orders); a cached call at the same t equals
the full call bit for bit (the decoder half runs the same operations on
the same features); the samplers on the tiny UNet 1e-4 relative to the
largest value (recovered eps divide by a small sigma); the closed-form
fake models 1e-6; the round trip 2e-5 (``test_torch_pipeline.py``'s); the
ensemble's latents and images 2e-4 and its scores 1e-4
(``test_torch_ensemble.py``'s).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.models import unet_gd as jug
from cyclediffusion_tpu.ops import cfg as jcfg
from cyclediffusion_tpu.ops.schedule import DDIMSchedule as JSchedule
from cyclediffusion_tpu.ops.schedule import make_beta_schedule
from cyclediffusion_tpu.pipelines.factory import get_gan_wrapper as jget_gan_wrapper
from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu.runtime import context as jcontext
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu.samplers import ddim_decode as jdecode
from cyclediffusion_tpu.samplers import ddim_decode_cached as jdecode_cached
from cyclediffusion_tpu.samplers import dpm_encode as jencode
from cyclediffusion_tpu.samplers import dpm_encode_cached as jencode_cached
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.models import unet_gd as ug
from cyclediffusion_tpu_torch.ops import cfg
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.pipelines import factory
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.samplers import (
    ddim_decode,
    ddim_decode_cached,
    dpm_encode,
    dpm_encode_cached,
)
from test_torch_common import REPO, fill_flax_tree, max_abs, to_torch
from test_torch_ensemble import _jax_encode_draws, _jax_scores, _np_tree

ATOL = 1e-4
S = 8           # DDIM steps of the sampler tests
ETA = 0.1


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def unets():
    """(JAX apply, port GDUNet) of the tiny text UNet, one filled tree."""
    jmod = jug.GDUNet(JSpec.tiny(cond_kind="clip").unet)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 6, 24)))
    tree = fill_flax_tree(shapes, 11)
    jtree = jax.tree.map(jnp.asarray, tree)
    mod = ug.GDUNet(LatentCoreSpec.tiny().unet)
    load_flax_params(mod, tree)
    mod.eval().requires_grad_(False)

    def japply(x, t, c, cache=None, return_cache=False):
        return jmod.apply(jtree, x, t, c, encoder_cache=cache, return_cache=return_cache)
    return japply, mod


def _t(values):
    return torch.tensor(values, dtype=torch.int64)


def test_unet_cache_round_trip_matches_jax(unets):
    """A full call returning its cache, then a cached call at the same t:
    the port's equals its full call bit for bit, and both agree with JAX;
    at another t the decoder runs on the same cache with that t's
    embedding, as in JAX.  The cache holds JAX's features (NCHW here)."""
    japply, mod = unets
    x, ctx = _rand((2, 8, 8, 4), 0), _rand((2, 6, 24), 1)
    t, t2 = np.array([7, 40], np.int32), np.array([3, 3], np.int32)
    want, jcache = japply(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), return_cache=True)
    with torch.no_grad():
        full, cache = mod(to_torch(x), _t(t), to_torch(ctx), return_cache=True)
        again, same = mod(to_torch(x), _t(t), to_torch(ctx), encoder_cache=cache,
                          return_cache=True)
        at_t2 = mod(to_torch(x), _t(t2), to_torch(ctx), encoder_cache=cache)
    torch.testing.assert_close(again, full, rtol=0, atol=0)
    assert same is cache
    assert float(jnp.abs(want).max()) > 0.1
    assert max_abs(full, want) < ATOL
    h, hs = cache
    assert len(hs) == len(jcache[1]) == len(mod.input_blocks)
    for got, ref in zip((h,) + hs, (jcache[0],) + tuple(jcache[1])):
        assert max_abs(got.permute(0, 2, 3, 1), ref) < ATOL
    want_t2 = japply(jnp.asarray(x), jnp.asarray(t2), jnp.asarray(ctx), jcache)
    assert max_abs(at_t2, want_t2) < ATOL
    assert max_abs(at_t2, full) > 1e-3          # the timestep reaches the decoder


def _fake(x, t, c, cache):
    """A closed-form ``(eps, cache)`` model: the key call's cache is 2x,
    a cached call reads it in place of x."""
    base = x * 2.0 if cache is None else cache
    tt = t.reshape(-1, 1, 1, 1)
    return base * c[:, :1, :1, None] + 0.01 * tt, (x * 2.0 if cache is None else cache)


@pytest.mark.parametrize("scale", [0.0, 1.0, 5.0, "tensor", "no uncond"])
def test_cfg_model_fn_pair_matches_jax(scale):
    """Single-batch (static 0 or 1, no uncond) and dual ``[uncond; cond]``
    cases: key and reuse outputs and the cache against JAX's wrapper on the
    same closed-form model; the cache carries the dual batch with CFG."""
    rng = np.random.default_rng(3)
    x, x2 = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    uc, c = (rng.standard_normal((2, 5, 6)).astype(np.float32) for _ in range(2))
    t = np.array([3, 9], np.int32)
    if scale == "tensor":
        s_np = np.array([1.0, 5.0], np.float32).reshape(2, 1, 1, 1)
        ts, js = torch.from_numpy(s_np), jnp.asarray(s_np)
    else:
        ts = js = 2.0 if scale == "no uncond" else scale
    no_uc = scale == "no uncond"
    key_fn, reuse_fn = cfg.cfg_model_fn_pair(
        _fake, None if no_uc else to_torch(uc), to_torch(c), ts)
    jkey_fn, jreuse_fn = jcfg.cfg_model_fn_pair(
        lambda x, t, c, cache: _fake(x, t, c, cache), None if no_uc else jnp.asarray(uc),
        jnp.asarray(c), js)
    eps, cache = key_fn(to_torch(x), _t(t))
    jeps, jcache = jkey_fn(jnp.asarray(x), jnp.asarray(t))
    dual = scale in (5.0, "tensor")
    assert cache.shape[0] == (4 if dual else 2)
    assert max_abs(eps, jeps) < 1e-6 and max_abs(cache, jcache) < 1e-6
    got = reuse_fn(to_torch(x2), _t(t + 1), cache)
    want = jreuse_fn(jnp.asarray(x2), jnp.asarray(t + 1), jcache)
    assert max_abs(got, want) < 1e-6


def _samplers(unets, scale):
    """(JAX (fn, key_fn, reuse_fn), port's, JAX and port schedules) of the
    tiny UNet under CFG at ``scale``."""
    japply, mod = unets
    uc, c = _rand((1, 6, 24), 4), _rand((1, 6, 24), 5)

    def jraw(x, t, ctx):
        return japply(x, t, ctx)

    def jraw_cached(x, t, ctx, cache):
        return japply(x, t, ctx, cache, return_cache=True)

    def raw(x, t, ctx):
        return mod(x, t, ctx)

    def raw_cached(x, t, ctx, cache):
        return mod(x, t, ctx, encoder_cache=cache, return_cache=True)

    jfns = (jcfg.cfg_model_fn(jraw, jnp.asarray(uc), jnp.asarray(c), scale),
            *jcfg.cfg_model_fn_pair(jraw_cached, jnp.asarray(uc), jnp.asarray(c), scale))
    fns = (cfg.cfg_model_fn(raw, to_torch(uc), to_torch(c), scale),
           *cfg.cfg_model_fn_pair(raw_cached, to_torch(uc), to_torch(c), scale))
    betas = make_beta_schedule("linear", 100, 0.00085, 0.012)
    return jfns, fns, JSchedule.create(betas, S, ETA), DDIMSchedule.create(betas, S, ETA)


def _rel(got, want) -> float:
    return max_abs(got, want) / float(np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("key_every,key_steps", [(2, None), (3, None),
                                                 (0, [0, 3, 6])])
def test_cached_samplers_match_jax(unets, key_every, key_steps):
    """``dpm_encode_cached`` and ``ddim_decode_cached`` on the tiny UNet at
    CFG 3, the same x_T and posterior noises and the same stored eps as
    JAX's; ``key_steps`` indexes the key steps of a custom schedule."""
    (_, jkey, jreuse), (_, key, reuse), jsched, sched = _samplers(unets, 3.0)
    ks = None
    if key_steps is not None:
        ks = np.zeros(S, bool)
        ks[key_steps] = True
    x0, xT_noise = _rand((1, 8, 8, 4), 6), _rand((1, 8, 8, 4), 7)
    post = _rand((S, 1, 8, 8, 4), 8)
    jxT, jeps = jencode_cached(jkey, jreuse, jsched, jnp.asarray(x0), jax.random.PRNGKey(0),
                               white_box_steps=S + 1, key_every=key_every,
                               xT_noise=jnp.asarray(xT_noise),
                               posterior_noises=jnp.asarray(post), key_steps=ks)
    xT, eps = dpm_encode_cached(key, reuse, sched, to_torch(x0), white_box_steps=S + 1,
                                key_every=key_every, xT_noise=to_torch(xT_noise),
                                posterior_noises=to_torch(post), key_steps=ks)
    assert max_abs(xT, jxT) < 1e-6
    assert _rel(eps, jeps) < 1e-4
    stored = _rand((S, 1, 8, 8, 4), 9)
    want = jdecode_cached(jkey, jreuse, jsched, jxT, jnp.asarray(stored), key_every=key_every,
                          key_steps=ks)
    got = ddim_decode_cached(key, reuse, sched, xT, to_torch(stored), key_every=key_every,
                             key_steps=ks)
    assert _rel(got, want) < 1e-4


def test_key_every_1_is_the_exact_chain(unets):
    """Every step a key step: the cached chains run the exact chains'
    operations and give their bits."""
    _, (fn, key, reuse), _, sched = _samplers(unets, 3.0)
    x0, noise = to_torch(_rand((1, 8, 8, 4), 10)), to_torch(_rand((1, 8, 8, 4), 11))
    post = to_torch(_rand((S, 1, 8, 8, 4), 12))
    kw = dict(white_box_steps=S + 1, xT_noise=noise, posterior_noises=post)
    xT, eps = dpm_encode(fn, sched, x0, **kw)
    xT_c, eps_c = dpm_encode_cached(key, reuse, sched, x0, key_every=1, **kw)
    torch.testing.assert_close(xT_c, xT, rtol=0, atol=0)
    torch.testing.assert_close(eps_c, eps, rtol=0, atol=0)
    torch.testing.assert_close(ddim_decode_cached(key, reuse, sched, xT, eps, key_every=1),
                               ddim_decode(fn, sched, xT, eps), rtol=0, atol=0)


@pytest.mark.parametrize("key_every", [2, 3])
def test_cached_round_trip_identity(unets, key_every):
    """Encode and replay with the same key schedule under the same text and
    scale: both chains visit the same x_t, so the key steps make the same
    caches and the replay gives back x0 (the DPM-Encoder's invariant), while
    the eps differ from the exact chain's."""
    _, (fn, key, reuse), _, sched = _samplers(unets, 1.0)
    x0 = to_torch(_rand((1, 8, 8, 4), 13))
    gen = torch.Generator().manual_seed(key_every)
    xT, eps = dpm_encode_cached(key, reuse, sched, x0, gen, white_box_steps=S + 1,
                                key_every=key_every)
    replay = ddim_decode_cached(key, reuse, sched, xT, eps, key_every=key_every)
    assert max_abs(replay, x0) < 2e-5
    _, eps_exact = dpm_encode(fn, sched, x0, torch.Generator().manual_seed(key_every),
                              white_box_steps=S + 1)
    assert max_abs(eps, eps_exact) > 1e-3


def test_key_steps_must_cover_the_chain(unets):
    _, (_, key, reuse), _, sched = _samplers(unets, 1.0)
    with pytest.raises(ValueError, match="key_steps has 3 entries for a 8-step chain"):
        ddim_decode_cached(key, reuse, sched, torch.zeros(1, 8, 8, 4), None,
                           torch.Generator().manual_seed(0), key_every=0,
                           key_steps=[True, False, True])


def _fake_eps(x, t):
    return 0.1 * x * jnp.cos(t.astype(jnp.float32) / 100.0).reshape(-1, 1, 1, 1)


def _fake_eps_t(x, t):
    return 0.1 * x * torch.cos(t.float() / 100.0).reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("cached", [False, True])
def test_temperature_matches_jax(cached):
    """``temperature`` 0.7 scales the stored noise on replay and divides
    the recovered eps on encode, as JAX's samplers do (closed-form eps
    model; the cached variant with a cache that is the input itself)."""
    betas = make_beta_schedule("linear", 100, 0.00085, 0.012)
    jsched, sched = JSchedule.create(betas, S, ETA), DDIMSchedule.create(betas, S, ETA)
    x0, noise = _rand((2, 4, 4, 3), 14), _rand((2, 4, 4, 3), 15)
    post, stored = _rand((S, 2, 4, 4, 3), 16), _rand((S, 2, 4, 4, 3), 17)
    temp = 0.7
    if cached:
        jfns = (lambda x, t: (_fake_eps(x, t), x), lambda x, t, c: _fake_eps(c, t))
        fns = (lambda x, t: (_fake_eps_t(x, t), x), lambda x, t, c: _fake_eps_t(c, t))
        jenc = lambda *a, **k: jencode_cached(*jfns, *a, key_every=2, **k)
        jdec = lambda *a, **k: jdecode_cached(*jfns, *a, key_every=2, **k)
        enc = lambda *a, **k: dpm_encode_cached(*fns, *a, key_every=2, **k)
        dec = lambda *a, **k: ddim_decode_cached(*fns, *a, key_every=2, **k)
    else:
        jenc = lambda *a, **k: jencode(_fake_eps, *a, **k)
        jdec = lambda *a, **k: jdecode(_fake_eps, *a, **k)
        enc = lambda *a, **k: dpm_encode(_fake_eps_t, *a, **k)
        dec = lambda *a, **k: ddim_decode(_fake_eps_t, *a, **k)
    jxT, jeps = jenc(jsched, jnp.asarray(x0), jax.random.PRNGKey(0), white_box_steps=S + 1,
                     temperature=temp, xT_noise=jnp.asarray(noise),
                     posterior_noises=jnp.asarray(post))
    xT, eps = enc(sched, to_torch(x0), white_box_steps=S + 1, temperature=temp,
                  xT_noise=to_torch(noise), posterior_noises=to_torch(post))
    assert max_abs(xT, jxT) < 1e-6 and _rel(eps, jeps) < 1e-5
    want = jdec(jsched, jxT, jnp.asarray(stored), temperature=temp)
    got = dec(sched, xT, to_torch(stored), temperature=temp)
    assert max_abs(got, want) < 1e-5
    assert max_abs(got, dec(sched, xT, to_torch(stored))) > 1e-3


FAST_CFG = os.path.join(REPO, "cyclediffusion_tpu", "config", "experiments",
                        "tiny_text_translation_fast.cfg")
SRC, DST = ["a photo of a cat", "a red car"], ["a photo of a dog", "a blue car"]


@pytest.fixture(scope="module")
def fast_pipes():
    """(JAX pipeline, port pipeline with its weights) from the tiny fast
    config, each built by its own factory."""
    saved = {v: os.environ.pop(v, None) for v in ("CYCLEDIFFUSION_CLIP_CKPT",
                                                  "CYCLEDIFFUSION_CLIP_BPE",
                                                  "CYCLEDIFFUSION_FOLDED_ATTN")}
    jcontext.reset()
    context.reset()
    jpipe = jget_gan_wrapper(jget_config(FAST_CFG).gan)
    jcontext.reset()
    params = {"core": _np_tree(jpipe.core.params),
              "clip": _np_tree(jpipe.directional_clip.scorer.params)}
    pipe = factory.get_gan_wrapper(get_config(FAST_CFG).gan, device="cpu", jax_params=params)
    yield jpipe, pipe
    context.reset()
    os.environ.update({k: v for k, v in saved.items() if v is not None})


def test_tiny_fast_ensemble_matches_jax(fast_pipes):
    """``fast_key_every=2`` on both chains: the z-ensemble (fed JAX's noise
    draws), the decoded candidates, the DirectionalCLIP scores and
    ``forward``'s winner against JAX's fast pipeline; every UNet call goes
    through the cached surface, half of them as reuse calls."""
    jpipe, pipe = fast_pipes
    assert pipe.fast_key_every == jpipe.fast_key_every == 2
    calls = {"key": 0, "reuse": 0}
    cached = pipe.core.apply_model_cached

    def counted(x, t, c, encoder_cache=None):
        calls["key" if encoder_cache is None else "reuse"] += 1
        return cached(x, t, c, encoder_cache)

    pipe.core.apply_model_cached = counted
    try:
        img = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
        key = jax.random.PRNGKey(4)
        jz = jpipe.encode(jnp.asarray(img), SRC, key)
        vae, xT_noises, posts = _jax_encode_draws(jpipe, key, 2)
        z = pipe.encode(img, SRC, vae_noise=vae, xT_noises=xT_noises, posterior_noises=posts)
        assert len(z) == len(jz) == 4
        for a, b in zip(z, jz):
            assert max_abs(a, b) < 2e-4
        jimgs = jpipe.generate(jz, DST, jax.random.PRNGKey(5))
        imgs = pipe.generate(z, DST)
        assert len(imgs) == len(jimgs) == 8
        for a, b in zip(imgs, jimgs):
            assert max_abs(a, b) < 2e-4
        scores, best = pipe.rank(imgs, to_torch(img), SRC, DST)
        assert max_abs(scores, _jax_scores(jpipe, jimgs, jnp.asarray(img))) < 1e-4
        best_img, _ = pipe.forward(z, img, SRC, DST)
    finally:
        del pipe.core.apply_model_cached
    for b in range(2):
        torch.testing.assert_close(best_img[b], imgs[int(best[b])][b], rtol=0, atol=0)
    # one chain per skip (0 and 2 of 6 steps: 6 and 4 UNet calls) in each of
    # encode, generate and forward's generate; key calls at even steps
    chains = [6, 4] * 3
    assert calls == {"key": sum((k + 1) // 2 for k in chains),
                     "reuse": sum(k // 2 for k in chains)}
