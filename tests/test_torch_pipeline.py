"""The port's samplers and its SD translate pipeline against the JAX package,
end to end at fp32 on the tiny text-conditioned core, fed the JAX side's
own noise draws through the port's noise seams.

Tolerances: the samplers on a closed-form eps model agree to 1e-5 relative
to the largest value (same fp32 step arithmetic; the recovered eps divide by
a small sigma, so they reach tens).  Through the tiny core, latents and [0,1] images agree to
2e-4 absolute: each of the chain's UNet calls adds the models' ~1e-5 of
summation-order difference, and the CFG scale amplifies it on decode.  The
round trip (encode, then decode under the same text and scale) recovers x0
to 2e-5 at fp32, the DPM-Encoder's exactness invariant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.ops.schedule import DDIMSchedule as JSchedule
from cyclediffusion_tpu.ops.schedule import make_beta_schedule
from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu.pipelines.latent import LatentDiffusionCore as JCore
from cyclediffusion_tpu.pipelines.latent_text import StochasticTextPipeline as JPipe
from cyclediffusion_tpu.samplers import ddim_decode as jdecode
from cyclediffusion_tpu.samplers import dpm_encode as jencode
from cyclediffusion_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.samplers import ddim_decode, dpm_encode, num_recovered_eps
from cyclediffusion_tpu_torch.text import HashTokenizer
from test_torch_common import fill_flax_tree, max_abs, to_torch

S = 4          # DDIM steps of the tiny translate
ETA = 0.1


def _fake_eps(x, t):
    return 0.1 * x * jnp.cos(t.astype(jnp.float32) / 100.0).reshape(-1, 1, 1, 1)


def _fake_eps_t(x, t):
    return 0.1 * x * torch.cos(t.float() / 100.0).reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("skip,wb", [(0, S + 1), (1, S + 1), (0, 3)])
def test_samplers_match_with_noise_seams(skip, wb):
    betas = make_beta_schedule("linear", 100, 0.00085, 0.012)
    jsched, sched = JSchedule.create(betas, S, ETA), DDIMSchedule.create(betas, S, ETA)
    n = num_recovered_eps(S, wb, skip)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    xT_noise = rng.standard_normal(x0.shape).astype(np.float32)
    post = rng.standard_normal((n,) + x0.shape).astype(np.float32)
    jxT, jeps = jencode(_fake_eps, jsched, jnp.asarray(x0), jax.random.PRNGKey(0),
                        white_box_steps=wb, skip_steps=skip,
                        xT_noise=jnp.asarray(xT_noise), posterior_noises=jnp.asarray(post))
    xT, eps = dpm_encode(_fake_eps_t, sched, to_torch(x0), white_box_steps=wb,
                         skip_steps=skip, xT_noise=to_torch(xT_noise),
                         posterior_noises=to_torch(post))
    assert eps.shape == (n,) + x0.shape
    assert max_abs(xT, jxT) < 1e-5
    assert max_abs(eps, jeps) < 1e-5 * float(jnp.abs(jeps).max())
    refine = S - skip
    full = np.concatenate([np.asarray(jeps),
                           rng.standard_normal((refine - n,) + x0.shape).astype(np.float32)])
    want = jdecode(_fake_eps, jsched, jxT, jnp.asarray(full), skip_steps=skip)
    got = ddim_decode(_fake_eps_t, sched, xT, to_torch(full), skip_steps=skip)
    assert max_abs(got, want) < 1e-5
    if n == refine:      # a full chain replays to x0 exactly
        assert max_abs(got, x0) < 1e-5


def test_decode_draws_fresh_tail_from_generator():
    betas = make_beta_schedule("linear", 100, 0.00085, 0.012)
    sched = DDIMSchedule.create(betas, S, ETA)
    xT = torch.zeros(1, 2, 2, 1)
    outs = [ddim_decode(_fake_eps_t, sched, xT, None, torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert float((outs[0] - outs[2]).abs().max()) > 0


@pytest.fixture(scope="module")
def cores():
    """(JAX core, port core) sharing one filled parameter tree."""
    jspec = JSpec.tiny(cond_kind="clip")
    shell = JCore(jspec, {})
    k = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(shell.unet.init, k, jnp.zeros((1, 8, 8, 4)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 24))),
        "first_stage": jax.eval_shape(shell.first_stage.init, k,
                                      jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 8, 8, 4))),
        "cond": jax.eval_shape(shell.cond_model.init, k, jnp.zeros((1, 8), jnp.int32)),
    }
    tree = fill_flax_tree(shapes, 3)
    jcore = JCore(jspec, jax.tree.map(jnp.asarray, tree))
    return jcore, LatentDiffusionCore.from_jax_params(LatentCoreSpec.tiny(), tree,
                                                      device="cpu")


def _pipe_kwargs(dec_scales):
    return dict(custom_steps=S, eta=ETA, white_box_steps=S + 1, skip_steps=[0, 1],
                encoder_unconditional_guidance_scales=[1.0],
                decoder_unconditional_guidance_scales=dec_scales, n_trials=1)


def _jax_encode_draws(pipe, key, bsz):
    """The draws JAX's StochasticTextPipeline.encode makes under ``key``:
    (VAE posterior noise, per-candidate x_T noises, posterior noises)."""
    spec = pipe.core.spec
    shape = (bsz, spec.image_size, spec.image_size, spec.embed_dim)
    k_vae, k_chains = jax.random.split(key)
    vae = jax.random.normal(k_vae, shape)
    combos = [(t, e, s) for t in range(pipe.n_trials) for e in pipe.enc_scales
              for s in pipe.skip_steps]
    xT_noises, posts = [], []
    for kc, (_, _, skip) in zip(jax.random.split(k_chains, len(combos)), combos):
        n = num_recovered_eps(S, pipe.white_box_steps, skip)
        k_xT, k_post = jax.random.split(kc)
        xT_noises.append(to_torch(jax.random.normal(k_xT, shape)))
        posts.append(to_torch(jax.random.normal(k_post, (n,) + shape)))
    return to_torch(vae), xT_noises, posts


def test_translate_matches_jax(cores):
    jcore, core = cores
    kw = _pipe_kwargs([1.0, 3.0])
    jpipe = JPipe(jcore, JHashTokenizer(96, 16), None, **kw)
    pipe = StochasticTextPipeline(core, HashTokenizer(96, 16), **kw)
    img = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    src, dst = ["a photo of a cat", "a red car"], ["a photo of a dog", "a blue car"]
    key = jax.random.PRNGKey(4)

    jz = jpipe.encode(jnp.asarray(img), src, key)
    vae, xT_noises, posts = _jax_encode_draws(jpipe, key, 2)
    z = pipe.encode(img, src, vae_noise=vae, xT_noises=xT_noises, posterior_noises=posts)
    assert len(z) == len(jz) == 2
    for a, b in zip(z, jz):
        assert a.shape == b.shape
        assert max_abs(a, b) < 2e-4

    jimgs = jpipe.generate(jz, dst, jax.random.PRNGKey(5))
    imgs = pipe.generate(z, dst)
    assert len(imgs) == len(jimgs) == 4          # 2 z x 2 decoder scales
    for a, b in zip(imgs, jimgs):
        assert a.shape == (2, 32, 32, 3) and torch.isfinite(a).all()
        assert max_abs(a, b) < 2e-4


def test_round_trip_recovers_x0(cores):
    """Encode, then decode under the same text and scale: the replay gives
    back the encoded latent x0."""
    _, core = cores
    pipe = StochasticTextPipeline(core, HashTokenizer(96, 16), **_pipe_kwargs([1.0]))
    img = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    text = ["a photo of a cat", "a red car"]
    gen = torch.Generator().manual_seed(0)
    vae = torch.randn(2, 8, 8, 4, generator=gen)
    zs = pipe.encode(img, text, gen, vae_noise=vae)
    x0 = core.encode_first_stage(to_torch(img) * 2.0 - 1.0, vae)
    c, uc = pipe.get_condition(text), pipe.uncond(2)
    for z, skip in zip(zs, pipe.skip_steps):
        xT, eps = pipe._unflatten(z, skip)
        replay = pipe._decode_chains(xT[None], eps[None], c, uc, [1.0], None, skip)[0]
        assert max_abs(replay, x0) < 2e-5


def _jax_fresh_draws(jpipe, jz, key):
    """The fresh noise JAX's ``generate`` draws past each z's stored eps
    (``_decode_chains``): ``normal(keys[i * D + d], (refine - n, B, h, w, c))``
    with ``keys = split(key, len(z) * D)``."""
    D = len(jpipe.dec_scales)
    keys = jax.random.split(key, len(jz) * D)
    draws = []
    for i, z in enumerate(jz):
        skip = jpipe.skip_steps[i % len(jpipe.skip_steps)]
        xT, eps = jpipe._unflatten(z, skip)
        fresh = jpipe.sched.num_steps - skip - eps.shape[0]
        assert fresh > 0
        for d in range(D):
            draws.append(to_torch(jax.random.normal(keys[i * D + d],
                                                    (fresh,) + tuple(xT.shape))))
    return draws


def test_generate_fresh_noise_tail_matches_jax(cores):
    """``white_box_steps < custom_steps + 1``: each z stores fewer eps than
    its chain has steps (2 of 4 at skip 0, 1 of 3 at skip 1), and the rest
    is fresh noise.  Fed JAX's own draws through the ``fresh_noises`` seam,
    the port's images equal JAX's to the image tolerance (2e-4)."""
    jcore, core = cores
    kw = dict(_pipe_kwargs([1.0, 3.0]), white_box_steps=3)
    jpipe = JPipe(jcore, JHashTokenizer(96, 16), None, **kw)
    pipe = StochasticTextPipeline(core, HashTokenizer(96, 16), **kw)
    img = np.random.default_rng(6).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    src, dst = ["a photo of a cat", "a red car"], ["a photo of a dog", "a blue car"]
    jz = jpipe.encode(jnp.asarray(img), src, jax.random.PRNGKey(7))
    assert [num_recovered_eps(S, 3, s) for s in (0, 1)] == [2, 1]
    key = jax.random.PRNGKey(8)
    jimgs = jpipe.generate(jz, dst, key)
    imgs = pipe.generate([to_torch(z) for z in jz], dst,
                         fresh_noises=_jax_fresh_draws(jpipe, jz, key))
    assert len(imgs) == len(jimgs) == 4
    for a, b in zip(imgs, jimgs):
        assert max_abs(a, b) < 2e-4
    # without the seam the tail comes from the generator: same seed, same bits
    outs = [pipe.generate([to_torch(z) for z in jz], dst, torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    for a, b, c in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert float((a - c).abs().max()) > 0
