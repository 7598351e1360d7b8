"""Guided sampling and the rest of the latent sampler surface of the port
against the JAX package at fp32: ``ddim_sample``, ``ddim_invert``,
``stochastic_encode`` / ``stochastic_decode``, ``energy_guided_decode``,
the CLIP energy and its gradient through the decoder and the vision tower,
the prior-z energy and the energy factory, the plain-inversion pipeline,
and the kernels' refusal of a gradient.

Both sides get the same weights (a seeded Flax tree, loaded into the port)
and the same noise (JAX's own draws, fed through the port's seams).
Tolerances: on the closed-form toy model (``0.1 x cos(t/100)``) rtol 1e-5 /
atol 1e-6, and the quadratic-energy guided chain 1e-5 of max (the same fp32
step arithmetic); through the tiny core 1e-4 of max (each UNet call adds the
modules' ~1e-5 of summation-order difference); the CLIP energy 1e-5
relative and its gradient 1e-4 of max|g| (the decoder's and the tower's
summation order, then a backward pass through both); the prior energy and
the factory exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.energy import factory as jfactory
from cyclediffusion_tpu.energy import prior_z as jprior
from cyclediffusion_tpu.energy.clean_clip import CLIPScorer as JScorer
from cyclediffusion_tpu.energy.clip_energy import clip_energy_fn as jclip_energy_fn
from cyclediffusion_tpu.models.clip import CLIPConfig as JCLIPConfig
from cyclediffusion_tpu.models.clip import CLIPModel as JCLIPModel
from cyclediffusion_tpu.ops.schedule import DDIMSchedule as JSchedule
from cyclediffusion_tpu.ops.schedule import make_beta_schedule
from cyclediffusion_tpu.pipelines.latentdiff_plain import LatentDiffPlainPipeline as JPlain
from cyclediffusion_tpu.samplers import ddim as jddim
from cyclediffusion_tpu.samplers import energy_guided_decode as jguided
from cyclediffusion_tpu_torch.energy import factory, prior_z
from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer
from cyclediffusion_tpu_torch.energy.clip_energy import clip_energy_fn
from cyclediffusion_tpu_torch.models.clip import CLIPConfig
from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.pipelines.latentdiff_plain import LatentDiffPlainPipeline
from cyclediffusion_tpu_torch.samplers import (
    ddim_decode,
    ddim_invert,
    ddim_sample,
    energy_guided_decode,
    stochastic_decode,
    stochastic_encode,
)
from cyclediffusion_tpu_torch.samplers import guided
from cyclediffusion_tpu_torch.samplers.guided import energy_grad
from test_torch_common import fill_flax_tree, max_abs, tiny_latent_cores, to_torch

CORE_REL = 1e-4


def _fake_eps(x, t):
    return 0.1 * x * jnp.cos(t.astype(jnp.float32) / 100.0).reshape(-1, 1, 1, 1)


def _fake_eps_t(x, t):
    return 0.1 * x * torch.cos(t.float() / 100.0).reshape(-1, 1, 1, 1)


def _scheds(steps, eta, timesteps=1000):
    betas = make_beta_schedule("linear", timesteps, 0.00085, 0.012)
    return JSchedule.create(betas, steps, eta), DDIMSchedule.create(betas, steps, eta)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, rel=None):
    want = np.asarray(want)
    if rel is None:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        assert max_abs(got, want) <= rel * float(np.abs(want).max())


def _sampler_cases(jmodel, model, shape, steps, eta, rel, timesteps=1000):
    """ddim_sample, ddim_invert, stochastic_encode and stochastic_decode on
    one model pair, the port fed JAX's draws."""
    jsched, sched = _scheds(steps, eta, timesteps)
    key = jax.random.PRNGKey(4)
    want = jddim.ddim_sample(jmodel, jsched, shape, key)
    k_init, k_chain = jax.random.split(key)
    got = ddim_sample(model, sched, shape, x_T=to_torch(jax.random.normal(k_init, shape)),
                      eps=to_torch(jax.random.normal(k_chain, (steps,) + shape)))
    _close(got, want, rel)

    x0 = _rand(shape, 5, 0.5)
    _close(ddim_invert(model, sched, to_torch(x0)),
           jddim.ddim_invert(jmodel, jsched, jnp.asarray(x0)), rel)

    t_index = steps // 2
    noise = jax.random.normal(jax.random.PRNGKey(6), shape)
    jxt = jddim.stochastic_encode(jsched, jnp.asarray(x0), t_index, jax.random.PRNGKey(6))
    xt = stochastic_encode(sched, to_torch(x0), t_index, noise=to_torch(noise))
    _close(xt, jxt)
    key = jax.random.PRNGKey(7)
    want = jddim.stochastic_decode(jmodel, jsched, jxt, t_index, key)
    got = stochastic_decode(model, sched, xt, t_index,
                            eps=to_torch(jax.random.normal(key, (t_index,) + shape)))
    _close(got, want, rel)
    return sched


def test_samplers_on_the_toy_model_match_jax():
    sched = _sampler_cases(_fake_eps, _fake_eps_t, (2, 4, 4, 3), 10, 0.1, None)
    # the draws come from the generator when no seam is given
    a, b = (ddim_sample(_fake_eps_t, sched, (1, 2, 2, 1), torch.Generator().manual_seed(s))
            for s in (1, 2))
    assert max_abs(a, b) > 0
    with pytest.raises(ValueError, match="generator"):
        ddim_sample(_fake_eps_t, sched, (1, 2, 2, 1))


@pytest.fixture(scope="module")
def kl_cores():
    return tiny_latent_cores(None, "kl", seed=21)


def test_samplers_on_the_tiny_core_match_jax(kl_cores):
    jcore, core = kl_cores
    _sampler_cases(lambda x, t: jcore.apply_model(x, t), core.apply_model, (2, 8, 8, 4),
                   4, 0.1, CORE_REL, timesteps=100)


def _quadratic(target):
    return lambda x_t, pred_x0, t: ((pred_x0 - target) ** 2).sum()


def test_energy_guided_decode_matches_jax_and_weight_zero_is_plain():
    jsched, sched = _scheds(10, 0.1)
    shape = (1, 8, 8, 3)
    xT = _rand(shape, 8)
    eps = jax.random.normal(jax.random.PRNGKey(9), (10,) + shape)
    want = jguided(_fake_eps, jsched, jnp.asarray(xT), eps, None,
                   _quadratic(jnp.full(shape, 0.7)), guidance_weight=0.5)
    kw = dict(energy_fn=_quadratic(torch.full(shape, 0.7)), guidance_weight=0.5)
    got = energy_guided_decode(_fake_eps_t, sched, to_torch(xT), to_torch(eps), None, **kw)
    _close(got, want, 1e-5)
    plain = ddim_decode(_fake_eps_t, sched, to_torch(xT), to_torch(eps))
    # guidance moves the sample toward the energy's minimum
    assert float(((got - 0.7) ** 2).mean()) < float(((plain - 0.7) ** 2).mean())
    kw["guidance_weight"] = 0.0
    zero = energy_guided_decode(_fake_eps_t, sched, to_torch(xT), to_torch(eps), None, **kw)
    assert torch.equal(zero, plain)


# the JAX package's tiny CLIP (its guided tests'), and one whose input is
# half the decoded 32 px, so the antialiased resize lies on the gradient
CLIP_CONFIGS = {
    "res32": dict(embed_dim=16, image_resolution=32, vision_width=32, vision_layers=1,
                  vision_heads=2, patch_size=8, vocab_size=96, context_length=16,
                  text_width=32, text_layers=1, text_heads=2),
    "res16": dict(embed_dim=16, image_resolution=16, vision_width=32, vision_layers=2,
                  vision_heads=2, patch_size=4, vocab_size=96, context_length=16,
                  text_width=32, text_layers=1, text_heads=2),
}


def _scorers(name):
    jcfg = JCLIPConfig(**CLIP_CONFIGS[name])
    res = jcfg.image_resolution
    shapes = jax.eval_shape(JCLIPModel(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, res, res, 3)), jnp.zeros((1, 16), jnp.int32))
    tree = fill_flax_tree(shapes, 22)
    jscorer = JScorer(jax.tree.map(jnp.asarray, tree), jcfg)
    scorer = CLIPScorer.from_jax_params(tree, CLIPConfig(**CLIP_CONFIGS[name]), device="cpu")
    ids = jnp.zeros((1, 16), jnp.int32).at[0, 0].set(5).at[0, 1].set(95)
    return jscorer, scorer, jscorer.embed_text(ids)


@pytest.mark.parametrize("clip", list(CLIP_CONFIGS))
def test_clip_energy_and_its_gradient_match_jax(kl_cores, clip):
    jcore, core = kl_cores
    jscorer, scorer, text = _scorers(clip)
    jefn = jclip_energy_fn(jcore, jscorer, text, weight_prior=0.1)
    efn = clip_energy_fn(core, scorer, to_torch(text), weight_prior=0.1)
    x_t, p0 = _rand((2, 8, 8, 4), 23), _rand((2, 8, 8, 4), 24)
    t = jnp.zeros((2,), jnp.int32)
    want, jg = jax.jit(jax.value_and_grad(lambda p: jefn(jnp.asarray(x_t), p, t)))(
        jnp.asarray(p0))
    got = float(efn(to_torch(x_t), to_torch(p0), torch.zeros(2, dtype=torch.int64)))
    assert abs(got - float(want)) <= 1e-5 * abs(float(want))
    g = energy_grad(efn, to_torch(x_t), to_torch(p0), torch.zeros(2, dtype=torch.int64))
    assert float(g.abs().max()) > 0
    _close(g, jg, 1e-4)


@pytest.mark.parametrize("clip", list(CLIP_CONFIGS))
def test_clip_energy_gradient_is_reproducible(kl_cores, clip):
    """The same gradient at every call: no step of its backward adds in an
    order that changes (the resize is two products, not F.interpolate's
    scattered backward)."""
    _, core = kl_cores
    _, scorer, text = _scorers(clip)
    efn = clip_energy_fn(core, scorer, to_torch(text), weight_prior=0.1)
    args = (to_torch(_rand((2, 8, 8, 4), 27)), to_torch(_rand((2, 8, 8, 4), 28)),
            torch.zeros(2, dtype=torch.int64))
    first = energy_grad(efn, *args)
    assert float(first.abs().max()) > 0
    assert torch.equal(energy_grad(efn, *args), first)
    assert torch.equal(efn.grad(*args), first)


def test_a_plain_energy_gets_one_wrapper_across_chains(monkeypatch):
    """Two chains with the same plain callable share one ``GraphedEnergy``
    (on the card: one capture, replayed by the second chain); another
    callable gets its own, and a ``GraphedEnergy`` is used as it is."""
    _, sched = _scheds(3, 0.1)
    shape = (1, 4, 4, 3)
    xT, eps = to_torch(_rand(shape, 29)), to_torch(_rand((3,) + shape, 30))
    users = []
    grad = guided.GraphedEnergy.grad
    monkeypatch.setattr(guided.GraphedEnergy, "grad",
                        lambda self, *a: users.append(self) or grad(self, *a))
    energy = _quadratic(torch.full(shape, 0.7))
    other = _quadratic(torch.full(shape, 0.2))
    runs = [energy_guided_decode(_fake_eps_t, sched, xT, eps, None, fn, 0.5)
            for fn in (energy, energy, other)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert len(users) == 9 and len({id(u) for u in users[:6]}) == 1
    assert users[6] is not users[0] and guided.graphed_energy(energy) is users[0]
    wrapped = guided.GraphedEnergy(energy)
    assert guided.graphed_energy(wrapped) is wrapped


def test_tiny_guided_chain_matches_jax(kl_cores):
    """The tiny core's guided replay with the CLIP energy, end to end."""
    jcore, core = kl_cores
    jscorer, scorer, text = _scorers("res16")
    jsched, sched = _scheds(4, 0.1, timesteps=100)
    shape = (1, 8, 8, 4)
    xT, eps = _rand(shape, 25), _rand((4,) + shape, 26)
    want = jguided(lambda x, t: jcore.apply_model(x, t), jsched, jnp.asarray(xT),
                   jnp.asarray(eps), None, jclip_energy_fn(jcore, jscorer, text), 50.0)
    got = energy_guided_decode(core.apply_model, sched, to_torch(xT), to_torch(eps), None,
                               clip_energy_fn(core, scorer, to_torch(text)), 50.0)
    _close(got, want, CORE_REL)
    plain = ddim_decode(core.apply_model, sched, to_torch(xT), to_torch(eps))
    assert max_abs(got, plain) > 1e-4          # the guidance moved z0


def test_prior_energy_and_factory_match_jax():
    # multiples of 1/4 below 4: every square and partial sum is exact in
    # fp32, so the two summation orders must agree to the bit
    z = np.random.default_rng(27).integers(-15, 16, (3, 2, 4, 5)).astype(np.float32) / 4
    np.testing.assert_array_equal(prior_z.prior_z_energy(to_torch(z)).numpy(),
                                  np.asarray(jprior.prior_z_energy(jnp.asarray(z))))
    energy = factory.get_energy("PriorZEnergy")
    assert isinstance(energy, prior_z.PriorZEnergy)
    assert energy.prepare_inputs(z=1, other=2) == {"z": 1}
    np.testing.assert_array_equal(energy(to_torch(z)).numpy(),
                                  np.asarray(jfactory.get_energy("PriorZEnergy")(jnp.asarray(z))))
    with pytest.raises(ValueError):
        factory.get_energy("Nope")
    with pytest.raises(ValueError, match="batch axis"):
        prior_z.prior_z_energy(torch.zeros(3))
    for key in ("PriorZEnergy1", "CLIPEnergy2", "DirPair", "Plain"):
        assert factory.parse_key(key) == jfactory.parse_key(key)


@pytest.mark.parametrize("fs_kind", ["kl", "vq"])
def test_plain_pipeline_matches_jax(fs_kind):
    jcore, core = tiny_latent_cores(None, fs_kind, seed=28)
    jpipe, pipe = JPlain(jcore, custom_steps=5), LatentDiffPlainPipeline(core, custom_steps=5)
    assert pipe.latent_dim == jpipe.latent_dim == 8 * 8 * 4
    img = np.random.default_rng(29).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(30)
    jz = jpipe.encode(jnp.asarray(img), key)
    noise = to_torch(jax.random.normal(key, (2, 8, 8, 4))) if fs_kind == "kl" else None
    z = pipe.encode(img, vae_noise=noise)
    _close(z, jz, CORE_REL)
    want = jpipe(jz, jax.random.PRNGKey(31))
    got = pipe(to_torch(np.asarray(jz)))
    assert got.shape == (2, 32, 32, 3)
    _close(got, want, CORE_REL)
    with pytest.raises(NotImplementedError):
        LatentDiffPlainPipeline(core, custom_steps=5, enforce_class_input=True)
    with pytest.raises(NotImplementedError):
        pipe.encode(img, class_label=0)


def test_decode_first_stage_builds_a_graph_only_for_a_z_that_needs_one(kl_cores):
    core = kl_cores[1]
    z = to_torch(_rand((1, 8, 8, 4), 32))
    img = core.decode_first_stage(z)
    assert img.grad_fn is None and not img.requires_grad
    zg = z.clone().requires_grad_(True)
    img = core.decode_first_stage(zg)
    assert img.grad_fn is not None
    (g,) = torch.autograd.grad(img.sum(), zg)
    assert float(g.abs().max()) > 0
    assert all(not p.requires_grad for m in core.modules() for p in m.parameters())


def _kernel_calls():
    """Each kernel entry point with small CPU inputs, their first tensor
    the one that may require a gradient."""
    r = lambda *s: torch.randn(*s)
    w = lambda: torch.randn(64, 64) * 0.1
    return {
        "flash_attention_bhtd": (fa.flash_attention_bhtd, (r(1, 2, 8, 32), r(1, 2, 8, 32),
                                                           r(1, 2, 8, 32), 0.2)),
        "flash_attention_packed": (fa.flash_attention_packed, (r(1, 8, 64), r(1, 8, 64),
                                                               r(1, 8, 64), 2, 0.2)),
        "qout_self_attention_block": (fa.qout_self_attention_block,
                                      (r(1, 8, 64), w(), r(1, 8, 64), r(1, 8, 64), w(),
                                       r(64), 2)),
        "fused_self_attention_block": (fa.fused_self_attention_block,
                                       (r(1, 8, 64), w(), w(), w(), w(), r(64), 2)),
        "linear": (fa.linear, (r(3, 64), w(), r(64))),
    }


@pytest.mark.parametrize("name", ["flash_attention_bhtd", "flash_attention_packed",
                                  "qout_self_attention_block", "fused_self_attention_block",
                                  "linear"])
def test_kernels_refuse_a_gradient(name):
    fn, args = _kernel_calls()[name]
    with torch.no_grad():
        ref = fn(*args)
    grad_args = (args[0].clone().requires_grad_(True),) + args[1:]
    with torch.no_grad():               # no grad mode: the same call runs
        assert torch.equal(fn(*grad_args), ref)
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
        fn(*grad_args)
    weight_grad = list(args)
    weight_grad[1] = args[1].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*weight_grad)
    assert torch.equal(fn(*args), ref)   # grad mode, nothing requires a gradient
