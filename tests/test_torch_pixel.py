"""The pixel DDPM slice (AFHQ cat/wild -> dog, ``DDPM_DDIM``) of the port
against the JAX package at fp32: the pixel schedule and grids, the pixel
step functions, ``GDResBlock`` with scale-shift norm and in-block
resampling, the tiny improved-DDPM, CompVis and class-conditional UNets,
``pixel_encode`` / ``pixel_generate`` fed JAX's draws, the pipeline's z and
images through the factory, the round trip, the full-width parameter
counts, both checkpoint loaders, the AFHQ preprocessors, the
``translate_to_dog`` evaluator, the task model and the CLI.

Tolerances:

* schedule tables equal (both cast the same float64 numpy to fp32);
* step functions 1e-5 of max|JAX| (fp32 elementwise, the order of a few
  operations differs);
* a module's output 1e-4 absolute (fp32 summation order, as
  ``test_torch_unpaired_latent.py``);
* the sampler on a closed-form eps model: 1e-5 of max|JAX| for x_T, the
  eps stack and the images;
* the pipeline's z: the eta-DDIM eps recovery divides the UNet's eps error
  by c1, so z's bound is the UNet's 1e-4 times the chain's largest
  amplification ``(sqrt(a_next) sqrt(1 - a) / sqrt(a) + c2) / c1``, computed
  from the tiny chain's tables (:func:`_z_tol`: 6.5e-3 on the shipped tiny
  grid); the [0, 1] images 2e-4, as ``test_torch_unpaired_latent.py`` (each
  replay step adds c1 x the z error, c1 <= 6e-3 here);
* images of the preprocessors within 1/255 (Pillow's fixed-point resize, as
  ``test_torch_data.py``); PSNR, SSIM and L2 of the evaluator 1e-6
  relative, FID and KID 1e-3 (over the dog set, which each package
  resizes its own way, within 1/255).
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.convert import torch_import as jti
from cyclediffusion_tpu.models import nn as jnn
from cyclediffusion_tpu.models import unet_ddpm as jud
from cyclediffusion_tpu.models import unet_gd as jug
from cyclediffusion_tpu.ops import schedule as jsched
from cyclediffusion_tpu.ops import steps as jsteps
from cyclediffusion_tpu.pipelines import zoo as jzoo
from cyclediffusion_tpu.pipelines.ddpm_ddim import DDPMDDIMPipeline as JPipe
from cyclediffusion_tpu.pipelines.factory import get_gan_wrapper as jget_gan_wrapper
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu.samplers import pixel_encode as jencode
from cyclediffusion_tpu.samplers import pixel_generate as jgenerate
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.models import unet_ddpm as ud
from cyclediffusion_tpu_torch.models import unet_gd as ug
from cyclediffusion_tpu_torch.models.nn import ddpm_timestep_embedding
from cyclediffusion_tpu_torch.ops import schedule, steps
from cyclediffusion_tpu_torch.pipelines import factory, zoo
from cyclediffusion_tpu_torch.pipelines.ddpm_ddim import DDPMDDIMPipeline
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.samplers import pixel_encode, pixel_generate
from cyclediffusion_tpu_torch.tasks.unsupervised_translation import UnsupervisedTranslation
from cyclediffusion_tpu_torch.tools import pixel_assets
from test_torch_common import REPO, fill_flax_tree, max_abs, to_torch

STEP_TOL = 1e-5
ATOL = 1e-4
IMG_TOL = 2e-4
TINY_CFG = "experiments/tiny_unpaired_translation.cfg"
CAT_CFG = "experiments/translate_afhqcat256_to_afhqdog256_ddim_eta01.cfg"
WILD_CFG = "experiments/translate_afhqwild256_to_afhqdog256_ddim_eta01.cfg"


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, rel):
    scale = max(float(np.abs(np.asarray(want, np.float32)).max()), 1e-6)
    assert max_abs(got, want) <= rel * scale, (max_abs(got, want), scale)


# ---- schedule and steps ---------------------------------------------------- #

@pytest.mark.parametrize("t_0,custom,es", [
    (999, 1000, 850),     # the shipped grid: exact range, cut to es_steps
    (19, 20, 20),         # the tiny config's
    (99, 30, 12),         # int-cast linspace, cut
    (49, 50, 50),
])
def test_pixel_grid_matches_jax(t_0, custom, es):
    seq, nxt = schedule.pixel_timestep_grid(t_0, custom, es)
    jseq, jnxt = jsched.pixel_timestep_grid(t_0, custom, es)
    np.testing.assert_array_equal(seq, jseq)
    np.testing.assert_array_equal(nxt, jnxt)
    assert nxt[0] == -1 and len(seq) == es


def test_pixel_grid_refuses_duplicates_as_jax():
    for mod in (schedule, jsched):
        with pytest.raises(ValueError, match="duplicate"):
            mod.pixel_timestep_grid(9, 20, 20)


@pytest.mark.parametrize("var_type", ["fixedsmall", "fixedlarge"])
def test_pixel_schedule_matches_jax(var_type):
    kw = dict(beta_start=0.0001, beta_end=0.02, num_diffusion_timesteps=1000)
    betas = schedule.get_beta_schedule(**kw)
    np.testing.assert_array_equal(betas, jsched.get_beta_schedule(**kw))
    ps, jps = schedule.PixelSchedule.create(betas, var_type), \
        jsched.PixelSchedule.create(betas, var_type)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_ext", "logvar"):
        got, want = getattr(ps, name), np.asarray(getattr(jps, name))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    t = np.array([-1, 0, 5, 999])
    np.testing.assert_array_equal(ps.a_bar(torch.as_tensor(t)).numpy(),
                                  np.asarray(jps.a_bar(jnp.asarray(t))))
    assert float(ps.a_bar(-1)) == 1.0 and ps.num_timesteps == jps.num_timesteps
    with pytest.raises(ValueError):
        schedule.PixelSchedule.create(betas, "learned")


def _coefs(per_batch: bool):
    ps = jsched.PixelSchedule.create(jsched.get_beta_schedule(
        beta_start=0.0001, beta_end=0.02, num_diffusion_timesteps=1000))
    t = np.array([500, 40]) if per_batch else np.array(500)
    tn = np.array([450, -1]) if per_batch else np.array(450)
    ac, ext = np.asarray(ps.alphas_cumprod), np.asarray(ps.alphas_cumprod_ext)
    live = np.array([450, 30]) if per_batch else tn         # t_next < t, no sentinel
    return (np.asarray(ps.betas)[t], ac[t], ext[tn + 1], np.asarray(ps.logvar)[t],
            ext[live + 1])


@pytest.mark.parametrize("per_batch", [False, True])
def test_pixel_step_functions_match_jax(per_batch):
    """Every pixel step function on the same inputs, with per-step scalars
    and with (B,) coefficients, one of them at the t_next = -1 sentinel
    (but not for the eps recovery, which divides by c1 = 0 there)."""
    bt, at, at_next, logvar, at_next_live = _coefs(per_batch)
    x0, xt, xn, et, noise = (_rand((2, 4, 4, 3), s) for s in range(5))
    var = np.tanh(_rand((2, 4, 4, 3), 5))
    eta = 0.1
    cases = [
        ("learned_logvar", (var, bt, at, at_next), {"ndim": 4}),
        ("pixel_ddim_step", (xt, et, at, at_next, eta, noise), {}),
        ("pixel_compute_eps_ddpm", (xt, xn, et, bt, at, logvar), {}),
        ("pixel_compute_eps_ddim", (xt, xn, et, at, at_next_live, eta), {}),
        ("pixel_sample_xt_next_ddpm", (x0, xt, bt, at, at_next, noise), {}),
        ("pixel_sample_xt_next_ddim", (x0, xt, at, at_next, eta, noise), {}),
        ("pixel_ddpm_step", (xt, et, bt, at, logvar, noise, False), {}),
        ("pixel_ddpm_step", (xt, et, bt, at, logvar, noise, True), {}),
    ]
    for name, args, kw in cases:
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
        want = getattr(jsteps, name)(*jargs, **kw)
        got = getattr(steps, name)(*targs, **kw)
        for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
            assert np.isfinite(np.asarray(w)).all(), name
            _close(g, w, STEP_TOL)


def test_split_model_output_matches_jax():
    et = _rand((2, 4, 4, 6), 0)
    eps, var = steps.split_model_output(torch.as_tensor(et), channels=3)
    jeps, jvar = jsteps.split_model_output(jnp.asarray(et), channels=3)
    np.testing.assert_array_equal(eps.numpy(), np.asarray(jeps))
    np.testing.assert_array_equal(var.numpy(), np.asarray(jvar))
    plain, none = steps.split_model_output(torch.as_tensor(et[..., :3]), channels=3)
    assert none is None and plain.shape == (2, 4, 4, 3)


def test_ddpm_timestep_embedding_matches_jax():
    t = np.array([0, 7, 999])
    for dim in (32, 33):
        got = ddpm_timestep_embedding(torch.as_tensor(t), dim)
        want = jnn.ddpm_timestep_embedding(jnp.asarray(t), dim)
        _close(got, want, STEP_TOL)


# ---- the UNets ------------------------------------------------------------- #

@pytest.mark.parametrize("cin,cout,ss,up,down", [
    (32, 32, True, False, False),
    (32, 64, True, False, False),    # the skip connection's 1x1 conv
    (32, 32, True, True, False),
    (32, 32, True, False, True),
    (32, 32, False, True, False),
    (32, 64, False, False, False),
])
def test_resblock_matches_jax(cin, cout, ss, up, down):
    jmod = jug.GDResBlock(out_channels=cout, use_scale_shift_norm=ss, up=up, down=down)
    x, emb = _rand((2, 8, 8, cin), 0), _rand((2, 64), 1)
    tree = fill_flax_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8, 8, cin)), jnp.zeros((1, 64))), 2)
    want = jmod.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(emb))
    mod = ug.GDResBlock(cin, cout, 64, use_scale_shift_norm=ss, up=up, down=down)
    load_flax_params(mod, tree)
    assert mod.emb_layers[1].out_features == (2 if ss else 1) * cout
    with torch.no_grad():
        got = mod(to_torch(x).permute(0, 3, 1, 2), to_torch(emb)).permute(0, 2, 3, 1)
    side = 16 if up else 4 if down else 8
    assert tuple(got.shape) == tuple(want.shape) == (2, side, side, cout)
    assert max_abs(got, want) < ATOL


def _unet_pair(jmod, mod, res, seed, **init_kw):
    args = [jnp.zeros((1, res, res, 3)), jnp.zeros((1,), jnp.int32)]
    if init_kw.get("y"):
        args += [None, jnp.zeros((1,), jnp.int32)]
    tree = fill_flax_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args), seed)
    load_flax_params(mod, tree)
    mod.eval().requires_grad_(False)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.mark.parametrize("kind", ["improved", "compvis", "class_conditional"])
def test_tiny_unets_match_jax(kind):
    """The tiny improved-DDPM UNet (scale-shift norm, ResBlock resampling,
    2C output), the tiny CompVis DDPM UNet, and a tiny class-conditional
    GDUNet given labels."""
    spec = jzoo.tiny_pixel_spec(16, "compvis" if kind == "compvis" else "improved")
    cfg = spec.unet
    if kind == "class_conditional":
        cfg = dataclasses.replace(cfg, num_classes=10)
    if kind == "compvis":
        jmod, mod = jud.DDPMUNet(cfg), ud.DDPMUNet(ud.DDPMUNetConfig(**dataclasses.asdict(cfg)))
    else:
        jmod, mod = jug.GDUNet(cfg), ug.GDUNet(ug.GDUNetConfig(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(ug.GDUNetConfig)}))
    jtree, _ = _unet_pair(jmod, mod, 16, 3, y=kind == "class_conditional")
    x, t = _rand((2, 16, 16, 3), 4), np.array([3, 77], np.int32)
    y = np.array([1, 9], np.int32)
    if kind == "class_conditional":
        want = jmod.apply(jtree, jnp.asarray(x), jnp.asarray(t), None, jnp.asarray(y))
        with torch.no_grad():
            got = mod(to_torch(x), torch.as_tensor(t, dtype=torch.int64),
                      y=torch.as_tensor(y, dtype=torch.int64))
            other = mod(to_torch(x), torch.as_tensor(t, dtype=torch.int64),
                        y=torch.as_tensor([2, 3]))
        assert max_abs(other, got) > 1e-3
        with pytest.raises(ValueError, match="num_classes"):
            mod(to_torch(x), torch.as_tensor(t, dtype=torch.int64))
    else:
        want = jmod.apply(jtree, jnp.asarray(x), jnp.asarray(t))
        with torch.no_grad():
            got = mod(to_torch(x), torch.as_tensor(t, dtype=torch.int64))
    assert got.shape == want.shape == (2, 16, 16, 6 if kind != "compvis" else 3)
    assert float(jnp.abs(want).max()) > 0.1
    assert max_abs(got, want) < ATOL


def _assert_same_spec(spec, jspec):
    """Equal fields, the UNet's on the port's fields (JAX's also has the
    options no model of the zoo changes: ``dropout``, ``conv_resample``)."""
    got, want = dataclasses.asdict(spec), dataclasses.asdict(jspec)
    ours, theirs = got.pop("unet"), want.pop("unet")
    assert got == want, spec.name
    assert ours == {k: theirs[k] for k in ours}, spec.name
    assert {k: v for k, v in theirs.items() if k not in ours} in (
        {}, {"dropout": 0.0, "conv_resample": True}), spec.name


def test_full_width_zoo_matches_jax(tmp_path):
    """Every zoo entry field by field, and the published parameter counts
    on the meta device against ``jax.eval_shape``: afhq256 93,563,910,
    celeba256 113,673,219, imagenet512 558,997,638; a DiffusionCLIP-style
    AFHQ yml read by both packages gives the zoo's AFHQ entry."""
    assert zoo.PIXEL_ZOO.keys() == jzoo.PIXEL_ZOO.keys()
    for name, spec in zoo.PIXEL_ZOO.items():
        _assert_same_spec(spec, jzoo.PIXEL_ZOO[name])
    for name, count in (("afhqdog256", 93_563_910), ("celeba256", 113_673_219),
                        ("imagenet512", 558_997_638)):
        spec = zoo.PIXEL_ZOO[name]
        with torch.device("meta"):
            n = sum(p.numel() for p in zoo.build_pixel_model(spec).parameters())
        jmod = jzoo.build_pixel_model(jzoo.PIXEL_ZOO[name])
        args = [jnp.zeros((1, spec.resolution, spec.resolution, 3)),
                jnp.zeros((1,), jnp.int32)]
        if spec.unet.__class__ is ug.GDUNetConfig and spec.unet.num_classes:
            args += [None, jnp.zeros((1,), jnp.int32)]
        shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
        assert n == count == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)), name
    for kind in ("improved", "compvis"):
        _assert_same_spec(zoo.tiny_pixel_spec(16, kind), jzoo.tiny_pixel_spec(16, kind))
    yml = tmp_path / "afhq.yml"
    yml.write_text("data:\n    dataset: \"AFHQ\"\n    image_size: 256\n    channels: 3\n"
                   "model:\n    var_type: fixedsmall\n"
                   "diffusion:\n    beta_start: 0.0001\n    beta_end: 0.02\n"
                   "    num_diffusion_timesteps: 1000\n")
    spec = zoo.pixel_spec_from_yml(str(yml), name="afhqcat256")
    _assert_same_spec(spec, jzoo.pixel_spec_from_yml(str(yml), name="afhqcat256"))
    _assert_same_spec(spec, jzoo.PIXEL_ZOO["afhqcat256"])


def test_imagenet512_pipeline_raises_where_jax_fails():
    """The class-conditional ImageNet-512 model builds, but the pipeline
    passes no label: the UNet raises, where the JAX GDUNet's assertion
    fails."""
    spec = dataclasses.replace(
        zoo.PIXEL_ZOO["imagenet512"], resolution=16,
        unet=dataclasses.replace(zoo.tiny_pixel_spec(16).unet, num_classes=10))
    pipe = DDPMDDIMPipeline.random_init(spec, 0, device="cpu", custom_steps=10, es_steps=3,
                                        eta=0.1)
    with pytest.raises(ValueError, match="num_classes"):
        pipe.encode(torch.rand(1, 16, 16, 3))


# ---- the sampler ----------------------------------------------------------- #

def _fake(x, t, learn_sigma, lib):
    """A closed-form model with the improved-DDPM UNets' 2C output: eps,
    then variance values in (-1, 1) (zeros unless ``learn_sigma``)."""
    if lib is jnp:
        c, cat = jnp.cos(t.astype(jnp.float32) / 20.0), jnp.concatenate
    else:
        c, cat = torch.cos(t.float() / 20.0), torch.cat
    c = c.reshape(-1, 1, 1, 1)
    eps = 0.1 * x * c
    return cat([eps, lib.tanh(x + c) if learn_sigma else 0.0 * eps], -1)


@pytest.mark.parametrize("sample_type,learn_sigma,refine", [
    ("ddim", False, 0), ("ddim", False, 4), ("ddpm", False, 3), ("ddpm", True, 3),
    ("ddim", True, 2),
])
def test_pixel_sampler_matches_jax_with_its_draws(sample_type, learn_sigma, refine):
    betas = jsched.get_beta_schedule(beta_start=0.0001, beta_end=0.02,
                                     num_diffusion_timesteps=60)
    jps, ps = jsched.PixelSchedule.create(betas), schedule.PixelSchedule.create(betas)
    seq, nxt = jsched.pixel_timestep_grid(59, 20, 12)
    eta = 0.1 if sample_type == "ddim" else None
    x0 = np.clip(_rand((2, 4, 4, 3), 0), -1, 1)
    n, iters = len(seq) - 1, 2
    xT_noise, post = _rand(x0.shape, 1), _rand((n,) + x0.shape, 2)
    final, q, chain = _rand(x0.shape, 3), _rand((iters,) + x0.shape, 4), _rand(
        (iters, max(refine, 1)) + x0.shape, 5)
    kw = dict(sample_type=sample_type, eta=eta, learn_sigma=learn_sigma)
    jfn = lambda x, t: _fake(x, t, learn_sigma, jnp)              # noqa: E731
    fn = lambda x, t: _fake(x, t, learn_sigma, torch)              # noqa: E731
    jxT, jeps = jencode(jfn, jps, seq, nxt, jnp.asarray(x0), jax.random.PRNGKey(0),
                        xT_noise=jnp.asarray(xT_noise), posterior_noises=jnp.asarray(post), **kw)
    xT, eps = pixel_encode(fn, ps, seq, nxt, to_torch(x0), xT_noise=to_torch(xT_noise),
                           posterior_noises=to_torch(post), **kw)
    _close(xT, jxT, STEP_TOL)
    _close(eps, jeps, STEP_TOL)
    gkw = dict(refine_steps=refine, refine_iterations=iters, **kw)
    want = jgenerate(jfn, jps, seq, nxt, jxT, jeps, jax.random.PRNGKey(1),
                     final_noise=jnp.asarray(final), refine_q_noises=jnp.asarray(q),
                     refine_chain_noises=jnp.asarray(chain[:, :refine]), **gkw)
    got = pixel_generate(fn, ps, seq, nxt, to_torch(np.asarray(jxT)), to_torch(np.asarray(jeps)),
                         final_noise=to_torch(final), refine_q_noises=to_torch(q),
                         refine_chain_noises=to_torch(chain[:, :refine]), **gkw)
    _close(got, want, STEP_TOL)
    drawn = pixel_generate(fn, ps, seq, nxt, xT, eps, torch.Generator().manual_seed(0), **gkw)
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


def test_sampler_refuses_what_jax_refuses():
    ps = schedule.PixelSchedule.create(schedule.get_beta_schedule(
        beta_start=0.0001, beta_end=0.02, num_diffusion_timesteps=20))
    seq, nxt = schedule.pixel_timestep_grid(19, 20, 5)
    x0 = torch.zeros(1, 2, 2, 3)
    fn = lambda x, t: _fake(x, t, False, torch)[..., :3]          # noqa: E731
    with pytest.raises(ValueError, match="eta"):
        pixel_encode(fn, ps, seq, nxt, x0, sample_type="ddim", eta=0.0)
    with pytest.raises(ValueError, match="learn_sigma"):
        pixel_encode(fn, ps, seq, nxt, x0, sample_type="ddpm", learn_sigma=True)
    xT, eps = pixel_encode(fn, ps, seq, nxt, x0, sample_type="ddpm")
    with pytest.raises(ValueError, match="refine_steps"):
        pixel_generate(fn, ps, seq, nxt, xT, eps, sample_type="ddpm", refine_steps=5)


# ---- the pipeline through the factory --------------------------------------- #

def _z_tol(pipe) -> float:
    """The UNet's ATOL times the largest factor by which the eta-DDIM eps
    recovery scales an eps error on ``pipe``'s encode chain."""
    ps, seq, nxt = pipe.ps, pipe.seq, pipe.seq_next
    worst = 0.0
    for t, tn in zip(seq[::-1][:-1], nxt[::-1][:-1]):
        at, an = float(ps.alphas_cumprod[t]), float(ps.a_bar(int(tn)))
        c1 = pipe.eta * np.sqrt((1 - at / an) * (1 - an) / (1 - at))
        c2 = np.sqrt(max(1 - an - c1 ** 2, 0.0))
        worst = max(worst, (np.sqrt(an) * np.sqrt(1 - at) / np.sqrt(at) + c2) / c1)
    return ATOL * worst


@pytest.fixture(scope="module")
def tiny_pipes():
    """(JAX source pipeline with seeded-normal weights, the port's from its
    factory with those weights, the weights) on ``tiny_unpaired_translation.cfg``."""
    jpipe = jget_gan_wrapper(jget_config(TINY_CFG).gan)
    tree = fill_flax_tree(jax.tree.map(np.asarray, jpipe.params), 8)
    jpipe.params = jax.tree.map(jnp.asarray, tree)
    pipe = factory.get_gan_wrapper(get_config(TINY_CFG).gan, device="cpu",
                                   jax_params={"unet": tree})
    return jpipe, pipe, tree


def _jax_draws(jpipe, key_enc, key_dec, shape):
    """The draws of JAX's encode and generate, for the port's seams."""
    n = jpipe.es_steps - 1
    k_xT, k_post = jax.random.split(key_enc)
    keys = jax.random.split(key_dec, 1 + 2 * jpipe.refine_iterations)
    r = jpipe.refine_steps
    return dict(xT_noise=to_torch(jax.random.normal(k_xT, shape)),
                posterior_noises=to_torch(jax.random.normal(k_post, (n,) + shape))), dict(
        final_noise=to_torch(jax.random.normal(keys[0], shape)),
        refine_q_noises=to_torch(np.stack([jax.random.normal(keys[1 + 2 * i], shape)
                                           for i in range(jpipe.refine_iterations)])),
        refine_chain_noises=to_torch(np.stack([jax.random.normal(keys[2 + 2 * i], (r,) + shape)
                                               for i in range(jpipe.refine_iterations)])))


def test_factory_builds_the_tiny_config_as_jax(tiny_pipes):
    jpipe, pipe, _ = tiny_pipes
    for attr in ("sample_type", "custom_steps", "es_steps", "eta", "refine_steps",
                 "refine_iterations", "t_0", "resolution", "latent_dim"):
        assert getattr(pipe, attr) == getattr(jpipe, attr), attr
    np.testing.assert_array_equal(pipe.seq, jpipe.seq)
    assert pipe.dtype == torch.float32 and pipe.device == torch.device("cpu")
    assert pipe.latent_dim == 16 * 16 * 3 * 20
    target = factory.get_gan_wrapper(get_config(TINY_CFG).gan, target=True, device="cpu")
    assert not torch.equal(target.model.out[2].weight, pipe.model.out[2].weight)
    assert target.dtype == torch.float32


@pytest.mark.parametrize("sample_type,eta", [("ddim", 0.1), ("ddpm", None)])
def test_tiny_pipeline_matches_jax(tiny_pipes, sample_type, eta):
    """z, then the [0, 1] image with the refine, the port fed JAX's draws,
    for both sample types; the z bound from the chain's coefficients."""
    jpipe0, pipe0, tree = tiny_pipes
    kw = dict(sample_type=sample_type, custom_steps=20, es_steps=20, eta=eta,
              refine_steps=4, t_0=19)
    jpipe = JPipe(jpipe0.spec, jpipe0.params, **kw)
    pipe = DDPMDDIMPipeline.from_jax_params(pipe0.spec, tree, device="cpu", **kw)
    img = np.random.default_rng(10).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    k_enc, k_dec = jax.random.split(jax.random.PRNGKey(5))
    enc_noise, dec_noise = _jax_draws(jpipe, k_enc, k_dec, (2, 16, 16, 3))
    jz = jpipe.encode(jnp.asarray(img), k_enc)
    z = pipe.encode(img, **enc_noise)
    tol = _z_tol(pipe) if sample_type == "ddim" else ATOL * 10
    if sample_type == "ddim":
        assert 4e-3 < tol < 1e-2
    assert z.shape == jz.shape == (2, pipe.latent_dim)
    assert max_abs(z, jz) < tol
    want = jpipe(jz, k_dec)
    got = pipe(to_torch(np.asarray(jz)), **dec_noise)
    assert got.shape == (2, 16, 16, 3)
    assert max_abs(got, want) < IMG_TOL


def test_pipeline_round_trip_replays_the_encode_trajectory(tiny_pipes):
    """The DPM-Encoder's invariant in the pixel family: the replay on the
    same model (no refine) walks the encode chain's states x_t; its last
    step (t = 0 -> -1) is the model's x0 prediction, so the image misses x0
    by sqrt(1 - a_0) times the eps error at t = 0, not by roundoff."""
    pipe0 = tiny_pipes[1]
    pipe = DDPMDDIMPipeline(pipe0.spec, pipe0.model, custom_steps=20, es_steps=20, eta=0.1,
                            t_0=19, device="cpu")
    seen = {}
    model_fn = pipe._model_fn

    def spy(x, t):
        seen.setdefault(int(t[0]), []).append(x.clone())
        return model_fn(x, t)

    pipe._model_fn = spy
    img = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    out = pipe(pipe.encode(img, torch.Generator().manual_seed(1)))
    err = max(float((xs[1] - xs[0]).abs().max()) for t, xs in seen.items() if t > 0)
    assert sorted(len(v) for t, v in seen.items() if t > 0) == [2] * 19 and len(seen[0]) == 1
    assert err < 1e-5
    x_t0 = seen[0][0]
    a0 = float(pipe.ps.alphas_cumprod[0])
    eps_t0 = model_fn(x_t0, torch.zeros(2, dtype=torch.int64))[..., :3]
    predicted = (x_t0 - eps_t0 * (1 - a0) ** 0.5) / a0 ** 0.5
    assert max_abs(out * 2 - 1, predicted) < 1e-5
    assert max_abs(out, img) < 0.1


def test_pipeline_takes_any_batch_and_refuses_what_jax_refuses(tiny_pipes):
    pipe = tiny_pipes[1]
    for b in (1, 3):
        z = pipe.encode(torch.rand(b, 16, 16, 3), torch.Generator().manual_seed(b))
        assert z.shape == (b, pipe.latent_dim)
        assert pipe(z, torch.Generator().manual_seed(0)).shape == (b, 16, 16, 3)
    with pytest.raises(ValueError, match="16x16"):
        pipe.encode(torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError, match="values per image"):
        pipe.generate(torch.zeros(1, 10))
    for kw in (dict(sample_type="ddim", eta=0.0), dict(sample_type="ddpm", eta=0.1),
               dict(sample_type="x"), dict(custom_steps=30, t_0=19)):
        with pytest.raises(ValueError):
            DDPMDDIMPipeline(pipe.spec, pipe.model, **{"eta": 0.1, "custom_steps": 20,
                                                        "es_steps": 5, **kw}, device="cpu")


# ---- checkpoints ----------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["improved", "compvis"])
def test_checkpoint_loaders_match_jax_converters(kind, tmp_path):
    """A seeded state dict in the published layout (improved-diffusion's
    bare UNet, or CompVis's DDPM with ``temb.dense`` and 1x1 attention
    convs) loads bit for bit, and gives the eps of JAX's converter's tree;
    an unmapped key is refused."""
    spec = zoo.tiny_pixel_spec(16, kind)
    pipe = DDPMDDIMPipeline.random_init(spec, 3, device="cpu", custom_steps=20, es_steps=4,
                                        eta=0.1)
    path = str(tmp_path / "model.pt")
    pixel_assets.write_pixel_checkpoint(pipe.model, path)
    loaded = DDPMDDIMPipeline.from_torch_ckpt(spec, path, device="cpu", custom_steps=20,
                                              es_steps=4, eta=0.1)
    want, got = pipe.model.state_dict(), loaded.model.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    if kind == "compvis":
        assert "temb.dense.0.weight" in got and got["mid.attn_1.q.weight"].ndim == 4
    else:
        assert got["middle_block.1.qkv.weight"].ndim == 3
    sd = jti.load_torch_state_dict(path)
    jtree = (jti.convert_ddpm_unet if kind == "compvis" else jti.convert_gd_unet)(sd)
    jmod = jzoo.build_pixel_model(jzoo.tiny_pixel_spec(16, kind))
    x, t = _rand((2, 16, 16, 3), 6), np.array([5, 60], np.int32)
    jeps = jmod.apply(jtree, jnp.asarray(x), jnp.asarray(t))
    eps = loaded._model_fn(to_torch(x), torch.as_tensor(t, dtype=torch.int64))
    assert max_abs(eps, jeps) < ATOL
    bad = str(tmp_path / "bad.pt")
    torch.save({**torch.load(path), "extra.weight": torch.zeros(1)}, bad)
    with pytest.raises(KeyError, match="extra.weight"):
        DDPMDDIMPipeline.from_torch_ckpt(spec, bad, device="cpu", custom_steps=20,
                                         es_steps=4, eta=0.1)


@pytest.mark.parametrize("cfg", [CAT_CFG, WILD_CFG])
def test_factory_loads_the_shipped_afhq_configs(cfg, tmp_path, monkeypatch):
    """Both AFHQ experiments: the source and target checkpoints from
    ``source_model_path`` / ``target_model_path`` under the checkpoint root
    (tiny-width stand-ins at the published paths), fp32, with the shipped
    chain; without the files the factory raises naming them."""
    monkeypatch.setenv("CYCLEDIFFUSION_CKPT_ROOT", str(tmp_path))
    gan = get_config(cfg).gan
    with pytest.raises(FileNotFoundError, match=os.path.basename(gan.source_model_path)):
        factory.get_gan_wrapper(gan, device="cpu")
    spec = dataclasses.replace(zoo.tiny_pixel_spec(16, "improved"),
                               num_diffusion_timesteps=1000)
    monkeypatch.setitem(zoo.PIXEL_ZOO, gan.source_model_type, spec)
    monkeypatch.setitem(zoo.PIXEL_ZOO, gan.target_model_type, spec)
    written = {}
    for seed, key in enumerate(("source_model_path", "target_model_path")):
        pipe = DDPMDDIMPipeline.random_init(spec, seed, device="cpu", custom_steps=20,
                                            es_steps=4, eta=0.1)
        pixel_assets.write_pixel_checkpoint(pipe.model, str(tmp_path / getattr(gan, key)))
        written[key] = pipe.model
    src = factory.get_gan_wrapper(gan, device="cpu")
    tgt = factory.get_gan_wrapper(gan, target=True, device="cpu")
    for built, key in ((src, "source_model_path"), (tgt, "target_model_path")):
        assert all(torch.equal(a, b) for a, b in zip(built.model.state_dict().values(),
                                                      written[key].state_dict().values()))
        assert (built.sample_type, built.custom_steps, built.es_steps, built.eta) == (
            "ddim", 1000, 850, 0.1)
        assert built.dtype == torch.float32 and built.t_0 == 999
    assert src.refine_steps == gan.refine_steps == tgt.refine_steps
    assert src.latent_dim == 16 * 16 * 3 * 850


# ---- data, evaluator, task, CLI --------------------------------------------- #

def _afhq_pngs(root, split, n, seed):
    from cyclediffusion_tpu_torch.data.png import write_png

    d = root / "stargan-v2" / "data" / "test" / split
    d.mkdir(parents=True)
    yy, xx = np.mgrid[0:512, 0:512]
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        img = np.stack([(xx * (i + 1) // 3 + yy // 5) % 256, (yy * 3 // 7 + i * 40) % 256,
                        rng.integers(0, 256, (512, 512))], -1).astype(np.uint8)
        write_png(str(d / f"flickr_{split}_{i:06d}.png"), img)


@pytest.mark.parametrize("task,split", [("translate_cat_dog", "cat"),
                                        ("translate_wild_dog", "wild")])
def test_afhq_preprocessors_match_jax(task, split, tmp_path, monkeypatch):
    from cyclediffusion_tpu.runtime.config import Args as JArgs
    from cyclediffusion_tpu.runtime.registry import get_preprocessor as jget_preprocessor
    from cyclediffusion_tpu_torch.runtime.config import Args
    from cyclediffusion_tpu_torch.runtime.registry import get_preprocessor

    _afhq_pngs(tmp_path, split, 2, 0)
    monkeypatch.setenv("CYCLEDIFFUSION_DATA_ROOT", str(tmp_path))

    def dev(get_cfg, get_pre, args_cls):
        task_args = get_cfg(f"tasks/{task}.cfg")
        meta = args_cls(raw_data=args_cls(upsample_temp=1))
        pre = get_pre(task_args.preprocess.preprocess_program)(task_args, meta)
        return pre.preprocess({"train": [], "validation": [], "test": []}, "unused")["dev"]

    want, got = dev(jget_config, jget_preprocessor, JArgs), dev(get_config, get_preprocessor,
                                                                Args)
    assert len(got) == len(want) == 2
    for i in range(2):
        a, b = got[i], want[i]
        assert a.keys() == b.keys() and a["model_kwargs"] == b["model_kwargs"]
        assert a["original_image"].shape == (256, 256, 3)
        assert np.abs(a["original_image"] - b["original_image"]).max() <= 1.0 / 255 + 1e-7
    from cyclediffusion_tpu_torch.data.preprocess.afhqcat256 import load_afhq
    from cyclediffusion_tpu_torch.data.png import write_png
    write_png(str(tmp_path / "small.png"), np.zeros((256, 256, 3), np.uint8))
    with pytest.raises(ValueError, match="512x512"):
        load_afhq(str(tmp_path / "small.png"))
    # the release's JPEGs: decoded as Pillow decodes them, then resized as
    # the JAX preprocessor resizes them (to 1 level, as the PNGs above)
    from PIL import Image

    from cyclediffusion_tpu.data.transforms import pil_loader, resize as jresize, to_array
    Image.fromarray(np.asarray(Image.open(tmp_path / "stargan-v2" / "data" / "test" / split
                                          / f"flickr_{split}_000000.png"))).save(
        tmp_path / "cat.jpg", quality=90)
    want = to_array(jresize(pil_loader(str(tmp_path / "cat.jpg")), 256, "bilinear"))
    got = load_afhq(str(tmp_path / "cat.jpg"))
    assert got.shape == want.shape == (256, 256, 3)
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-7
    Image.fromarray(np.zeros((512, 512, 3), np.uint8)).save(tmp_path / "cat.gif")
    with pytest.raises(ValueError, match="GIF"):
        load_afhq(str(tmp_path / "cat.gif"))


def _translate_to_dog(mod, images, out_dir, model):
    ev = mod.Evaluator(None, SimpleNamespace(output_dir=str(out_dir)))
    return ev.evaluate(images, model, None, {}, [{}] * len(images), "eval")


@pytest.mark.parametrize("assets", ["moment", "no dog set"])
def test_translate_to_dog_matches_jax(assets, tmp_path, monkeypatch):
    """PSNR, SSIM, L2, the saved PNGs, and FID / KID against the dog set
    over patch moments (the kind in the key), against JAX's evaluator on
    the same images; without the dog set, no FID / KID."""
    from cyclediffusion_tpu.evaluation import translate_to_dog as jmod
    from cyclediffusion_tpu_torch.data.png import read_png
    from cyclediffusion_tpu_torch.evaluation import translate_to_dog as mod

    images = _dog_eval_setup(tmp_path, monkeypatch, mod, jmod, assets, 3)
    got = _translate_to_dog(mod, images, tmp_path / "port", SimpleNamespace(device="cpu"))
    want = _translate_to_dog(jmod, images, tmp_path / "jax", None)
    keys = {"psnr", "ssim", "l2"} | (set() if assets == "no dog set"
                                     else {"fid_moment_feat", "kid_moment_feat"})
    assert set(got) == set(want) == keys
    for k in got:     # the dog set: each package's resize, within 1/255 of the other's
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6 if k in ("psnr", "ssim", "l2")
                                   else 1e-3, atol=1e-9)
    for i in range(2):
        assert np.array_equal(read_png(str(tmp_path / "port" / "temp_gen" / f"{i}.png")),
                              read_png(str(tmp_path / "jax" / "temp_gen" / f"{i}.png")))


def test_translate_to_dog_with_the_inception_asset(tmp_path, monkeypatch):
    """With ``CYCLEDIFFUSION_INCEPTION_CKPT`` (a seeded pytorch-fid state
    dict) the keys are the untagged ``fid`` / ``kid``, and KID is JAX's
    over the features of JAX's Inception path on the same images (FID's
    2048-d ``sqrtm`` takes seconds; its math is held to JAX's in
    ``test_torch_fid.py``)."""
    from cyclediffusion_tpu.evaluation import fid as jfid
    from cyclediffusion_tpu.evaluation import translate_to_dog as jmod
    from cyclediffusion_tpu_torch.evaluation import translate_to_dog as mod

    path = str(tmp_path / "pt_inception.pth")
    pixel_assets.write_inception_checkpoint(path, seed=0)
    monkeypatch.setenv("CYCLEDIFFUSION_INCEPTION_CKPT", path)
    images = _dog_eval_setup(tmp_path, monkeypatch, mod, jmod, "inception", 2)
    got = _translate_to_dog(mod, images, tmp_path / "port", SimpleNamespace(device="cpu"))
    assert set(got) == {"psnr", "ssim", "l2", "fid", "kid"}
    assert all(np.isfinite(v) for v in got.values())
    gen = np.stack([np.clip(im, 0, 1) for _, im in images])
    ref = np.stack(jmod._REF_CACHE.get("images") or _jax_dogs(jmod))
    kid = jfid.compute_kid_from_features(jfid._inception_features(gen),
                                         jfid._inception_features(ref))
    np.testing.assert_allclose(got["kid"], kid, rtol=1e-3, atol=1e-7)


def _jax_dogs(jmod):
    from cyclediffusion_tpu.data.preprocess.common import resolve_path
    from cyclediffusion_tpu.data.transforms import (
        list_image_files_recursively,
        pil_loader,
        resize,
        to_array,
    )

    return [to_array(resize(pil_loader(f), 256, "bilinear"))
            for f in list_image_files_recursively(resolve_path(jmod.REF_ROOT))]


def _dog_eval_setup(tmp_path, monkeypatch, mod, jmod, assets, n_dogs):
    """A synthetic dog set (unless ``"no dog set"``), fresh reference
    caches, no scorer, and two (original, translated) pairs, the
    translated ones partly out of [0, 1]."""
    from cyclediffusion_tpu_torch.runtime import context

    if assets != "no dog set":
        _afhq_pngs(tmp_path, "dog", n_dogs, 20)
    monkeypatch.setenv("CYCLEDIFFUSION_DATA_ROOT", str(tmp_path))
    if assets != "inception":
        monkeypatch.delenv("CYCLEDIFFUSION_INCEPTION_CKPT", raising=False)
    context.reset()
    monkeypatch.setattr(mod, "_REF_CACHE", {})
    monkeypatch.setattr(jmod, "_REF_CACHE", {})
    rng = np.random.default_rng(0)
    return [(rng.uniform(size=(256, 256, 3)).astype(np.float32),
             rng.uniform(-0.05, 1.05, size=(256, 256, 3)).astype(np.float32))
            for _ in range(2)]


def test_task_model_translates_a_pixel_batch():
    """Source encode, target decode through the tiny pixel config: one
    generator per batch, the same batch twice gives the same images; the
    task exposes its device."""
    model = UnsupervisedTranslation(get_config(TINY_CFG), base_seed=3, device="cpu")
    assert model.resolution == 16 and model.device == torch.device("cpu")
    imgs = [np.random.default_rng(i).uniform(size=(16, 16, 3)).astype(np.float32)
            for i in range(3)]
    (orig, out), loss, losses = model.forward(np.array([4, 5, 6]), original_image=imgs)
    (_, again), _, _ = model(np.array([4, 5, 6]), original_image=imgs)
    assert out.shape == (3, 16, 16, 3) and torch.isfinite(out).all()
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert loss.shape == (3,) and losses == {}


def test_tiny_pixel_cli_writes_what_jax_writes(tmp_path):
    """The CLI on ``tiny_unpaired_translation.cfg`` writes the files that
    the JAX package's CLI (``main.py``, the same flags) writes on it: the
    metric files and the two grids; its task evaluator is ``empty``, so no
    sample PNGs.  ``chip_smoke.py`` expects that list."""
    import json
    import sys

    from cyclediffusion_tpu_torch import main as cli

    sys.path.insert(0, REPO)
    import chip_smoke

    out = str(tmp_path / "out")
    metrics = cli.main(["--cfg", TINY_CFG, "--output_dir", out, "--do_eval", "--seed", "42",
                        "--per_device_eval_batch_size", "2"], device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert files == chip_smoke.expected_cli_files(2, per_sample=False) == [
        "all_results.json", "eval_results.json", "visualization/eval_000000.png",
        "visualization/eval_256_000000.png"]
    with open(os.path.join(out, "eval_results.json")) as f:
        assert json.load(f)["eval_samples"] == metrics["eval_samples"] == 2


@pytest.mark.parametrize("name", [
    "experiments/translate_afhqcat256_to_afhqdog256_ddim_eta01",
    "experiments/translate_afhqwild256_to_afhqdog256_ddim_eta01",
    "experiments/tiny_unpaired_translation", "tasks/translate_cat_dog",
    "tasks/translate_wild_dog"])
def test_packaged_pixel_configs_equal_the_jax_packages(name):
    assert get_config(f"{name}.cfg").to_dict() == jget_config(f"{name}.cfg").to_dict()
