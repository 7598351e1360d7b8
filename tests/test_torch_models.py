"""The port's modules against the JAX package's Flax modules, at fp32 with
the same converted weights and numpy inputs.

Tolerance: 1e-4 absolute on outputs of order 1 — both sides run the same
fp32 arithmetic, but sums (convolutions, matmuls, norms) are taken in
other orders by XLA's and PyTorch's CPU kernels, and the deep models add a
few ulps per layer.  bf16 GroupNorm is held to 2 bf16 ulps at its output
scale (2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.models import autoencoder as jae
from cyclediffusion_tpu.models import nn as jnn
from cyclediffusion_tpu.models import text_encoders as jte
from cyclediffusion_tpu.models import transformer as jtr
from cyclediffusion_tpu.models import unet_gd as jug
from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu_torch.convert.from_jax import (
    flax_to_state_dict,
    load_flax_params,
    module_name,
)
from cyclediffusion_tpu_torch.models import autoencoder as ae
from cyclediffusion_tpu_torch.models import nn as tnn
from cyclediffusion_tpu_torch.models import text_encoders as te
from cyclediffusion_tpu_torch.models import transformer as tr
from cyclediffusion_tpu_torch.models import unet_gd as ug
from cyclediffusion_tpu_torch.models.unet_ddpm import Downsample
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec
from test_torch_common import fill_flax_tree, max_abs, to_torch

ATOL = 1e-4


def _flax(module, *args, seed=1):
    """(filled numpy tree, jnp tree) for ``module`` at ``args``' shapes —
    shapes from ``eval_shape``, so no init program is compiled."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    tree = fill_flax_tree(shapes, seed)
    return tree, jax.tree.map(jnp.asarray, tree)


def _port(module, tree):
    load_flax_params(module, tree)
    return module.eval().requires_grad_(False)


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _nchw(x):
    return to_torch(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("name,want", [
    ("input_blocks_3_0", "input_blocks.3.0"), ("in_layers_2", "in_layers.2"),
    ("to_out_0", "to_out.0"), ("transformer_blocks_0", "transformer_blocks.0"),
    ("up_3_upsample", "up.3.upsample"), ("down_0_block_1", "down.0.block.1"),
    ("mid_attn_1", "mid.attn_1"), ("layer_norm1", "layer_norm1"),
    ("final_layer_norm", "final_layer_norm")])
def test_flax_names_map(name, want):
    assert module_name(name) == want


def test_timestep_embedding_matches():
    t = np.array([0, 1, 17, 999], np.int32)
    for dim in (32, 33, 320):
        want = jnn.gd_timestep_embedding(jnp.asarray(t), dim)
        got = tnn.gd_timestep_embedding(torch.from_numpy(t.astype(np.int64)), dim)
        # an ulp of difference in exp(freq) moves t*freq by up to 6e-5 at
        # t < 1000, and cos/sin with it
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,eps", [(64, 1e-6), (16, 1e-5)])
def test_group_norm_matches(dtype, c, eps):
    x = _rand((2, 5, 6, c), scale=3.0) + 1.5
    jmod = jnn.GroupNorm(num_groups=32, eps=eps)
    tree, jtree = _flax(jmod, jnp.asarray(x))
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = jmod.apply(jtree, jnp.asarray(x).astype(jd))
    mod = _port(tnn.GroupNorm(32, c, eps), tree)
    got = _nhwc(mod(_nchw(x).to(td)))
    assert got.dtype == td
    assert max_abs(got, want) < (2e-2 if dtype == "bfloat16" else ATOL)


def test_downsample_is_asymmetric_pad_valid_conv():
    x = _rand((1, 8, 8, 4))
    mod = Downsample(4)
    out = mod(_nchw(x))
    assert out.shape == (1, 4, 4, 4)
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(_nchw(x), (0, 1, 0, 1)),
                                     mod.conv.weight, mod.conv.bias, stride=2)
    torch.testing.assert_close(out, ref)


def test_spatial_transformer_matches():
    x = _rand((2, 4, 4, 32))
    ctx = _rand((2, 7, 24), seed=1)
    jmod = jtr.SpatialTransformer(heads=4, dim_head=8)
    tree, jtree = _flax(jmod, jnp.asarray(x), jnp.asarray(ctx))
    want = jax.jit(jmod.apply)(jtree, jnp.asarray(x), jnp.asarray(ctx))
    mod = _port(tr.SpatialTransformer(32, 4, 8, context_dim=24), tree)
    got = _nhwc(mod(_nchw(x), to_torch(ctx)))
    assert max_abs(got, want) < ATOL


def test_cross_attention_self_and_cross_match():
    x = _rand((2, 9, 16))
    ctx = _rand((2, 5, 12), seed=1)
    for context in (None, ctx):
        jmod = jtr.CrossAttention(heads=2, dim_head=8)
        args = (jnp.asarray(x),) if context is None else (jnp.asarray(x), jnp.asarray(context))
        tree, jtree = _flax(jmod, *args)
        want = jmod.apply(jtree, *args)
        mod = _port(tr.CrossAttention(16, 2, 8, None if context is None else 12), tree)
        got = mod(to_torch(x), None if context is None else to_torch(context))
        assert max_abs(got, want) < ATOL


def test_gdunet_tiny_matches():
    spec = JSpec.tiny(cond_kind="clip")
    x = _rand((2, 8, 8, 4))
    t = np.array([5, 60], np.int32)
    ctx = _rand((2, 16, 24), seed=1)
    jmod = jug.GDUNet(spec.unet)
    tree, jtree = _flax(jmod, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    want = jax.jit(jmod.apply)(jtree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    mod = _port(ug.GDUNet(LatentCoreSpec.tiny().unet), tree)
    got = mod(to_torch(x), torch.from_numpy(t.astype(np.int64)), to_torch(ctx))
    assert float(jnp.abs(want).max()) > 0.1        # the filled weights reach the output
    assert max_abs(got, want) < ATOL


def test_sd_v1_head_layout():
    """SD-v1 keeps 8 heads at every level: d = 40 / 80 / 160."""
    cfg = ug.GDUNetConfig.sd_v1()
    assert [ug._attn_layout(cfg, ch, 8) for ch in (320, 640, 1280)] == [
        (8, 40), (8, 80), (8, 160)]


def test_autoencoder_tiny_matches():
    cfg = JSpec.tiny(cond_kind="clip").first_stage
    x = _rand((2, 32, 32, 3))
    noise = _rand((2, 8, 8, 4), seed=1)
    jmod = jae.AutoencoderKL(cfg, 4)
    tree, jtree = _flax(jmod, jnp.asarray(x), jnp.asarray(noise))
    mod = _port(ae.AutoencoderKL(LatentCoreSpec.tiny().first_stage, 4), tree)
    want_m = jmod.apply(jtree, jnp.asarray(x), method=jmod.encode_moments)
    got_m = mod.encode_moments(to_torch(x))
    assert max_abs(got_m, want_m) < ATOL
    want = jax.jit(jmod.apply)(jtree, jnp.asarray(x), jnp.asarray(noise))
    got = mod(to_torch(x), to_torch(noise))
    assert max_abs(got, want) < ATOL
    # the posterior's logvar clip at [-30, 20]
    post = ae.DiagonalGaussian(torch.full((1, 1, 1, 8), 50.0))
    assert float(post.logvar.max()) == 20.0


def test_clip_text_encoder_tiny_matches():
    cfg = JSpec.tiny(cond_kind="clip").cond_cfg
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, cfg.max_positions))
    jmod = jte.CLIPTextEncoder(cfg)
    tree, jtree = _flax(jmod, jnp.asarray(ids, jnp.int32))
    want = jmod.apply(jtree, jnp.asarray(ids, jnp.int32))
    mod = _port(te.CLIPTextEncoder(LatentCoreSpec.tiny().cond_cfg), tree)
    got = mod(torch.from_numpy(ids))
    assert max_abs(got, want) < ATOL


def test_causal_bias_uses_finite_minimum():
    bias = te.causal_mask_bias(4)
    assert bias.shape == (1, 1, 4, 4)
    assert float(bias[0, 0, 0, 1]) == torch.finfo(torch.float32).min
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jte.causal_mask_bias(4)))


@pytest.mark.parametrize("which", ["unet", "first_stage", "cond"])
def test_from_jax_maps_every_leaf_of_the_sd_v1_topology(which):
    """SD-v1's module structure (levels, blocks, attention placement, mid
    block, 12 CLIP layers) at narrow widths: every Flax leaf has a target and
    every port parameter is set, with matching shapes."""
    narrow = dict(
        unet=dict(model_channels=32, context_dim=16),
        first_stage=dict(ch=8),
        cond=dict(vocab_size=100, hidden_size=24, num_heads=4, intermediate_size=48),
    )[which]
    jspec, pspec = JSpec.sd_v1(), LatentCoreSpec.sd_v1()
    if which == "unet":
        jcfg, pcfg = (dataclasses.replace(s.unet, **narrow) for s in (jspec, pspec))
        jmod, port = jug.GDUNet(jcfg), ug.GDUNet(pcfg)
        args = (jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 16)))
    elif which == "first_stage":
        jcfg, pcfg = (dataclasses.replace(s.first_stage, **narrow) for s in (jspec, pspec))
        jmod, port = jae.AutoencoderKL(jcfg, 4), ae.AutoencoderKL(pcfg, 4)
        args = (jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 2, 2, 4)))
    else:
        jcfg, pcfg = (dataclasses.replace(s.cond_cfg, **narrow) for s in (jspec, pspec))
        jmod, port = jte.CLIPTextEncoder(jcfg), te.CLIPTextEncoder(pcfg)
        args = (jnp.zeros((1, 77), jnp.int32),)
    tree = fill_flax_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args), 0)
    sd = flax_to_state_dict(tree, port)
    assert len(sd) == len(port.state_dict()) == len(jax.tree.leaves(tree))
