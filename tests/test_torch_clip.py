"""The port's CLIP scorer against the JAX package's, at fp32.

Towers and DirectionalCLIP scores on a miniature ViT (the JAX factory's
tiny scorer) with one seeded Flax tree: 1e-4, the fp32 towers' summation
order.  ``clip_preprocess``'s bicubic resizes (512 and 256 -> 224, the
shipped energies' sizes, and 64 -> 32) against ``jax.image.resize``: the
port applies JAX's own weight matrices, so what is left is the products'
fp32 rounding.  JAX's CPU einsum lies up to 1.3e-6 from the float64
product on [0, 1] pixels and the port's up to 2e-7 (bound 5e-7);
divided by CLIP's std (>= 0.26) the gap to JAX is up to 4.6e-6 (bound
6e-6, from 1e-5 when the port resized with ``F.interpolate``).  The
gradient is the transposed products: the same at every call, and within
1e-5 of max|g| of ``jax.grad``'s.  OpenAI's state-dict names map to the
same parameters as JAX's converter gives, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.convert import convert_openai_clip
from cyclediffusion_tpu.energy.clean_clip import CLIPScorer as JScorer
from cyclediffusion_tpu.energy.clean_clip import DirectionalCLIP as JDirectionalCLIP
from cyclediffusion_tpu.models.clip import CLIPConfig as JCLIPConfig
from cyclediffusion_tpu.models.clip import CLIPModel as JCLIPModel
from cyclediffusion_tpu.models.clip import clip_preprocess as jclip_preprocess
from cyclediffusion_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from cyclediffusion_tpu_torch.convert.from_jax import flax_to_state_dict, from_openai_state_dict
from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
from cyclediffusion_tpu_torch.data.device_transforms import resize_weight_matrix
from cyclediffusion_tpu_torch.models.clip import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPModel,
    clip_preprocess,
)
from cyclediffusion_tpu_torch.pipelines.factory import TINY_CLIP
from cyclediffusion_tpu_torch.text import HashTokenizer
from test_torch_common import fill_flax_tree, max_abs, to_torch

JTINY = JCLIPConfig(**vars(TINY_CLIP))


@pytest.fixture(scope="module")
def scorers():
    """(JAX scorer, port scorer) sharing one filled parameter tree."""
    shapes = jax.eval_shape(
        JCLIPModel(JTINY).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))
    tree = fill_flax_tree(shapes, 11)
    jscorer = JScorer(jax.tree.map(jnp.asarray, tree), JTINY)
    return jscorer, CLIPScorer.from_jax_params(tree, TINY_CLIP, device="cpu")


SIZES = [(512, 224), (256, 224), (64, 32)]


def _image(size, seed=0):
    return np.random.default_rng(seed).uniform(size=(2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size,res", SIZES + [(224, 224)])
def test_clip_preprocess_matches_jax(size, res):
    img = _image(size)
    want = jclip_preprocess(jnp.asarray(img), res)
    got = clip_preprocess(to_torch(img), res)
    assert max_abs(got, want) <= 6e-6
    if size != res:     # the products against float64 ones of the same matrices
        w = resize_weight_matrix(size, res, "bicubic", True).astype(np.float64)
        rows = np.einsum("bhwc,hy->bywc", img.astype(np.float64), w)
        exact = np.clip(np.einsum("bywc,wx->byxc", rows, w), 0, 1)
        raw = got.numpy() * np.asarray(CLIP_IMAGE_STD) + np.asarray(CLIP_IMAGE_MEAN)
        assert np.abs(raw - exact).max() <= 5e-7


def _preprocess_grad(img, res):
    x = to_torch(img).requires_grad_(True)
    return torch.autograd.grad(clip_preprocess(x, res).square().sum(), x)[0]


@pytest.mark.parametrize("size,res", SIZES)
def test_clip_preprocess_gradient_is_reproducible(size, res):
    img = _image(size, 1)
    first = _preprocess_grad(img, res)
    assert float(first.abs().max()) > 0
    assert torch.equal(_preprocess_grad(img, res), first)


@pytest.mark.parametrize("size,res", SIZES)
def test_clip_preprocess_gradient_matches_jax(size, res):
    img = _image(size, 2)
    want = jax.grad(lambda x: jnp.sum(jclip_preprocess(x, res) ** 2))(jnp.asarray(img))
    assert max_abs(_preprocess_grad(img, res), want) <= 1e-5 * float(jnp.abs(want).max())


def test_towers_match_jax(scorers):
    jscorer, scorer = scorers
    img = np.random.default_rng(1).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    ids = JHashTokenizer(96, 16)(["a photo of a cat", "a dog", ""])
    assert max_abs(scorer.embed_image(img), jscorer.embed_image(jnp.asarray(img))) < 1e-4
    assert max_abs(scorer.embed_text(ids), jscorer.embed_text(ids)) < 1e-4
    x = clip_preprocess(to_torch(img), 32)
    raw = jscorer.model.apply(jscorer.params, jnp.asarray(x.numpy()),
                              method=jscorer.model.encode_image)
    with torch.no_grad():
        assert max_abs(scorer.model.encode_image(x), raw) < 1e-4


def test_directional_clip_matches_jax(scorers):
    jscorer, scorer = scorers
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(2, 48, 48, 3)).astype(np.float32)
    orig = rng.uniform(size=(2, 48, 48, 3)).astype(np.float32)
    src, dst = ["a photo of a cat", "a red car"], ["a photo of a dog", "a blue car"]
    want = JDirectionalCLIP(jscorer, JHashTokenizer(96, 16))(
        jnp.asarray(img), jnp.asarray(orig), src, dst)
    got = DirectionalCLIP(scorer, HashTokenizer(96, 16))(img, orig, src, dst)
    for a, b in zip(got, want):
        assert max_abs(a, b) < 1e-4
    micro = scorer.embed_images_microbatched(to_torch(np.concatenate([img, orig])), 3)
    assert max_abs(micro, scorer.embed_image(np.concatenate([img, orig]))) < 1e-6


def test_text_tower_pools_at_the_first_end_token(scorers):
    """EOT pooling takes the first argmax of the ids, as jnp.argmax does."""
    jscorer, scorer = scorers
    ids = np.zeros((2, 16), np.int32)
    ids[0, :5] = [94, 3, 95, 95, 7]   # the end id twice: the first one pools
    ids[1, :3] = [94, 95, 95]
    assert max_abs(scorer.embed_text(ids), jscorer.embed_text(ids)) < 1e-4


def test_from_openai_state_dict_matches_jax_converter():
    """A random state dict under OpenAI's ``ViT-B-32.pt`` names (tiny
    widths): the port's direct mapping gives exactly the parameters that
    JAX's converter followed by ``from_jax`` gives."""
    cfg, w, tw = TINY_CLIP, TINY_CLIP.vision_width, TINY_CLIP.text_width
    rng = np.random.default_rng(3)
    shapes = {"visual.conv1.weight": (w, 3, cfg.patch_size, cfg.patch_size),
              "visual.class_embedding": (w,),
              "visual.positional_embedding": ((cfg.image_resolution // cfg.patch_size) ** 2 + 1, w),
              "visual.ln_pre.weight": (w,), "visual.ln_pre.bias": (w,),
              "visual.ln_post.weight": (w,), "visual.ln_post.bias": (w,),
              "visual.proj": (w, cfg.embed_dim),
              "token_embedding.weight": (cfg.vocab_size, tw),
              "positional_embedding": (cfg.context_length, tw),
              "ln_final.weight": (tw,), "ln_final.bias": (tw,),
              "text_projection": (tw, cfg.embed_dim), "logit_scale": ()}
    for prefix, width, layers in (("visual.transformer", w, cfg.vision_layers),
                                  ("transformer", tw, cfg.text_layers)):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}."
            shapes.update({
                p + "attn.in_proj_weight": (3 * width, width), p + "attn.in_proj_bias": (3 * width,),
                p + "attn.out_proj.weight": (width, width), p + "attn.out_proj.bias": (width,),
                p + "ln_1.weight": (width,), p + "ln_1.bias": (width,),
                p + "mlp.c_fc.weight": (4 * width, width), p + "mlp.c_fc.bias": (4 * width,),
                p + "mlp.c_proj.weight": (width, 4 * width), p + "mlp.c_proj.bias": (width,),
                p + "ln_2.weight": (width,), p + "ln_2.bias": (width,)})
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    module = CLIPModel(cfg)
    direct = from_openai_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, module)
    via_jax = flax_to_state_dict(convert_openai_clip(sd), module)
    assert set(direct) == set(via_jax) == set(module.state_dict())
    for name in direct:
        torch.testing.assert_close(direct[name], via_jax[name], rtol=0, atol=0)
    del sd["visual.proj"]
    with pytest.raises(ValueError, match="unset parameters"):
        from_openai_state_dict(sd, module)
