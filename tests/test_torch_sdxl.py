"""SDXL base on the port's edit path against the benchmark's plain float32
reference (``cdbench/reference/sdxl.py``), at a tiny SDXL-shaped size on the
CPU with seeded weights drawn under the published names: the UNet (depth by
level, linear projections, ``label_emb``), each text tower's context and the
pooled output, the 2816-layout vector, the unconditional branch's zeros, and
one ``StochasticTextPipeline`` encode and generate.  Each fault the
comparison must catch (a tanh GELU, the last CLIP layer, ``ln_final`` on the
context, conv projections, an encoded empty prompt) is planted and caught.

Also the shared path: a plain-tensor conditioning through ``ops/cfg.py`` and
the pipeline gives what the code before the conditioning tree gave, bit for
bit (a transcription of that code), and SDXL is built by name."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cdbench import compare
from cdbench.drivers import edit
from cdbench.reference import sampling
from cdbench.registry import family
from cdbench.tests.test_cdbench_sdxl import TINY_SDXL
from cdbench.weights import draw_state_dict
from cyclediffusion_tpu_torch.models import text_encoders
from cyclediffusion_tpu_torch.ops import cfg as cfg_ops
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.runtime import profiling

SEED = 2 ** 31 + 77
# fp32 on the CPU against the fp32 reference: only the order of the sums
# differs (~2e-7 relative); every planted fault below misses by 1e-4 or more
TOL = 1e-5
TEXTS = ["a photo of a red cat", "an oil painting of an old boat"]
MIX = {"driver": "edit", "images_per_request": 2, "steps": 10, "white_box_steps": 11,
       "eta": 0.1, "skip": 5, "encoder_scale": 1, "decoder_scale": 5, "candidate_chunk": 4}


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    cfg = TINY_SDXL
    sd = draw_state_dict(cfg, SEED, "cpu", torch.float32)
    ref = family(cfg, "reference")
    parts = ref.build_parts(cfg["arch"], "cpu")
    for prefix, module in parts.values():
        module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                if k.startswith(prefix)}, strict=True)
    core = family(cfg, "cores").load_core(cfg, sd, "cpu", torch.float32)
    return cfg, sd, ref, parts, core


def ids_of(cfg, texts):
    t = cfg["arch"]["text_l"]
    return sampling.hash_tokens(texts, t["vocab_size"], t["context_length"])


def gap(a, b) -> float:
    return compare.worst_rel_rms(a, b)


def unet_inputs(cfg, ref, parts):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 8, 8, 4), generator=g)
    t = torch.tensor([3, 41, 77, 99])
    return x, t, ref.condition(cfg, parts, TEXTS + ["", TEXTS[0]], "cpu")


# ---- the port against the reference ------------------------------------------- #

def test_unet_eps(setup):
    cfg, _, ref, parts, core = setup
    x, t, cond = unet_inputs(cfg, ref, parts)
    assert gap(core.apply_model(x, t, cond), ref.eps(cfg, parts, x, t, cond)) < TOL


def test_each_tower_and_the_pooled_output(setup):
    cfg, _, ref, parts, core = setup
    ids = torch.as_tensor(ids_of(cfg, TEXTS))
    layer = cfg["arch"]["text_l"]["layer_idx"]
    assert gap(core.cond_model.clip_l(ids), ref.clip_hidden(parts["text_l"][1], ids, layer)) < TOL
    got, want = core.cond_model.open_clip(ids), parts["text_g"][1](ids)
    assert gap(got[0], want[0]) < TOL and gap(got[1], want[1]) < TOL


def test_the_conditioning_and_its_vector_layout(setup):
    cfg, _, ref, parts, core = setup
    got = core.get_learned_conditioning(ids_of(cfg, TEXTS))
    want = ref.condition(cfg, parts, TEXTS, "cpu")
    assert set(got) == {"context", "vector"} and gap(got, want) < TOL
    a = cfg["arch"]
    d, pooled = a["size_embed_dim"], a["text_g"]["embed_dim"]
    assert got["vector"].shape == (2, pooled + 6 * d) == (2, a["unet"]["adm_in_channels"])
    # pooled first, then each size number's [cos, sin] embedding in the order
    # original (h, w), crop (top, left), target (h, w)
    freqs = np.exp(-math.log(10000.0) * np.arange(d // 2) / (d // 2))
    for i, value in enumerate(a["micro_conditioning"]):
        block = got["vector"][:, pooled + i * d:pooled + (i + 1) * d].numpy()
        want_block = np.concatenate([np.cos(value * freqs), np.sin(value * freqs)])
        np.testing.assert_allclose(block, np.broadcast_to(want_block, block.shape), atol=1e-6)
    assert torch.equal(got["vector"][:, :pooled], core.cond_model.open_clip(
        torch.as_tensor(ids_of(cfg, TEXTS)))[1])


def test_the_unconditional_branch_is_zeros_and_encodes_nothing(setup, monkeypatch):
    cfg, _, ref, parts, core = setup

    def refuse(*args):
        raise AssertionError("a tower ran for the unconditional branch")

    monkeypatch.setattr(core.cond_model, "forward", refuse)
    profiling.reset()
    with profiling.recording():
        got = core.get_learned_conditioning(ids_of(cfg, [""] * 3), unconditional=True)
    rec = profiling.recorded()
    profiling.reset()
    assert rec.counts["cond.zero_rows"] == 3
    assert not any(name == "graph.text" for name, _ in rec.spans)
    assert rec.spans[("cond.vector", None)].rows == 3
    pooled = cfg["arch"]["text_g"]["embed_dim"]
    assert not got["context"].any() and not got["vector"][:, :pooled].any()
    assert gap(got, ref.condition(cfg, parts, [""] * 3, "cpu")) == 0.0
    want_sizes = ref.size_embedding(cfg, "cpu").expand(3, -1)
    assert torch.equal(got["vector"][:, pooled:], want_sizes)


def test_encode_and_generate(setup):
    cfg, _, ref, parts, core = setup
    req = edit.make_request(cfg, MIX, SEED, 0, "cpu")
    pipe = StochasticTextPipeline(
        core, family(cfg, "cores").tokenizer(cfg), None, custom_steps=MIX["steps"],
        eta=MIX["eta"], white_box_steps=MIX["white_box_steps"], skip_steps=[MIX["skip"]],
        encoder_unconditional_guidance_scales=[MIX["encoder_scale"]],
        decoder_unconditional_guidance_scales=[MIX["decoder_scale"]], n_trials=1)
    profiling.reset()
    with profiling.recording():
        z = pipe.encode(req["images"], req["source"], vae_noise=req["vae_noise"],
                        xT_noises=[req["xT_noise"]],
                        posterior_noises=[req["posterior_noises"]])
        images = pipe.generate(z, req["target"])
    rec = profiling.recorded()
    profiling.reset()
    want = edit.reference_outputs(cfg, MIX, parts, req)
    assert compare.rel_rms(z[0], want["z"]) < 10 * TOL     # eps recovery divides by sigma
    assert compare.rel_rms(images[0], want["images"]) < TOL
    # two encoded prompts a phase, the unconditional rows zeros
    assert rec.counts["cond.zero_rows"] == 4
    assert sum(r.rows for (name, _), r in rec.spans.items() if name == "graph.text") == 4


# ---- the faults the comparison catches ------------------------------------------ #

def _tanh_openclip_block(self, x, bias):
    a = self.attn
    q, k, v = F.linear(self.ln_1(x), a.in_proj_weight, a.in_proj_bias).chunk(3, dim=-1)
    x = x + a.out_proj(text_encoders.masked_multi_head_attention(q, k, v, self.heads, bias))
    return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x)), approximate="tanh"))


def _ln_final_context(self, input_ids):
    _, pooled = OPEN_CLIP_FORWARD(self, input_ids)
    t = input_ids.shape[1]
    x = self.token_embedding(input_ids) + self.positional_embedding[None, :t]
    bias = text_encoders.causal_mask_bias(t, x.dtype, x.device)
    for block in self.transformer.resblocks[:-1]:
        x = block(x, bias)
    return self.ln_final(x), pooled


OPEN_CLIP_FORWARD = text_encoders.OpenCLIPTextEncoder.forward


def test_planted_faults_miss_the_reference(setup, monkeypatch):
    cfg, _, ref, parts, core = setup
    x, t, cond = unet_inputs(cfg, ref, parts)
    ids = ids_of(cfg, TEXTS)
    want_eps = ref.eps(cfg, parts, x, t, cond)
    want_cond = ref.condition(cfg, parts, TEXTS, "cpu")

    # GEGLU's GELU in its tanh form
    gegl = [m for m in core.unet.modules() if hasattr(m, "approximate")]
    assert gegl and all(m.approximate == "none" for m in gegl)
    for m in gegl:
        monkeypatch.setattr(m, "approximate", "tanh")
    assert gap(core.apply_model(x, t, cond), want_eps) > TOL
    monkeypatch.undo()
    # OpenCLIP's GELU in its tanh form
    with monkeypatch.context() as m:
        m.setattr(text_encoders.OpenCLIPBlock, "forward", _tanh_openclip_block)
        assert gap(core.get_learned_conditioning(ids), want_cond) > TOL
    # CLIP ViT-L/14's last layer in place of hidden_states[11]
    with monkeypatch.context() as m:
        m.setattr(core.cond_model.clip_l, "hidden_layer", cfg["arch"]["text_l"]["layers"])
        assert gap(core.get_learned_conditioning(ids), want_cond) > TOL
    # ln_final on the penultimate context
    with monkeypatch.context() as m:
        m.setattr(text_encoders.OpenCLIPTextEncoder, "forward", _ln_final_context)
        assert gap(core.get_learned_conditioning(ids), want_cond) > TOL
    # an encoded empty prompt in place of the zeros
    empty = ids_of(cfg, [""] * 2)
    assert gap(core.get_learned_conditioning(empty), ref.condition(cfg, parts, [""] * 2, "cpu")) \
        > 1.0
    # the faithful port, after the faults are taken out
    assert gap(core.apply_model(x, t, cond), want_eps) < TOL
    assert gap(core.get_learned_conditioning(ids), want_cond) < TOL


def test_conv_projections_refuse_the_published_weights(setup):
    cfg, sd, *_ = setup
    conv = dict(cfg, arch=dict(cfg["arch"], unet=dict(cfg["arch"]["unet"],
                                                      use_linear_in_transformer=False)))
    with pytest.raises(ValueError, match="proj_in"):
        family(cfg, "cores").load_core(conv, sd, "cpu", torch.float32)


# ---- the shared path, with a plain tensor ---------------------------------------- #

def _parent_make_cfg_combine(uncond, cond, scale):
    """``ops.cfg.make_cfg_combine`` before the conditioning tree."""
    c_in = torch.cat([uncond, cond], dim=0)

    def combine(out):
        e_uncond, e_cond = torch.chunk(out, 2, dim=0)
        return e_uncond + scale * (e_cond - e_uncond)

    return c_in, combine


def test_a_plain_tensor_through_cfg_is_the_parents():
    g = torch.Generator().manual_seed(1)
    uc, c = (torch.randn((3, 5, 7), generator=g) for _ in range(2))
    out = torch.randn((6, 4, 4, 2), generator=g)
    scale = torch.randn((3, 1, 1, 1), generator=g)
    got_c, got_combine = cfg_ops.make_cfg_combine(uc, c, scale)
    want_c, want_combine = _parent_make_cfg_combine(uc, c, scale)
    assert torch.equal(got_c, want_c) and torch.equal(got_combine(out), want_combine(out))
    assert torch.equal(cfg_ops.repeat_rows(uc, 4), uc.repeat(4, 1, 1))
    tree = cfg_ops.cat_rows({"a": uc, "b": c[:, 0]}, {"a": c, "b": uc[:, 0]})
    assert torch.equal(tree["a"], want_c) and tree["b"].shape == (6, 7)


class _ParentPipeline(StochasticTextPipeline):
    """The pipeline's conditioning code before the tree."""

    def uncond(self, batch):
        return self.get_condition([""] * batch)

    def _guided(self, c_ctx, uc_ctx, scales, bsz):
        K = len(scales)
        scale_f = torch.tensor(scales, dtype=torch.float32, device=self.core.device)
        scale_f = scale_f.repeat_interleave(bsz).reshape(K * bsz, 1, 1, 1)
        uc, c = uc_ctx.repeat(K, 1, 1), c_ctx.repeat(K, 1, 1)
        return _parent_cfg_model_fn(self.core.apply_model, uc, c, scale_f)


def _parent_cfg_model_fn(model_fn, uncond, cond, scale):
    c_in, combine = _parent_make_cfg_combine(uncond, cond, scale)

    def fn(x, t):
        return combine(model_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), c_in))
    return fn


def test_a_plain_tensor_pipeline_is_the_parents():
    from cyclediffusion_tpu_torch.text import HashTokenizer

    core = LatentDiffusionCore.random_init(LatentCoreSpec.tiny("clip"), 0, "cpu")
    kw = dict(custom_steps=10, eta=0.1, white_box_steps=11, skip_steps=[5],
              encoder_unconditional_guidance_scales=[1],
              decoder_unconditional_guidance_scales=[1, 5], n_trials=1)
    img = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    outs = []
    for cls in (StochasticTextPipeline, _ParentPipeline):
        pipe = cls(core, HashTokenizer(96, 16), None, **kw)
        g = torch.Generator().manual_seed(4)
        z = pipe.encode(img, TEXTS, g)
        outs.append((z, pipe.generate(z, TEXTS[::-1], g)))
    (z1, im1), (z2, im2) = outs
    assert all(torch.equal(a, b) for a, b in zip(z1 + im1, z2 + im2))


# ---- by name ------------------------------------------------------------------- #

def test_sdxl_by_name():
    from cyclediffusion_tpu_torch.pipelines import factory

    spec = LatentCoreSpec.sdxl_base()
    assert spec.unet.depth_at(2) == 10 and spec.context_length == 77
    assert spec.cond_cfg.context_dim == spec.unet.context_dim == 2048
    assert spec.cond_cfg.vector_dim == spec.unet.adm_in_channels == 2816
    assert factory._published("sdxl", "sd_xl_base_1.0.ckpt")[0] == spec
    pipe = factory.get_gan_wrapper(
        [("gan_type", "SDXLStochasticText"), ("source_model_type", "tiny"),
         ("custom_steps", 4), ("eta", 0.1), ("white_box_steps", 5), ("skip_steps", [2]),
         ("encoder_unconditional_guidance_scales", [1]),
         ("decoder_unconditional_guidance_scales", [3]), ("n_trials", 1)], device="cpu")
    assert pipe.core.spec.cond_kind == "sdxl"
    z = pipe.encode(torch.rand((1, 32, 32, 3)), ["a cat"], torch.Generator().manual_seed(0))
    assert pipe.generate(z, ["a dog"], torch.Generator().manual_seed(1))[0].shape == (
        1, 32, 32, 3)
