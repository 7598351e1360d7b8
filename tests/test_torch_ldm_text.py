"""The ``LatentDiffStochasticText`` family of the port (LDM text2img-large's
LDM-BERT conditioning) against the JAX package, at fp32 on the CPU: the
WordPiece tokenizer, ``LDMBertEncoder``, its CompVis checkpoint mapping and
its Flax tree, the full-width spec, the tiny ensemble through the factory,
the synthetic assets and the CLI on the tiny latent and fast configs.

Tolerances: token ids exact; encoder and UNet outputs 1e-4 absolute
(``test_torch_models.py``: the same fp32 arithmetic, sums in other orders);
a loaded checkpoint equals the written weights bit for bit; the ensemble's
latents and images 2e-4 and its scores 1e-4 (``test_torch_ensemble.py``'s).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.convert import convert_ldm_bert as jconvert_ldm_bert
from cyclediffusion_tpu.models import text_encoders as jte
from cyclediffusion_tpu.models import unet_gd as jug
from cyclediffusion_tpu.pipelines.factory import get_gan_wrapper as jget_gan_wrapper
from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu.pipelines.latent import LatentDiffusionCore as JCore
from cyclediffusion_tpu.runtime import context as jcontext
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu.text.tokenizer import BertWordPieceTokenizer as JBert
from cyclediffusion_tpu_torch import main as cli
from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from cyclediffusion_tpu_torch.models import text_encoders as te
from cyclediffusion_tpu_torch.models import unet_gd as ug
from cyclediffusion_tpu_torch.pipelines import factory
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.text import BertWordPieceTokenizer
from cyclediffusion_tpu_torch.tools import sd_assets
from test_torch_common import REPO, fill_flax_tree, max_abs, port_fields, to_torch
from test_torch_ensemble import _jax_encode_draws, _jax_scores, _np_tree

ATOL = 1e-4
SRC, DST = ["a photo of a cat", "a red car"], ["a photo of a dog", "a blue car"]

# a vocab with bert-base-uncased's special ids, whole words, ## pieces and
# punctuation
VOCAB = ([sd_assets.BERT_SPECIALS.get(i, f"[unused{i - 1}]") for i in range(104)]
         + [".", ",", "!", "'", "a", "photo", "of", "cat", "dog", "walk", "##ing", "##s",
            "un", "##believ", "##able", "snow", "##man", "the", "in", "grass"])
TEXTS = [
    "A photo of a cat.",
    "Cats walking in the grass!",
    "the snowman's unbelievable walk, in snow",
    "a zebra in the grass",                  # an unknown word -> [UNK]
    "walkings unbeliev",                     # a piece that does not finish -> [UNK]
    " ".join(["cat"] * 100),                 # truncated to 77 with [SEP] kept
    "",
]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


@pytest.mark.parametrize("text", TEXTS)
def test_wordpiece_tokenizer_matches_jax(vocab, text):
    ids, want = BertWordPieceTokenizer(vocab)([text]), JBert(vocab)([text])
    np.testing.assert_array_equal(ids, want)
    assert ids.shape == (1, 77) and ids.dtype == np.int32
    assert ids[0, 0] == 101 and 102 in ids[0]


def test_wordpiece_pieces_unknowns_and_truncation(vocab):
    tok = BertWordPieceTokenizer(vocab)
    v = tok.vocab
    row = tok(["Cats walking, unbelievable"])[0]
    assert list(row[:9]) == [101, v["cat"], v["##s"], v["walk"], v["##ing"], v[","],
                             v["un"], v["##believ"], v["##able"]]
    assert row[9] == 102 and set(row[10:]) == {0}
    assert list(tok(["a zebra"])[0][:4]) == [101, v["a"], 100, 102]
    long = tok([" ".join(["cat"] * 100)])[0]
    assert long[-1] == 102 and (long == v["cat"]).sum() == 75
    with pytest.raises(FileNotFoundError, match="vocab.txt not found"):
        BertWordPieceTokenizer(os.path.join(os.path.dirname(vocab), "missing.txt"))


def _tiny_bert(seed):
    """(filled numpy tree, JAX module) of the tiny LDM-BERT."""
    jmod = jte.LDMBertEncoder(JSpec.tiny(cond_kind="bert").cond_cfg)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    return fill_flax_tree(shapes, seed), jmod


def test_ldm_bert_encoder_tiny_matches():
    """The miniature LDM-BERT (2 layers, dim 24, 2 heads x 12) through
    ``convert.from_jax``: every Flax leaf (the raw ``pos_emb`` too) lands
    on a parameter, and the outputs agree."""
    tree, jmod = _tiny_bert(2)
    cfg = LatentCoreSpec.tiny("bert").cond_cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JSpec.tiny(cond_kind="bert").cond_cfg)
    mod = te.LDMBertEncoder(cfg)
    sd = flax_to_state_dict(tree, mod)
    assert len(sd) == len(mod.state_dict()) == len(jax.tree.leaves(tree))
    assert "pos_emb" in sd and "attn.1.to_out.bias" in sd and "ff_in.0.weight" in sd
    load_flax_params(mod, tree)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    want = jmod.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids, jnp.int32))
    got = mod.eval().requires_grad_(False)(torch.from_numpy(ids))
    assert float(jnp.abs(want).max()) > 0.5
    assert max_abs(got, want) < ATOL


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(the seeded tiny LDM-BERT port core, its CompVis checkpoint's path)."""
    core = LatentDiffusionCore.random_init(LatentCoreSpec.tiny("bert"), seed=6, device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    assert sd_assets.write_compvis_checkpoint(core, path) > 0
    return core, path


def test_ldm_checkpoint_layout_and_bitwise_reload(written):
    core, path = written
    sd = from_torch.load_torch_state_dict(path)
    prefix = "cond_stage_model.transformer."
    for key in ("attn_layers.layers.0.0.weight", "attn_layers.layers.2.1.to_q.weight",
                "attn_layers.layers.3.1.net.0.0.bias", "attn_layers.layers.1.1.net.2.weight",
                "pos_emb.emb.weight", "token_emb.weight", "norm.bias", "to_logits.weight"):
        assert prefix + key in sd, key
    loaded = LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny("bert"), path, device="cpu")
    want, got = core.state_dict(), loaded.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_convert_ldm_bert_matches_jax(written):
    """The same CompVis checkpoint through JAX's ``convert_ldm_bert`` and
    the port's: the two encoders compute the same embeddings, and the
    cores' UNets the same eps under them."""
    _, path = written
    jcore = JCore.from_torch_ckpt(JSpec.tiny(cond_kind="bert"), path)
    core = LatentDiffusionCore.from_torch_ckpt(LatentCoreSpec.tiny("bert"), path, device="cpu")
    ids = np.random.default_rng(7).integers(0, 96, (2, 16))
    want = jcore.get_learned_conditioning(jnp.asarray(ids, jnp.int32))
    got = core.get_learned_conditioning(ids)
    assert float(jnp.abs(want).max()) > 0.5
    assert max_abs(got, want) < ATOL
    x = np.random.default_rng(8).standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([5, 60])
    want_eps = jcore.apply_model(jnp.asarray(x), jnp.asarray(t, jnp.int32), want)
    got_eps = core.apply_model(to_torch(x), torch.from_numpy(t), got)
    assert max_abs(got_eps, want_eps) < ATOL


@pytest.mark.parametrize("key", ["transformer.attn_layers.layers.1.1.net.5.weight",
                                 "transformer.attn_layers.layers.0.2.weight",
                                 "transformer.extra.weight"])
def test_convert_ldm_bert_refuses_unmapped_keys_like_jax(written, key):
    """A key of no weight: JAX's converter fails on it (with a KeyError, or
    an AssertionError where it takes the key for a dense layer's), and the
    port's raises a KeyError naming it."""
    core, _ = written
    sd = {k[len("cond_stage_model."):]: v for k, v in
          sd_assets.compvis_state_dict(core).items() if k.startswith("cond_stage_model.")}
    sd[key] = torch.ones(3)
    with pytest.raises((KeyError, AssertionError)):
        jconvert_ldm_bert({k: v.numpy() for k, v in sd.items()})
    with pytest.raises(KeyError, match="unmapped ldm-bert key: cond_stage_model." + key):
        from_torch.convert_ldm_bert(sd, core.cond_model)


@pytest.mark.parametrize("name", ["token_emb.weight", "pos_emb", "attn_norm.3.bias",
                                  "attn.0.to_q.weight", "attn.31.to_out.bias",
                                  "ff_norm.2.weight", "ff_in.5.bias", "ff_out.0.weight",
                                  "norm.weight"])
def test_compvis_bert_names_round_trip(name):
    assert from_torch.ldm_bert_name("transformer." + sd_assets.compvis_bert_name(name)) == name


def _param_counts(jmod, args):
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))


def test_text2img_large_spec_matches_jax():
    """Every field of the port's full-width spec equals JAX's, and each
    module built on the ``meta`` device (no memory) has JAX's parameter
    count: the UNet is SD's with a 1280-d context, LDM-BERT 32 x 1280."""
    spec, jspec = LatentCoreSpec.ldm_text2img_large(), JSpec.ldm_text2img_large()
    for field in dataclasses.fields(spec):
        got, want = getattr(spec, field.name), getattr(jspec, field.name)
        if dataclasses.is_dataclass(got):
            want = dataclasses.asdict(want)
            got = port_fields(got, want)
            want = {k: v for k, v in want.items() if k in got}
        assert got == want, field.name
    assert (spec.image_size, spec.context_length, jspec.cond_kind) == (32, 77, "bert")
    assert spec.unet == dataclasses.replace(ug.GDUNetConfig.sd_v1(), context_dim=1280)
    with torch.device("meta"):
        unet, bert = ug.GDUNet(spec.unet), te.LDMBertEncoder(spec.cond_cfg)
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in (("unet", unet), ("bert", bert))}
    assert counts["unet"] == _param_counts(
        jug.GDUNet(jspec.unet), (jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, 77, 1280))))
    assert counts["bert"] == _param_counts(jte.LDMBertEncoder(jspec.cond_cfg),
                                           (jnp.zeros((1, 77), jnp.int32),))
    assert counts == {"unet": 872_300_484, "bert": 542_895_360}


LDM_TINY_CFG = os.path.join(REPO, "cyclediffusion_tpu", "config", "experiments",
                            "tiny_text_translation_latent.cfg")


@pytest.fixture(scope="module")
def ldm_pipes():
    """(JAX pipeline, port pipeline with its weights) from the tiny latent
    config, each built by its own factory."""
    saved = {v: os.environ.pop(v, None) for v in ("CYCLEDIFFUSION_CLIP_CKPT",
                                                  "CYCLEDIFFUSION_CLIP_BPE",
                                                  "CYCLEDIFFUSION_FOLDED_ATTN")}
    jcontext.reset()
    context.reset()
    jpipe = jget_gan_wrapper(jget_config(LDM_TINY_CFG).gan)
    jcontext.reset()
    params = {"core": _np_tree(jpipe.core.params),
              "clip": _np_tree(jpipe.directional_clip.scorer.params)}
    pipe = factory.get_gan_wrapper(get_config(LDM_TINY_CFG).gan, device="cpu",
                                   jax_params=params)
    yield jpipe, pipe
    context.reset()
    os.environ.update({k: v for k, v in saved.items() if v is not None})


def test_tiny_ldm_ensemble_matches_jax(ldm_pipes):
    """The tiny ``LatentDiffStochasticText`` ensemble (2 trials x skips
    [0, 2] x decoder scales [1, 3]): z's fed JAX's draws, candidates,
    DirectionalCLIP scores and ``forward``'s winner against JAX's."""
    jpipe, pipe = ldm_pipes
    assert pipe.core.spec.cond_kind == jpipe.core.spec.cond_kind == "bert"
    np.testing.assert_array_equal(pipe.tokenizer(SRC), jpipe.tokenizer(SRC))
    img = np.random.default_rng(3).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jz = jpipe.encode(jnp.asarray(img), SRC, key)
    vae, xT_noises, posts = _jax_encode_draws(jpipe, key, 2)
    z = pipe.encode(img, SRC, vae_noise=vae, xT_noises=xT_noises, posterior_noises=posts)
    assert len(z) == len(jz) == 4
    for a, b in zip(z, jz):
        assert max_abs(a, b) < 2e-4
    jimgs = jpipe.generate(jz, DST, jax.random.PRNGKey(7))
    imgs = pipe.generate(z, DST)
    assert len(imgs) == len(jimgs) == 8
    for a, b in zip(imgs, jimgs):
        assert max_abs(a, b) < 2e-4
    scores, best = pipe.rank(imgs, to_torch(img), SRC, DST)
    assert max_abs(scores, _jax_scores(jpipe, jimgs, jnp.asarray(img))) < 1e-4
    best_img, _ = pipe.forward(z, img, SRC, DST)
    for b in range(2):
        torch.testing.assert_close(best_img[b], imgs[int(best[b])][b], rtol=0, atol=0)


def test_synthetic_vocab_covers_the_prompts(tmp_path):
    """``write_bert_vocab`` on the repo's text-editing prompts: no prompt
    word is ``[UNK]``, ``##`` pieces are used, every id fits
    text2img-large's 30522-row embedding, and the tokenizer reads it like
    JAX's."""
    with open(os.path.join(REPO, "data", "translate-text.json")) as f:
        entries = json.load(f)
    texts = [e[k] for e in entries for k in ("encode_text", "decode_text")]
    path = sd_assets.write_bert_vocab(str(tmp_path / "vocab.txt"), texts)
    tok = BertWordPieceTokenizer(path)
    ids = tok(texts)
    np.testing.assert_array_equal(ids, JBert(path)(texts))
    assert not (ids == tok.unk).any()
    assert int(ids.max()) < LatentCoreSpec.ldm_text2img_large().cond_cfg.vocab_size
    pieces = {i for t, i in tok.vocab.items() if t.startswith("##")}
    assert pieces & set(ids.ravel().tolist())
    assert (tok.pad, tok.unk, tok.cls, tok.sep) == (0, 100, 101, 102)


@pytest.mark.parametrize("name", ["tiny_text_translation_latent", "tiny_text_translation_fast"])
def test_cli_runs_the_tiny_configs(name, tmp_path):
    """The port's CLI on the tiny LDM-BERT and fast-mode configs on the
    CPU: finite metrics, two samples, the files of an eval run."""
    context.reset()
    out = str(tmp_path / "out")
    metrics = cli.main(["--cfg", f"experiments/{name}.cfg", "--output_dir", out,
                        "--seed", "42", "--do_eval", "--per_device_eval_batch_size", "2"],
                       device="cpu")
    context.reset()
    for key in ("eval_translate/psnr", "eval_translate/ssim", "eval_translate/d-clip",
                "eval_avr"):
        assert np.isfinite(metrics[key]), key
    assert metrics["eval_samples"] == 2
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert "eval_results.csv" in files and "temp_gen/1.png" in files
    assert "visualization/eval_000000.png" in files
