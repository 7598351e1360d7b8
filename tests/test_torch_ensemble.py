"""The candidate-ensemble search of the port against the JAX package, on the
tiny text-translation config at fp32: the factory, ``forward`` with the
DirectionalCLIP ranking, ``candidate_chunk``, the task model, the config
reader and the scorer context.

Both pipelines come from their factories on
``experiments/tiny_text_translation.cfg``; the port's takes the JAX
pipeline's weights (``jax_params``) and, on encode, the JAX side's noise
draws through its noise seams.  With ``white_box_steps = custom_steps + 1``
every eps is stored, so decoding draws nothing.  Tolerances: images 2e-4
(as ``test_torch_pipeline.py``: each UNet call adds ~1e-5 of summation-order
difference, the CFG scale amplifies it), DirectionalCLIP scores 1e-4.  The
tiny random model's candidates score alike to 1e-5, so the winner and its
combo are compared on distinct candidates fed to both ``forward``s, where
the top two scores differ by more than 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.pipelines.factory import get_gan_wrapper as jget_gan_wrapper
from cyclediffusion_tpu.runtime import context as jcontext
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer
from cyclediffusion_tpu_torch.pipelines import factory
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.samplers import num_recovered_eps
from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import (
    TextUnsupervisedTranslation,
)
from test_torch_common import REPO, max_abs, to_torch

CFG = os.path.join(REPO, "cyclediffusion_tpu", "config", "experiments",
                   "tiny_text_translation.cfg")
SRC, DST = ["a photo of a cat", "a red car"], ["a photo of a dog", "a blue car"]
SCORE_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipes(monkeypatch_module):
    """(JAX pipeline, port pipeline with the JAX weights), both built from
    the tiny config by their factories, without CLIP assets."""
    for var in ("CYCLEDIFFUSION_CLIP_CKPT", "CYCLEDIFFUSION_CLIP_BPE",
                "CYCLEDIFFUSION_FOLDED_ATTN"):
        monkeypatch_module.delenv(var, raising=False)
    jcontext.reset()
    context.reset()
    jpipe = jget_gan_wrapper(jget_config(CFG).gan)
    jcontext.reset()
    params = {"core": _np_tree(jpipe.core.params),
              "clip": _np_tree(jpipe.directional_clip.scorer.params)}
    pipe = factory.get_gan_wrapper(get_config(CFG).gan, device="cpu", jax_params=params)
    yield jpipe, pipe
    context.reset()


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _jax_encode_draws(jpipe, key, bsz):
    """The draws JAX's ``encode`` makes under ``key``: (VAE posterior noise,
    per-candidate x_T noises, posterior noises)."""
    spec = jpipe.core.spec
    shape = (bsz, spec.image_size, spec.image_size, spec.embed_dim)
    k_vae, k_chains = jax.random.split(key)
    combos = [(t, e, s) for t in range(jpipe.n_trials) for e in jpipe.enc_scales
              for s in jpipe.skip_steps]
    xT_noises, posts = [], []
    for kc, (_, _, skip) in zip(jax.random.split(k_chains, len(combos)), combos):
        n = num_recovered_eps(jpipe.sched.num_steps, jpipe.white_box_steps, skip)
        k_xT, k_post = jax.random.split(kc)
        xT_noises.append(to_torch(jax.random.normal(k_xT, shape)))
        posts.append(to_torch(jax.random.normal(k_post, (n,) + shape)))
    return to_torch(jax.random.normal(k_vae, shape)), xT_noises, posts


def _jax_scores(jpipe, jimgs, original):
    """The scores JAX's ``forward`` ranks by (its own code path, unreturned)."""
    d = jpipe.directional_clip
    enc, dec = d.text_features(SRC), d.text_features(DST)
    orig = d.scorer.embed_image(original)
    stacked = jnp.stack(jimgs)
    feat = d.scorer.embed_images_microbatched(stacked.reshape((-1,) + stacked.shape[2:]))
    feat = feat.reshape(stacked.shape[0], stacked.shape[1], -1)
    img_dir = feat - orig[None]
    img_dir = img_dir / jnp.linalg.norm(img_dir, axis=-1, keepdims=True)
    text_dir = (dec - enc) / jnp.linalg.norm(dec - enc, axis=-1, keepdims=True)
    return np.asarray(jnp.einsum("nbz,bz->bn", img_dir, text_dir))


def test_factory_builds_the_jax_pipeline(pipes):
    jpipe, pipe = pipes
    for attr in ("white_box_steps", "skip_steps", "enc_scales", "dec_scales", "n_trials",
                 "candidate_chunk", "resolution"):
        assert getattr(pipe, attr) == getattr(jpipe, attr), attr
    for attr in ("timesteps", "alphas", "alphas_prev", "sigmas"):
        np.testing.assert_allclose(getattr(pipe.sched, attr).numpy(),
                                   np.asarray(getattr(jpipe.sched, attr)), rtol=1e-6)
    assert pipe.core.spec.image_size == jpipe.core.spec.image_size
    assert pipe.core.device.type == "cpu" and pipe.core.dtype == torch.float32
    assert pipe.core.folded_attn is None
    np.testing.assert_array_equal(pipe.tokenizer(SRC), jpipe.tokenizer(SRC))
    cfg, jcfg = pipe.directional_clip.scorer.config, jpipe.directional_clip.scorer.config
    assert vars(cfg) == vars(jcfg)


def test_forward_matches_jax(pipes):
    jpipe, pipe = pipes
    img = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jz = jpipe.encode(jnp.asarray(img), SRC, key)
    vae, xT_noises, posts = _jax_encode_draws(jpipe, key, 2)
    z = pipe.encode(img, SRC, vae_noise=vae, xT_noises=xT_noises, posterior_noises=posts)
    assert len(z) == len(jz) == 4                     # 2 trials x 2 skips
    for a, b in zip(z, jz):
        assert max_abs(a, b) < 2e-4

    jimgs = jpipe.generate(jz, DST, jax.random.PRNGKey(5))
    imgs = pipe.generate(z, DST)
    assert len(imgs) == len(jimgs) == 8               # x 2 decoder scales
    for a, b in zip(imgs, jimgs):
        assert max_abs(a, b) < 2e-4
    want_scores = _jax_scores(jpipe, jimgs, jnp.asarray(img))
    scores, best = pipe.rank(imgs, to_torch(img), SRC, DST)
    assert max_abs(scores, want_scores) < SCORE_TOL

    best_img, _ = pipe.forward(z, img, SRC, DST)
    for b in range(2):
        torch.testing.assert_close(best_img[b], imgs[int(best[b])][b], rtol=0, atol=0)


def test_forward_ranks_like_jax(pipes, monkeypatch):
    """``forward``'s ranking and combo report against JAX's on candidates
    that differ clearly (the tiny random model's own candidates score alike
    to 1e-5): both pipelines' ``generate`` return the same 8 random
    candidate batches."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(5)
    cands = rng.uniform(size=(8, 2, 32, 32, 3)).astype(np.float32)
    img = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    monkeypatch.setattr(jpipe, "generate", lambda *a: [jnp.asarray(c) for c in cands])
    monkeypatch.setattr(pipe, "generate", lambda *a: [to_torch(c) for c in cands])
    want_scores = _jax_scores(jpipe, jpipe.generate(), jnp.asarray(img))
    scores, best = pipe.rank(pipe.generate(), to_torch(img), SRC, DST)
    assert max_abs(scores, want_scores) < SCORE_TOL
    jbest_img, jcombos = jpipe.forward(None, jnp.asarray(img), SRC, DST, None)
    best_img, combos = pipe.forward(None, img, SRC, DST)
    for b in range(2):
        top2 = np.sort(want_scores[b])[-2:]
        assert top2[1] - top2[0] > SCORE_TOL        # a clear winner to compare
        assert int(best[b]) == int(np.argmax(want_scores[b]))
        assert combos[b] == jcombos[b]
        assert max_abs(best_img[b], jbest_img[b]) == 0


def test_call_prints_the_winning_combos(pipes, capsys):
    _, pipe = pipes
    img = np.random.default_rng(3).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    z = pipe.encode(img, SRC[:1], torch.Generator().manual_seed(0))
    out = pipe(z, img, SRC[:1], DST[:1])
    assert out.shape == (1, 32, 32, 3)
    assert "best scales:" in capsys.readouterr().out


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_candidate_chunk_does_not_change_results(pipes, chunk):
    """Chunking caps the candidates per chain and changes no result: the
    same z's and images as one chain per skip.  1e-6: the batch size only
    changes how the CPU's GEMMs block their fp32 sums."""
    _, pipe = pipes
    kw = dict(custom_steps=pipe.sched.num_steps, eta=0.1,
              white_box_steps=pipe.white_box_steps - 1, skip_steps=pipe.skip_steps,
              encoder_unconditional_guidance_scales=pipe.enc_scales,
              decoder_unconditional_guidance_scales=pipe.dec_scales,
              n_trials=pipe.n_trials)
    img = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    outs = []
    for c in (None, chunk):
        p = StochasticTextPipeline(pipe.core, pipe.tokenizer, pipe.directional_clip,
                                   candidate_chunk=c, **kw)
        gen = torch.Generator().manual_seed(9)
        z = p.encode(img, SRC, gen)
        outs.append((z, p.generate(z, DST, gen)))
    (z0, im0), (z1, im1) = outs
    assert len(im0) == len(im1) == 8
    for a, b in list(zip(z0, z1)) + list(zip(im0, im1)):
        assert max_abs(a, b) < 1e-6


def test_task_model_is_per_sample_deterministic(monkeypatch):
    """A sample's result depends on its id, not on its batch: the same
    image alone or beside another gives the same bits."""
    monkeypatch.delenv("CYCLEDIFFUSION_FOLDED_ATTN", raising=False)
    context.reset()
    model = TextUnsupervisedTranslation(get_config(CFG), base_seed=3, device="cpu")
    img = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    (orig, pair), loss, losses = model.forward([7, 9], list(img), SRC, DST)
    (_, alone), _, _ = model.forward([9], [img[1]], SRC[1:], DST[1:])
    (_, other_id), _, _ = model.forward([8], [img[1]], SRC[1:], DST[1:])
    assert pair.shape == (2, 32, 32, 3) and torch.isfinite(pair).all()
    torch.testing.assert_close(orig, to_torch(img), rtol=0, atol=0)
    torch.testing.assert_close(pair[1:], alone, rtol=0, atol=0)
    assert float((other_id - alone).abs().max()) > 0
    assert loss.shape == (2,) and float(loss.abs().max()) == 0 and losses == {}
    context.reset()


def test_factory_reads_the_folded_attn_env(monkeypatch):
    monkeypatch.setenv("CYCLEDIFFUSION_FOLDED_ATTN", "qo")
    context.reset()
    pipe = factory.get_gan_wrapper(get_config(CFG).gan, device="cpu")
    assert pipe.core.folded_attn == "qo"
    assert {m.folded_attn for m in pipe.core.unet.modules()
            if hasattr(m, "folded_attn")} == {"qo", None}
    monkeypatch.setenv("CYCLEDIFFUSION_FOLDED_ATTN", "0")
    assert factory.folded_attn_from_env() is None
    context.reset()


@pytest.mark.parametrize("gan_type", ["LatentDiffStochastic", "DDPM_DDIM", "Unknown"])
def test_factory_refuses_other_gan_types(gan_type, tmp_path, monkeypatch):
    """``DDPM_DDIM`` is not ported (ROADMAP item 3), an unknown gan_type is
    refused, and ``LatentDiffStochastic`` (ported) refuses a published model
    whose checkpoint is absent: it has no random weights."""
    gan = [("gan_type", gan_type), ("source_model_type", "tiny")]
    if gan_type == "LatentDiffStochastic":
        monkeypatch.setenv("CYCLEDIFFUSION_CKPT_ROOT", str(tmp_path))
        gan = [("gan_type", gan_type), ("source_model_type", "ffhq256"),
               ("custom_steps", 4), ("eta", 0.1), ("white_box_steps", 5)]
        with pytest.raises(FileNotFoundError, match="ffhq256"):
            factory.get_gan_wrapper(gan, device="cpu")
        return
    with pytest.raises(ValueError if gan_type == "Unknown" else NotImplementedError,
                       match=gan_type if gan_type == "Unknown" else "ROADMAP §A queue item 3"):
        factory.get_gan_wrapper(gan, device="cpu")


LDM_CFG = "experiments/translate_text2img256_latentdiff_stochastic_1.cfg"


@pytest.mark.parametrize("case", ["tiny", "no checkpoint", "no vocab variable", "no vocab file"])
def test_factory_builds_latentdiff_stochastic_text(case, tmp_path, monkeypatch):
    """``LatentDiffStochasticText`` is built: the tiny LDM-BERT pipeline, or
    text2img-large, which needs its checkpoint under the checkpoint root
    and the WordPiece vocab that ``CYCLEDIFFUSION_BERT_VOCAB`` names."""
    context.reset()
    if case == "tiny":
        pipe = factory.get_gan_wrapper(
            get_config("experiments/tiny_text_translation_latent.cfg").gan, device="cpu")
        assert pipe.core.spec.cond_kind == "bert" and pipe.fast_key_every is None
        assert type(pipe.core.cond_model).__name__ == "LDMBertEncoder"
        assert pipe.tokenizer(["a cat"]).shape == (1, 16)
        context.reset()
        return
    ckpt = tmp_path / "ckpts" / "ldm_models" / "text2img-large" / "model.ckpt"
    monkeypatch.setenv("CYCLEDIFFUSION_CKPT_ROOT", str(tmp_path))
    monkeypatch.setenv("CYCLEDIFFUSION_BERT_VOCAB", str(tmp_path / "vocab.txt"))
    if case != "no checkpoint":
        ckpt.parent.mkdir(parents=True)
        ckpt.write_bytes(b"")   # found; the tokenizer is checked before it is read
    if case == "no vocab variable":
        monkeypatch.delenv("CYCLEDIFFUSION_BERT_VOCAB")
    match = {"no checkpoint": str(ckpt).replace(".", r"\."),
             "no vocab variable": "CYCLEDIFFUSION_BERT_VOCAB",
             "no vocab file": "vocab.txt not found"}[case]
    with pytest.raises(FileNotFoundError, match=match):
        factory.get_gan_wrapper(get_config(LDM_CFG).gan, device="cpu")


def test_config_reader_matches_jax():
    assert get_config(CFG).to_dict() == jget_config(CFG).to_dict()
    with pytest.raises(FileNotFoundError):
        get_config("no/such/file.cfg")


def test_context_without_assets(monkeypatch):
    monkeypatch.delenv("CYCLEDIFFUSION_CLIP_CKPT", raising=False)
    monkeypatch.delenv("CYCLEDIFFUSION_CLIP_BPE", raising=False)
    context.reset()
    assert context.get_directional_clip(required=False) is None
    with pytest.raises(FileNotFoundError):
        context.get_directional_clip(required=True)
    marker = object()
    context.set_directional_clip(marker)
    assert context.get_directional_clip() is marker
    context.reset()


@pytest.mark.parametrize("entry", ["core", "scorer", "factory", "task"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Built without a device, every entry point asks for the card, and on a
    machine without CUDA it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    context.reset()
    build = {
        "core": lambda: LatentDiffusionCore(LatentCoreSpec.tiny()),
        "scorer": lambda: CLIPScorer(factory.TINY_CLIP),
        "factory": lambda: factory.get_gan_wrapper(get_config(CFG).gan),
        "task": lambda: TextUnsupervisedTranslation(get_config(CFG)),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
