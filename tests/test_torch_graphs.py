"""The compiled chains' counterpart in the port (``runtime.graphs``) on the
CPU, where a graphed call is the plain call: the signature key and its
rebuild, the launch-count bookkeeping of captures and replays, the plain
result on CPU tensors from every graphed entry point, the tensor-parallel
core staying eager; and the text pipeline's tail-chunk padding against
JAX's ``_pad_launch`` and, end to end, the ensemble with a padded tail
against the JAX pipeline at fp32 (the tolerance of
``test_torch_ensemble.py``: 2e-4 on z and images).

The capture and replay themselves need a card: ``chip_smoke.py`` holds each
graphed chain against its eager chain there.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.pipelines import latent_text as jlatent_text
from cyclediffusion_tpu.pipelines.factory import get_gan_wrapper as jget_gan_wrapper
from cyclediffusion_tpu.runtime import context as jcontext
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu_torch.ops import launches
from cyclediffusion_tpu_torch.pipelines import factory, zoo
from cyclediffusion_tpu_torch.pipelines.ddpm_ddim import DDPMDDIMPipeline
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.runtime import context, graphs
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.samplers import num_recovered_eps
from test_torch_common import REPO, max_abs, to_torch

CFG = os.path.join(REPO, "cyclediffusion_tpu", "config", "experiments",
                   "tiny_text_translation.cfg")
SRC, DST = ["a photo of a cat", "a red car"], ["a photo of a dog", "a blue car"]
TOL = 2e-4       # test_torch_ensemble.py's, on z and images


# ---- the tail chunk's padding -------------------------------------------- #

@pytest.mark.parametrize("extent", [1, 2, 3])
@pytest.mark.parametrize("chunk", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_pad_launch_matches_jax(n, chunk, extent):
    """Every launch of a skip with ``n`` candidates in chunks of ``chunk`` on
    a data extent: the port's padded list is JAX's, a tail chunk after the
    first is padded to the chunk's size (then to the extent), and the
    padding repeats the last candidate."""
    stand_in = types.SimpleNamespace(_data_extent=extent)
    idxs = list(range(10, 10 + n))
    for c0 in range(0, n, chunk):
        sub = idxs[c0:c0 + chunk]
        got = StochasticTextPipeline._pad_launch(stand_in, sub, chunk, c0)
        want = jlatent_text.StochasticTextPipeline._pad_launch(stand_in, sub, chunk, c0)
        assert got == want
        size = chunk if c0 > 0 else len(sub)
        assert len(got) == -(-size // extent) * extent
        assert got[:len(sub)] == sub and set(got[len(sub):]) <= {sub[-1]}


# ---- the signature and the launch counts -------------------------------- #

def _args(batch=2, dtype=torch.float32, context=True, cache_len=2):
    x = torch.zeros(batch, 4, 4, 3, dtype=dtype)
    t = torch.zeros(batch, dtype=torch.int64)
    ctx = torch.zeros(batch, 5, 8) if context else None
    cache = None if cache_len is None else (torch.zeros(batch, 6, 2, 2),
                                            tuple(torch.zeros(batch, 3, 4, 4)
                                                  for _ in range(cache_len)))
    return (x, t, ctx, cache)


@pytest.mark.parametrize("other", [
    dict(batch=3), dict(dtype=torch.bfloat16), dict(context=False), dict(cache_len=None),
    dict(cache_len=3),
])
def test_signature_separates_what_a_graph_cannot_share(other):
    """Shapes, dtypes, a ``None`` argument and the cache's structure each
    make another key; equal arguments with other values make the same one."""
    key, leaves = graphs.signature(_args())
    ones = graphs.map_tensors(lambda t: torch.ones_like(t), _args())
    assert graphs.signature(ones)[0] == key and len(leaves) == 6
    assert graphs.signature(_args(**other))[0] != key


def test_signature_holds_the_backend_flags():
    """A convolution's kernel is chosen by the flags at capture, so another
    setting of them is another key."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    try:
        cudnn.deterministic = False
        key = graphs.signature(_args())[0]
        cudnn.deterministic = True
        assert graphs.signature(_args())[0] != key
    finally:
        cudnn.deterministic = saved


def test_rebuild_puts_the_leaves_back_in_place():
    args = _args() + (7, "s", [torch.ones(1), None])
    key, leaves = graphs.signature(args)
    fresh = [t.clone() for t in leaves]
    rebuilt = graphs.rebuild(key, fresh)
    assert type(rebuilt) is tuple and len(rebuilt) == len(args)
    assert rebuilt[2] is fresh[2] and rebuilt[3][1][1] is fresh[5]
    assert rebuilt[4:6] == (7, "s") and type(rebuilt[6]) is list and rebuilt[6][1] is None
    assert graphs.signature(rebuilt)[0] == key
    with pytest.raises(TypeError):
        graphs.signature((np.zeros(2),))


@pytest.mark.parametrize("replays", [0, 1, 3])
def test_a_replay_adds_what_its_capture_counted(replays, monkeypatch):
    """The launches a capture counted (taken back out, since capturing
    launches nothing) are added once per replay: per capture x replays."""
    counts = dict.fromkeys(launches.counts, 0)
    monkeypatch.setattr(launches, "counts", counts)
    before = dict(counts)
    counts["flash_attention_bhtd"] += 5       # what the captured call's wrappers counted
    counts["flash_attention_packed"] += 5
    delta = graphs.count_delta(before, counts)
    counts.update(before)
    assert delta == {"flash_attention_packed": 5, "flash_attention_bhtd": 5,
                     "qout_self_attention_block": 0, "fused_self_attention_block": 0,
                     "group_norm": 0, "group_norm_backward": 0}
    fake = types.SimpleNamespace(replay=lambda: None)
    captured = graphs.Captured(fake, [], None, delta, 0.0)
    for _ in range(replays):
        captured.replay()
    assert captured.replays == replays
    assert counts == {k: replays * v for k, v in delta.items()}
    graphs.add_counts(counts, delta, times=2)
    assert counts["flash_attention_bhtd"] == 5 * (replays + 2)


# ---- the graphed entry points on the CPU ---------------------------------- #

@pytest.fixture(scope="module")
def tiny_core():
    return LatentDiffusionCore.random_init(LatentCoreSpec.tiny(), seed=3, device="cpu")


def test_core_entry_points_are_the_plain_calls_on_the_cpu(tiny_core):
    """On CPU tensors ``apply_model`` and ``apply_model_cached`` (key and
    reuse) return their eager twins' results exactly, and capture nothing."""
    core = tiny_core
    gen = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(2, 8, 8, 4, generator=gen), torch.randn(2, 16, 24, generator=gen)
    t = torch.tensor([5, 40])
    assert torch.equal(core.apply_model(x, t, ctx), core.apply_model_eager(x, t, ctx))
    eps, cache = core.apply_model_cached(x, t, ctx)
    want_eps, want_cache = core.apply_model_cached_eager(x, t, ctx)
    assert torch.equal(eps, want_eps)
    assert len(cache[1]) == len(want_cache[1]) and all(
        torch.equal(a, b) for a, b in zip((cache[0],) + cache[1],
                                          (want_cache[0],) + want_cache[1]))
    reuse, same = core.apply_model_cached(x, t + 1, ctx, cache)
    assert same is cache
    assert torch.equal(reuse, core.apply_model_cached_eager(x, t + 1, ctx, cache)[0])
    assert not (core._graphed_apply.graphs or core._graphed_key.graphs
                or core._graphed_reuse.graphs)


def test_pixel_pipeline_model_fn_is_the_plain_call_on_the_cpu():
    pipe = DDPMDDIMPipeline.random_init(zoo.tiny_pixel_spec(16), 0, device="cpu",
                                        custom_steps=20, es_steps=5, eta=0.1)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 9])
    assert torch.equal(pipe._model_fn(x, t), pipe._model_fn_eager(x, t))
    assert not pipe._graphed.graphs


def test_a_tensor_parallel_core_calls_its_unet_eagerly(tiny_core, monkeypatch):
    """A UNet that ``parallel.tp`` sharded is called eagerly, by the core's
    explicit check, never through its graphed calls."""
    def refuse(*a):
        raise AssertionError("a graphed call on a sharded UNet")

    for name in ("_graphed_apply", "_graphed_key", "_graphed_reuse"):
        monkeypatch.setattr(tiny_core, name, refuse)
    x, t, ctx = torch.zeros(1, 8, 8, 4), torch.tensor([3]), torch.zeros(1, 16, 24)
    monkeypatch.setattr(tiny_core.unet, "_tp_sharded", True, raising=False)
    assert torch.equal(tiny_core.apply_model(x, t, ctx), tiny_core.apply_model_eager(x, t, ctx))
    _, cache = tiny_core.apply_model_cached(x, t, ctx)
    tiny_core.apply_model_cached(x, t, ctx, cache)
    monkeypatch.setattr(tiny_core.unet, "_tp_sharded", False)
    with pytest.raises(AssertionError):
        tiny_core.apply_model(x, t, ctx)


def test_graphed_call_refuses_what_it_cannot_replay():
    call = graphs.GraphedCall(lambda a, b: a + b, name="add")
    x = torch.ones(2)
    assert torch.equal(call(x, x), 2 * x)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x.clone().requires_grad_(True), x)
    with torch.no_grad():
        call(x.clone().requires_grad_(True), x)
    with pytest.raises(ValueError, match="one device"):
        call(x, torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        call(torch.ones(2, device="meta"), torch.ones(2, device="meta"))


# ---- the ensemble with a padded tail against JAX ------------------------- #

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tail_pipes():
    """JAX's and the port's text pipelines on the tiny config's weights, 5
    candidates (one per encoder scale) at one skip in chunks of 2: 2 + 2 +
    1, the last padded to 2."""
    saved = {k: os.environ.pop(k) for k in ("CYCLEDIFFUSION_CLIP_CKPT",
                                            "CYCLEDIFFUSION_CLIP_BPE",
                                            "CYCLEDIFFUSION_FOLDED_ATTN") if k in os.environ}
    try:
        jcontext.reset()
        context.reset()
        jbase = jget_gan_wrapper(jget_config(CFG).gan)
        jcontext.reset()
        params = {"core": _np_tree(jbase.core.params),
                  "clip": _np_tree(jbase.directional_clip.scorer.params)}
        base = factory.get_gan_wrapper(get_config(CFG).gan, device="cpu", jax_params=params)
        context.reset()
    finally:
        os.environ.update(saved)
    kw = dict(custom_steps=6, eta=0.1, white_box_steps=7, skip_steps=[2],
              encoder_unconditional_guidance_scales=[0.0, 1.0, 2.0, 3.0, 5.0],
              decoder_unconditional_guidance_scales=[3.0], n_trials=1, candidate_chunk=2)
    jpipe = jlatent_text.StochasticTextPipeline(jbase.core, jbase.tokenizer, None, **kw)
    pipe = StochasticTextPipeline(base.core, base.tokenizer, None, **kw)
    return jpipe, pipe


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


def test_ensemble_with_a_padded_tail_matches_jax(tail_pipes, monkeypatch):
    """Encode and generate of 5 candidates in chunks of 2 against the JAX
    pipeline at the same weights and noise (2e-4); every chain, the padded
    tail's included, runs the UNet at one batch: 2 candidates x the CFG pair
    x 2 images."""
    jpipe, pipe = tail_pipes
    img = np.random.default_rng(11).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    batches = []
    apply_model = pipe.core.apply_model

    def spy(x, *a):
        batches.append(x.shape[0])
        return apply_model(x, *a)

    monkeypatch.setattr(pipe.core, "apply_model", spy)
    jz = jpipe.encode(jax.numpy.asarray(img), SRC, key)
    vae, xT_noises, posts = _jax_encode_draws(jpipe, key, 2)
    z = pipe.encode(img, SRC, vae_noise=vae, xT_noises=xT_noises, posterior_noises=posts)
    assert len(z) == len(jz) == 5
    for a, b in zip(z, jz):
        assert max_abs(a, b) < TOL
    jimgs = jpipe.generate(jz, DST, jax.random.PRNGKey(13))
    imgs = pipe.generate(z, DST)
    assert len(imgs) == len(jimgs) == 5
    for a, b in zip(imgs, jimgs):
        assert max_abs(a, b) < TOL
    n = num_recovered_eps(6, 7, 2)
    assert batches == [2 * 2 * 2] * (3 * n + 3 * 4)     # 3 chunks a chain, both ways
