"""The port's other compiled programs (``runtime.graphs``) on the CPU, where
each graphed program is the plain call: the guided energy's gradient
(``GraphedGrad`` / ``GraphedEnergy``) equal to ``energy_grad``; the text
encoders, both first-stage kinds (plain and tiled), the CLIP scorer's
embeds and the FID's Inception features equal to their eager twins; a
grad-requiring latent still differentiated through ``decode_first_stage``;
the signature with a ``SplitInputParams``; and the FID's tail padding
against a numpy transcription of JAX's rule
(``cyclediffusion_tpu/evaluation/fid.py``: only where there is more than
one batch, the last image repeated, the padded rows' features dropped).

Every comparison is exact: on CPU tensors a graphed call runs the eager
call's own code.  The captures and replays need a card: ``chip_smoke.py``
holds each program against its eager twin there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer
from cyclediffusion_tpu_torch.energy.clip_energy import clip_energy_fn
from cyclediffusion_tpu_torch.evaluation import fid
from cyclediffusion_tpu_torch.models.inception import InceptionV3Features
from cyclediffusion_tpu_torch.models.nn import fill_random_
from cyclediffusion_tpu_torch.ops.fold import SplitInputParams
from cyclediffusion_tpu_torch.pipelines.factory import TINY_CLIP
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.runtime import graphs
from cyclediffusion_tpu_torch.samplers.guided import (
    GraphedEnergy,
    energy_grad,
    energy_guided_decode,
)
from cyclediffusion_tpu_torch.text import HashTokenizer

# a 32x32 image -> an 8x8 latent; 4x4 patches at stride 2: 3x3 of them
TILED = SplitInputParams(ks=(4, 4), stride=(2, 2))


@pytest.fixture(scope="module")
def cores():
    return {(cond, fs): LatentDiffusionCore.random_init(
        LatentCoreSpec.tiny(cond, fs_kind=fs), seed=5, device="cpu")
        for cond, fs in (("clip", "kl"), ("bert", "kl"), (None, "vq"))}


@pytest.fixture(scope="module")
def scorer():
    return CLIPScorer.random_init(7, TINY_CLIP, device="cpu")


def _rand(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _equal(a, b):
    return a.shape == b.shape and torch.equal(a, b)


# ---- the energy's gradient ------------------------------------------------ #

@pytest.mark.parametrize("weight_prior", [0.0, 0.1])
@pytest.mark.parametrize("split", [None, TILED])
def test_graphed_energy_gradient_is_energy_grad(cores, scorer, weight_prior, split):
    """The CLIP energy's graphed gradient equals ``energy_grad`` exactly, the
    energy decoding through the eager twin (plain and tiled)."""
    core = cores[("clip", "kl")]
    text = scorer.embed_text(HashTokenizer(96, 16)(["a photo of a dog"]))
    efn = clip_energy_fn(core, scorer, text, weight_prior=weight_prior)
    assert isinstance(efn, GraphedEnergy)
    x, p, t = _rand((2, 8, 8, 4), 1), _rand((2, 8, 8, 4), 2), torch.tensor([3, 9])
    core.split_input_params = split
    try:
        got = efn.grad(x, p, t)
        want = energy_grad(efn.fn, x, p, t)
        assert _equal(got, want) and float(want.abs().max()) > 0
        assert _equal(efn.grad_eager(x, p, t), want)
        assert not (efn._graphed_grad.graphs or core._graphed_decode.graphs)
    finally:
        core.split_input_params = None


def test_graphed_grad_takes_the_named_argument():
    """``GraphedGrad(fn, wrt)`` differentiates argument ``wrt`` only, from a
    detached leaf, in no-grad mode too, and refuses what a replay could not
    give (an input that requires a gradient, in grad mode)."""
    fn = lambda a, b, c: torch.sum(a * b ** 2 + c)          # noqa: E731
    a, b, c = _rand((3, 4), 3), _rand((3, 4), 4), _rand((3, 4), 5)
    g = graphs.GraphedGrad(fn, 1, name="grad")
    with torch.no_grad():
        assert _equal(g(a, b, c), 2 * a * b)
    assert _equal(graphs.input_grad(fn, 0, a, b, c), b ** 2)
    with pytest.raises(RuntimeError, match="no backward"):
        g(a, b.requires_grad_(True), c)


def test_guided_chain_wraps_a_plain_energy(cores):
    """``energy_guided_decode`` with a plain callable (wrapped for the chain)
    and with its ``GraphedEnergy`` gives the same chain."""
    core = cores[(None, "vq")]
    sched = core.make_ddim_schedule(3, 0.1)
    x_T, eps = _rand((1, 8, 8, 4), 6), _rand((3, 1, 8, 8, 4), 7)
    energy = lambda x_t, p, t: torch.sum(p ** 2)              # noqa: E731
    model = lambda x, t: 0.1 * x                                # noqa: E731
    a = energy_guided_decode(model, sched, x_T, eps, None, energy, 0.3)
    b = energy_guided_decode(model, sched, x_T, eps, None, GraphedEnergy(energy), 0.3)
    assert _equal(a, b)


# ---- the first stage and the conditioning ---------------------------------- #

@pytest.mark.parametrize("kind", [("clip", "kl"), ("bert", "kl")])
def test_conditioning_is_its_eager_twin(cores, kind):
    core = cores[kind]
    ids = np.random.default_rng(8).integers(0, 96, size=(3, 16))
    got = core.get_learned_conditioning(ids)
    assert _equal(got, core.get_learned_conditioning_eager(ids))
    assert got.shape == (3, 16, 24) and not core._graphed_cond.graphs


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
@pytest.mark.parametrize("kind", [("clip", "kl"), (None, "vq")], ids=["kl", "vq"])
def test_first_stage_is_its_eager_twin(cores, kind, tiled):
    """Encode and decode of both first-stage kinds, untiled and tiled (3x3
    patches of the 32 px image, then of the 8x8 latent), equal their eager
    twins; a VQ encode ignores the noise it is given."""
    core = cores[kind]
    image = torch.tanh(_rand((2, 32, 32, 3), 9))
    noise = _rand((2, 8, 8, 4), 10)
    try:
        core.split_input_params = SplitInputParams(ks=(16, 16), stride=(8, 8)) if tiled else None
        x0 = core.encode_first_stage(image, noise)
        assert x0.shape == (2, 8, 8, 4)
        assert _equal(x0, core.encode_first_stage_eager(image, noise))
        if kind[1] == "vq":
            assert _equal(x0, core.encode_first_stage(image))
        core.split_input_params = TILED if tiled else None
        img = core.decode_first_stage(x0)
        assert img.shape == (2, 32, 32, 3) and _equal(img, core.decode_first_stage_eager(x0))
    finally:
        core.split_input_params = None
    assert not (core._graphed_encode.graphs or core._graphed_decode.graphs)


def test_kl_encode_without_noise_is_refused(cores):
    with pytest.raises(ValueError, match="needs noise"):
        cores[("clip", "kl")].encode_first_stage(torch.zeros(1, 32, 32, 3))


@pytest.mark.parametrize("split", [None, TILED], ids=["whole", "tiled"])
def test_decode_of_a_latent_that_needs_a_gradient_differentiates(cores, split):
    """In grad mode a grad-requiring latent takes the eager decode, so a
    gradient reaches it (the energy's path); without grad mode it is the
    graphed call's plain result."""
    core = cores[("clip", "kl")]
    z = _rand((1, 8, 8, 4), 11).requires_grad_(True)
    core.split_input_params = split
    try:
        img = core.decode_first_stage(z)
        assert img.grad_fn is not None
        (g,) = torch.autograd.grad(img.square().sum(), z)
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0
        with torch.no_grad():
            assert _equal(core.decode_first_stage(z), core.decode_first_stage_eager(z.detach()))
    finally:
        core.split_input_params = None


# ---- the scorer and the FID ----------------------------------------------- #

@pytest.mark.parametrize("batch", [1, 5])
def test_scorer_embeds_are_their_eager_twins(scorer, batch):
    images = torch.rand((batch, 40, 40, 3), generator=torch.Generator().manual_seed(12))
    assert _equal(scorer.embed_image(images), scorer.embed_image_eager(images))
    assert _equal(scorer.embed_image(images.numpy()), scorer.embed_image_eager(images))
    ids = np.random.default_rng(13).integers(0, 96, size=(batch, 16))
    assert _equal(scorer.embed_text(ids), scorer.embed_text_eager(ids))
    micro = scorer.embed_images_microbatched(images, micro_batch=2)
    assert _equal(micro, torch.cat([scorer.embed_image_eager(images[i:i + 2])
                                    for i in range(0, batch, 2)]))
    assert not (scorer._graphed_image.graphs or scorer._graphed_text.graphs)


def _jax_batches(n: int, size: int):
    """The JAX package's rule, transcribed: each batch of ``size``, and a
    short last one padded to ``size`` by repeating its last image only when
    the images are more than one batch -> [(rows, pad)]."""
    images = np.arange(n)
    out = []
    for i in range(0, images.shape[0], size):
        batch = images[i:i + size]
        pad = 0
        if batch.shape[0] < size and images.shape[0] > size:
            pad = size - batch.shape[0]
            batch = np.concatenate([batch, batch[-1:].repeat(pad, 0)])
        out.append((batch.tolist(), pad))
    return out


@pytest.mark.parametrize("n", [1, 31, 32, 33, 65])
def test_fid_tail_padding_is_jax_rule(n):
    got = []
    for i, stop, pad in fid.padded_batches(n):
        rows = list(range(i, stop))
        got.append((rows + rows[-1:] * pad, pad))
    assert got == _jax_batches(n, fid.BATCH)
    feats = fid.batched_features(lambda b: b.sum(dim=(1, 2, 3))[:, None].repeat(1, 4),
                                 torch.arange(n * 12, dtype=torch.float32).reshape(n, 2, 2, 3))
    calls = [stop - i + pad for i, stop, pad in fid.padded_batches(n)]
    assert set(calls) == {min(n, fid.BATCH)} and feats.shape == (n, 4)


@pytest.mark.parametrize("n", [3, 5])
def test_padded_features_equal_the_unpadded_ones(n):
    """A tiny conv extractor over batches of 2 with the tail padded gives,
    for the real rows, the features of each image alone."""
    conv = torch.nn.Conv2d(3, 4, 3)
    fill_random_(conv, torch.Generator().manual_seed(14))

    def extract(b):
        return conv(b.permute(0, 3, 1, 2)).mean(dim=(2, 3))

    images = torch.rand((n, 9, 9, 3), generator=torch.Generator().manual_seed(15))
    with torch.no_grad():
        got = fid.batched_features(extract, images, size=2)
        want = torch.cat([extract(images[i:i + 1]) for i in range(n)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_inception_features_are_the_eager_tower(tmp_path, monkeypatch):
    """The evaluator's Inception features (graphed call, padded batches)
    equal the eager tower's on the same images: 33 images, two batches of
    32, the second padded with 31 copies."""
    model = InceptionV3Features()
    fill_random_(model, torch.Generator().manual_seed(16))
    model.eval().requires_grad_(False)
    monkeypatch.setattr(fid, "_load_inception", lambda path, device: (model, True))
    monkeypatch.setattr(fid, "_INCEPTION_CACHE", {})
    path = tmp_path / "inception.pth"
    path.write_bytes(b"")
    monkeypatch.setenv(fid.INCEPTION_CKPT_ENV, str(path))
    monkeypatch.setattr(fid, "resize_299_bicubic", lambda x: x)   # a 75 px tower input
    images = np.random.default_rng(17).uniform(size=(33, 75, 75, 3)).astype(np.float32)
    got = fid._inception_features(images, "cpu")
    graphed = next(iter(fid._INCEPTION_CACHE.values()))[2]
    assert isinstance(graphed, graphs.GraphedCall) and not graphed.graphs
    with torch.no_grad():
        x = torch.from_numpy(images)
        want = torch.cat([fid._native_features(model, x[:32]),
                          fid._native_features(model, torch.cat([x[32:]] * 32))[:1]])
    assert got.shape == (33, 2048) and np.isfinite(got).all()
    assert np.array_equal(got, want.numpy().astype(np.float64))


# ---- the signature -------------------------------------------------------- #

def test_signature_carries_split_input_params():
    """A ``SplitInputParams`` is part of the key field by field: none,
    another setting and the same setting give the keys they should, and
    :func:`graphs.rebuild` gives back an equal dataclass; a mutable
    dataclass is refused."""
    z = torch.zeros(1, 8, 8, 4)
    none_key, _ = graphs.signature((z, None))
    key, leaves = graphs.signature((z, TILED))
    assert key != none_key and len(leaves) == 1
    assert graphs.signature((z, SplitInputParams(ks=(4, 4), stride=(2, 2))))[0] == key
    assert graphs.signature((z, dataclasses.replace(TILED, stride=(4, 4))))[0] != key
    assert graphs.signature((z, dataclasses.replace(TILED, tie_braker=True)))[0] != key
    z2, sip = graphs.rebuild(key, [z])
    assert z2 is z and sip == TILED and isinstance(sip, SplitInputParams)

    @dataclasses.dataclass
    class Mutable:
        a: int = 1

    with pytest.raises(TypeError, match="frozen"):
        graphs.signature((z, Mutable()))
