"""The port's Flax msgpack reader and writer (``convert.flax_msgpack``)
against ``flax.serialization``, the port's ``Driver`` reading the JAX
driver's ``model_params.msgpack``, and the JAX package reading the port's.

* Trees written by ``flax.serialization.to_bytes`` — float32, bfloat16,
  float16, int32, uint8 and bool arrays, numpy and Python scalars, a
  complex number, None, empty arrays, nested lists — read back equal to
  ``flax.serialization.msgpack_restore``'s, leaf by leaf, bit for bit and
  dtype for dtype (bfloat16 as a ``torch.bfloat16`` tensor of the same
  bits).  Arrays above Flax's ``MAX_CHUNK_SIZE`` (lowered here) arrive
  chunked and are joined back.
* The committed fixture ``tests/data_torch/flax/tree.msgpack`` equals its
  ``.npz`` twin bit for bit (``chip_smoke.py`` reads the same pair).
* A checkpoint saved by the JAX ``Driver`` of a model holding the tiny text
  config's core loads into the port's task model for that config through
  its ``Driver``; the port's core then gives the JAX core's eps and text
  conditioning on the same input (1e-4, the tiny models' port-vs-JAX bound
  in ``test_torch_models.py``), and ``trainable_params`` come back as
  tensors, bit for bit.
* The writer gives ``flax.serialization.to_bytes``'s bytes for the same
  trees (torch tensors, a bfloat16 one by its bits, for arrays), chunked
  arrays included.
* ``Driver.save_model`` writes ``model_params.msgpack`` for a tiny
  SD-like core (CLIP text), an LDM-BERT core, a VQ core and both pixel
  UNet families, each loaded into the port from a seeded JAX tree by
  ``from_jax``: ``msgpack_restore`` and ``from_bytes`` with the JAX tree
  as template give every leaf's dtype, shape and values bit for bit, and
  the JAX ``Driver.load_model`` restores it (``trainable_params`` too); a
  bfloat16 core goes through with its bits.  ``convert.to_jax``'s layout
  of each full-width model (SD v1, LDM text2img-large's LDM-BERT, the FFHQ
  LDM, the AFHQ and CelebA-HQ pixel UNets, built on the ``meta`` device)
  equals ``jax.eval_shape``'s tree path for path, shape for shape.
"""

import os
import types

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.models import text_encoders as jte
from cyclediffusion_tpu.pipelines import zoo as jzoo
from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
from cyclediffusion_tpu.pipelines.latent import LatentDiffusionCore as JCore
from cyclediffusion_tpu.runtime import context as jcontext
from cyclediffusion_tpu.runtime.driver import Driver as JDriver
from cyclediffusion_tpu_torch.convert import flax_msgpack
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.convert.to_jax import flax_layout
from cyclediffusion_tpu_torch.models import text_encoders as te
from cyclediffusion_tpu_torch.pipelines import zoo
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.runtime.driver import Driver
from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import (
    TextUnsupervisedTranslation,
)
from test_torch_common import REPO, fill_flax_tree, max_abs, tiny_latent_cores

FIXTURES = os.path.join(REPO, "tests", "data_torch", "flax")
CFG = "experiments/tiny_text_translation.cfg"
EPS_TOL = 1e-4


def _assert_same(got, want, path="") -> None:
    """``got`` (the port's read) equals ``want`` (flax's restore): keys,
    dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(want).view(np.uint16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, type(got))
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _trees():
    rng = np.random.default_rng(0)
    return {
        "f32": {"params": {"dense": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                                     "bias": np.zeros(3, np.float32)}}},
        "bf16": {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
                 "s": jnp.bfloat16(1.5)},
        "f16": {"w": rng.standard_normal((2, 2, 3)).astype(np.float16)},
        "int32": {"ids": rng.integers(-2**31, 2**31 - 1, (17,), dtype=np.int32)},
        "uint8": {"img": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)},
        "bool": {"mask": rng.random(9) > 0.5, "flag": np.bool_(True)},
        "scalars": {"f32": np.float32(-2.5), "f64": np.float64(1e300), "i64": np.int64(-2**40),
                    "u8": np.uint8(200), "int": -7, "big": 2**62, "float": 0.1,
                    "true": True, "none": None, "str": "ε", "complex": 3 - 4j},
        "empty": {"e": np.zeros((0, 3), np.float32), "e2": np.zeros((2, 0), np.int32)},
        "nested": {"blocks": [np.ones(2, np.float32),
                              [np.arange(3, dtype=np.int32), {"x": np.float32(1.0)}],
                              ()]},
        "long_map": {f"k{i}": np.full((1,), i, np.int32) for i in range(20)},
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_reads_what_flax_writes(name):
    data = fser.to_bytes(_trees()[name])
    _assert_same(flax_msgpack.from_bytes(data), fser.msgpack_restore(data))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_arrays_are_joined(monkeypatch, dtype):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(3 * 50, dtype=np.float32).reshape(3, 50)
    tree = {"big": jnp.asarray(arr, dtype), "small": np.ones(2, np.float32)}
    data = fser.to_bytes(tree)
    raw = flax_msgpack.unpackb(data)
    assert raw["big"][flax_msgpack.CHUNKED] and len(raw["big"]["chunks"]) > 1
    _assert_same(flax_msgpack.from_bytes(data), fser.msgpack_restore(data))


def test_malformed_input_raises():
    data = fser.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.from_bytes(data[:-2])
    with pytest.raises(ValueError, match="after the object"):
        flax_msgpack.from_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="no type code"):
        flax_msgpack.from_bytes(b"\xc1")


def test_committed_fixture_equals_its_npz_twin():
    tree = flax_msgpack.read(os.path.join(FIXTURES, "tree.msgpack"))
    twin = np.load(os.path.join(FIXTURES, "tree.npz"))
    with open(os.path.join(FIXTURES, "tree.msgpack"), "rb") as f:
        _assert_same(tree, fser.msgpack_restore(f.read()))

    def flat(t, prefix=""):
        for k, v in t.items():
            yield from (flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])

    leaves = dict(flat(tree))
    assert {k.removesuffix(".bf16bits") for k in twin.files} == set(leaves)
    for key in twin.files:
        leaf = leaves[key.removesuffix(".bf16bits")]
        if key.endswith(".bf16bits"):
            leaf = leaf.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(np.asarray(leaf), twin[key], err_msg=key)
        assert np.asarray(leaf).dtype == twin[key].dtype, key


@pytest.fixture
def no_clip_assets(monkeypatch):
    for var in ("CYCLEDIFFUSION_CLIP_CKPT", "CYCLEDIFFUSION_CLIP_BPE",
                "CYCLEDIFFUSION_FOLDED_ATTN"):
        monkeypatch.delenv(var, raising=False)
    jcontext.reset()
    context.reset()
    yield
    jcontext.reset()
    context.reset()


def test_jax_driver_checkpoint_loads_into_the_port(tmp_path, no_clip_assets):
    """The JAX ``Driver`` saves a JAX model holding the tiny text config's
    core (``LatentCoreSpec.tiny("clip")``, seeded weights); the port's task
    model built from that config (other weights) loads it."""
    jcore, _ = tiny_latent_cores(cond_kind="clip", seed=5)
    jmodel = types.SimpleNamespace(gan_wrapper=types.SimpleNamespace(core=jcore))
    JDriver(types.SimpleNamespace(output_dir=str(tmp_path)), jmodel).save_model()
    assert os.path.exists(tmp_path / "model_params.msgpack")

    model = TextUnsupervisedTranslation(get_config(CFG), base_seed=1, device="cpu")
    core = model.gan_wrapper.core
    rng = np.random.default_rng(0)
    spec = jcore.spec
    x = rng.standard_normal((2, spec.image_size, spec.image_size, spec.channels))
    ctx = rng.standard_normal((2, 8, spec.unet.context_dim))
    t = np.array([3, 900])
    want = np.asarray(jcore.apply_model(jnp.asarray(x, jnp.float32), jnp.asarray(t),
                                        jnp.asarray(ctx, jnp.float32)))
    args = [torch.tensor(x, dtype=torch.float32), torch.tensor(t),
            torch.tensor(ctx, dtype=torch.float32)]
    assert max_abs(core.apply_model(*args), want) > 100 * EPS_TOL   # other weights first
    Driver(types.SimpleNamespace(output_dir=str(tmp_path / "port")), model).load_model(
        str(tmp_path))
    assert max_abs(core.apply_model(*args), want) < EPS_TOL
    ids = np.arange(16).reshape(2, 8) % 96
    np.testing.assert_allclose(core.get_learned_conditioning(ids).numpy(),
                               np.asarray(jcore.get_learned_conditioning(ids)), atol=EPS_TOL)


class _Trainable:
    def __init__(self, w):
        self.trainable_params = {"w": w}


def test_trainable_params_come_back_as_tensors(tmp_path):
    w = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    JDriver(types.SimpleNamespace(output_dir=str(tmp_path)),
            _Trainable(jnp.asarray(w))).save_model()
    model = _Trainable(torch.zeros(3, 4, dtype=torch.float64))
    Driver(types.SimpleNamespace(output_dir=str(tmp_path / "port")), model).load_model(
        str(tmp_path))
    got = model.trainable_params["w"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), w)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="model_params.msgpack"):
        Driver(types.SimpleNamespace(output_dir=str(tmp_path)),
               _Trainable(torch.zeros(1))).load_model(str(tmp_path))


def test_jax_arrays_restore_through_flax_too():
    """A sanity check of the premise: ``msgpack_restore`` of a jax array
    gives numpy back (what ``_assert_same`` compares against)."""
    data = fser.to_bytes({"a": jax.numpy.ones(2)})
    assert isinstance(fser.msgpack_restore(data)["a"], np.ndarray)


# ---- the writer ------------------------------------------------------------- #

def _port_leaves(tree):
    """A Flax state dict with the port's leaves: numpy arrays, a bfloat16
    array as a ``torch.bfloat16`` tensor of its bits (numpy scalars stay)."""
    if isinstance(tree, dict):
        return {k: _port_leaves(v) for k, v in tree.items()}
    if isinstance(tree, jax.Array):
        tree = np.asarray(tree)
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return tree


@pytest.mark.parametrize("name", sorted(_trees()))
def test_writes_what_flax_writes(name):
    tree = _trees()[name]
    want = fser.to_bytes(tree)
    got = flax_msgpack.to_bytes(_port_leaves(fser.to_state_dict(tree)))
    assert got == want
    _assert_same(flax_msgpack.from_bytes(got), fser.msgpack_restore(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_writes_chunked_arrays_as_flax(monkeypatch, tmp_path, dtype):
    """An array above ``MAX_CHUNK_SIZE`` bytes (lowered to 64 in both
    packages) is split into Flax's chunks; :func:`write` streams the same
    bytes to a file."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(3 * 50, dtype=np.float32).reshape(3, 50)
    tree = {"big": jnp.asarray(arr, dtype), "small": np.ones(2, np.float32),
            "edge": np.ones(16, np.float32)}
    want = fser.to_bytes(tree)
    port = _port_leaves(fser.to_state_dict(tree))
    assert flax_msgpack.unpackb(flax_msgpack.to_bytes(port))["big"][flax_msgpack.CHUNKED]
    assert flax_msgpack.to_bytes(port) == want
    assert flax_msgpack.write(str(tmp_path / "t.msgpack"), port) == len(want)
    assert (tmp_path / "t.msgpack").read_bytes() == want


def test_writer_refuses_what_flax_would_not_store():
    with pytest.raises(ValueError, match="dict keyed by position"):
        flax_msgpack.to_bytes({"a": [1, 2]})
    with pytest.raises(ValueError, match="cannot write"):
        flax_msgpack.to_bytes({"a": object()})


# ---- the port's checkpoints in the JAX package ------------------------------- #

def _assert_tree_bits(got, want, path="") -> None:
    """Every leaf of ``want`` (the JAX tree) in ``got`` (a restore of the
    port's file): the same keys, dtype, shape and bits."""
    if isinstance(want, dict) or hasattr(want, "items"):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want))[:4])
        for k in want:
            _assert_tree_bits(got[k], want[k], f"{path}/{k}")
        return
    want, got = np.asarray(want), np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, got.shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=path)


def _restore_in_jax(tmp_path, jmodel, want: dict) -> None:
    """The port's ``model_params.msgpack`` under ``tmp_path``: restored by
    ``msgpack_restore``, by ``from_bytes`` with ``want`` (the JAX tree) as
    template, and by the JAX ``Driver`` into ``jmodel`` (other weights)."""
    data = (tmp_path / "model_params.msgpack").read_bytes()
    _assert_tree_bits(fser.msgpack_restore(data), want)
    _assert_tree_bits(fser.from_bytes(jax.tree.map(np.zeros_like, want), data), want)
    JDriver(types.SimpleNamespace(output_dir=str(tmp_path / "jax")), jmodel).load_model(
        str(tmp_path))
    wrapper = jmodel.gan_wrapper
    _assert_tree_bits({"gan_wrapper": wrapper.params if hasattr(wrapper, "params")
                       else wrapper.core.params,
                       "trainable_params": jmodel.trainable_params}, want)


@pytest.mark.parametrize("cond_kind,fs_kind", [("clip", "kl"), ("bert", "kl"), (None, "vq")])
def test_port_checkpoint_of_a_latent_core_restores_in_jax(tmp_path, cond_kind, fs_kind):
    jcore, core = tiny_latent_cores(cond_kind=cond_kind, fs_kind=fs_kind, seed=5)
    w = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    model = types.SimpleNamespace(gan_wrapper=types.SimpleNamespace(core=core),
                                  trainable_params={"w": torch.from_numpy(w)})
    Driver(types.SimpleNamespace(output_dir=str(tmp_path)), model).save_model()
    want = {"gan_wrapper": jax.tree.map(np.asarray, jcore.params), "trainable_params": {"w": w}}
    zeros = jax.tree.map(jnp.zeros_like, jcore.params)
    jmodel = types.SimpleNamespace(
        gan_wrapper=types.SimpleNamespace(core=JCore(jcore.spec, zeros)),
        trainable_params={"w": jnp.zeros((3, 4))})
    _restore_in_jax(tmp_path, jmodel, want)


@pytest.mark.parametrize("kind", ["improved", "compvis"])
def test_port_checkpoint_of_a_pixel_unet_restores_in_jax(tmp_path, kind):
    jmod = jzoo.build_pixel_model(jzoo.tiny_pixel_spec(16, kind))
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a)), fill_flax_tree(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                       jnp.zeros((1,), jnp.int32)), 4))       # float32, as JAX holds it
    unet = zoo.build_pixel_model(zoo.tiny_pixel_spec(16, kind))
    load_flax_params(unet, tree)
    model = types.SimpleNamespace(gan_wrapper=types.SimpleNamespace(model=unet),
                                  trainable_params={"w": torch.ones(2)})
    Driver(types.SimpleNamespace(output_dir=str(tmp_path)), model).save_model()
    want = {"gan_wrapper": jax.tree.map(np.asarray, tree),
            "trainable_params": {"w": np.ones(2, np.float32)}}
    jmodel = types.SimpleNamespace(
        gan_wrapper=types.SimpleNamespace(params=jax.tree.map(jnp.zeros_like, tree)),
        trainable_params={"w": jnp.zeros(2)})
    _restore_in_jax(tmp_path, jmodel, want)


def test_bfloat16_core_round_trips_bit_for_bit(tmp_path):
    """A bfloat16 core (the card's SD dtype) is written with its bits: JAX
    restores bfloat16 leaves equal to the port's weights, and the port's
    ``load_model`` puts them back into another bfloat16 core exactly."""
    spec = LatentCoreSpec.tiny("clip")
    cores = [LatentDiffusionCore.random_init(spec, seed, "cpu", dtype=torch.bfloat16)
             for seed in (1, 2)]
    Driver(types.SimpleNamespace(output_dir=str(tmp_path)),
           types.SimpleNamespace(gan_wrapper=types.SimpleNamespace(core=cores[0]))).save_model()
    restored = fser.msgpack_restore((tmp_path / "model_params.msgpack").read_bytes())
    kernel = restored["gan_wrapper"]["unet"]["params"]["time_embed_0"]["kernel"]
    assert kernel.dtype.name == "bfloat16"
    weight = cores[0].unet.time_embed[0].weight.t().contiguous()
    np.testing.assert_array_equal(kernel.view(np.uint16),
                                  weight.view(torch.int16).numpy().view(np.uint16))
    Driver(types.SimpleNamespace(output_dir=str(tmp_path / "port")),
           types.SimpleNamespace(gan_wrapper=types.SimpleNamespace(core=cores[1]))).load_model(
        str(tmp_path))
    want, got = cores[0].state_dict(), cores[1].state_dict()
    assert want.keys() == got.keys()
    assert all(got[k].dtype == torch.bfloat16 and torch.equal(want[k], got[k]) for k in want)


def _jax_shapes(module, *args) -> dict:
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    return {tuple(getattr(k, "key", str(k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}


def _full_width(name):
    """(port modules built on the meta device, JAX modules with their init
    arguments) of one full-width model, by part."""
    z = jnp.zeros
    if name in ("sd_v1", "ldm_ffhq256"):
        spec, jspec = getattr(LatentCoreSpec, name)(), getattr(JSpec, name)()
        core, jcore = LatentDiffusionCore(spec, "meta"), JCore(jspec, {})
        lat, ch = jspec.image_size, jspec.channels
        img = z((1, jspec.resolution, jspec.resolution, 3))
        ctx = None if jspec.cond_kind is None else z((1, 8, jspec.unet.context_dim))
        fs_args = (img, z((1, lat, lat, jspec.embed_dim))) if jspec.fs_kind == "kl" else (img,)
        parts = {"unet": (core.unet, jcore.unet, (z((1, lat, lat, ch)), z((1,), jnp.int32), ctx)),
                 "first_stage": (core.first_stage, jcore.first_stage, fs_args)}
        if jspec.cond_kind is not None:
            parts["cond"] = (core.cond_model, jcore.cond_model, (z((1, 8), jnp.int32),))
        return parts
    if name == "ldm_bert":
        cfg = LatentCoreSpec.ldm_text2img_large().cond_cfg
        with torch.device("meta"):
            bert = te.LDMBertEncoder(cfg)
        jbert = jte.LDMBertEncoder(JSpec.ldm_text2img_large().cond_cfg)
        return {"cond": (bert, jbert, (z((1, 77), jnp.int32),))}
    spec = zoo.PIXEL_ZOO[name]
    with torch.device("meta"):
        unet = zoo.build_pixel_model(spec)
    r = spec.resolution
    return {"unet": (unet, jzoo.build_pixel_model(jzoo.PIXEL_ZOO[name]),
                     (z((1, r, r, 3)), z((1,), jnp.int32)))}


@pytest.mark.parametrize("name", ["sd_v1", "ldm_bert", "ldm_ffhq256", "afhqdog256", "celeba256"])
def test_full_width_layouts_equal_jax(name):
    """Where the Flax module boundaries fall comes from the port's module
    tree, not its dotted names; at full width every path and shape must
    be JAX's."""
    for part, (module, jmodule, args) in _full_width(name).items():
        assert flax_layout(module) == _jax_shapes(jmodule, *args), (name, part)
