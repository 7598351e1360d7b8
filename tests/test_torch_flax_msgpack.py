"""The port's Flax msgpack reader (``convert.flax_msgpack``) against
``flax.serialization``, and the port's ``Driver`` reading the JAX
driver's ``model_params.msgpack``.

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
"""

import os
import types

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.runtime import context as jcontext
from cyclediffusion_tpu.runtime.driver import Driver as JDriver
from cyclediffusion_tpu_torch.convert import flax_msgpack
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.runtime.driver import Driver
from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import (
    TextUnsupervisedTranslation,
)
from test_torch_common import REPO, max_abs, tiny_latent_cores

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
