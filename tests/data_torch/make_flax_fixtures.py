"""Writes the Flax and optax fixtures under ``tests/data_torch/flax/`` for
tests and ``chip_smoke.py`` (whose machine has neither flax nor optax).

    python tests/data_torch/make_flax_fixtures.py

* ``tree.msgpack``: ``flax.serialization.to_bytes`` of :func:`fixture_tree`,
  a seeded tree with float32, bfloat16, float16, int32, uint8 and bool
  arrays, an empty array, numpy and Python scalars, a complex number and
  nested lists; ``tree.npz`` holds the same leaves keyed by their
  ``/``-joined path, bfloat16 leaves as their uint16 bits under
  ``<path>.bf16bits``.
* ``optax_trajectories.npz``: for each optimiser (``adamw``, ``adafactor``)
  the parameters after :data:`STEPS` steps of ``optax.chain(
  clip_by_global_norm(CLIP), <optimiser>)`` on the warmup-then-decay
  schedule, from seeded parameters and gradients (:func:`problem`), with
  the problem's settings and its first gradient (to check that numpy draws
  the same gradients on the machine that reads it).
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flax")

# the optimiser problem: parameter name -> shape (a factored matrix, a
# vector, a convolution kernel), the schedule and the clip
SHAPES = {"conv": (3, 3, 8, 16), "matrix": (128, 160), "vector": (7,)}
STEPS, LR, WARMUP, WEIGHT_DECAY, CLIP = 20, 0.01, 5, 0.1, 5.0
SEED = 0


def problem():
    """(initial parameters, the gradient of each step): seeded normals, each
    step's gradients drawn in ``SHAPES`` order, scaled by 3."""
    rng = np.random.default_rng(SEED)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def fixture_tree():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    return {
        "unet": {"conv_in": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                             "bias": rng.standard_normal(8).astype(np.float32)}},
        "half": rng.standard_normal((5, 3)).astype(np.float16),
        "brain": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
        "ids": rng.integers(-2**31, 2**31 - 1, (9,), dtype=np.int32),
        "pixels": rng.integers(0, 256, (2, 3, 3), dtype=np.uint8),
        "mask": rng.random((4,)) > 0.5,
        "empty": np.zeros((0, 5), np.float32),
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-3), "py_int": 70000,
                    "py_float": -1.25, "py_bool": True, "complex": 1.5 - 2j},
        "layers": [rng.standard_normal(3).astype(np.float32),
                   [np.arange(4, dtype=np.int32), np.float32(-0.5)]],
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def npz_twin(tree) -> dict:
    out = {}
    for path, leaf in _flat(tree):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            out[path + ".bf16bits"] = arr.view(np.uint16)
        else:
            out[path] = arr
    return out


def trajectories() -> dict:
    import jax.numpy as jnp
    import optax

    schedule = optax.join_schedules([optax.linear_schedule(0.0, LR, WARMUP),
                                     optax.linear_schedule(LR, 0.0, STEPS - WARMUP)], [WARMUP])
    params0, grads = problem()
    out = {"steps": STEPS, "lr": LR, "warmup": WARMUP, "weight_decay": WEIGHT_DECAY,
           "clip": CLIP, "seed": SEED, "grad0_vector": grads[0]["vector"]}
    for name, base in (("adamw", optax.adamw(schedule, weight_decay=WEIGHT_DECAY)),
                       ("adafactor", optax.adafactor(schedule))):
        tx = optax.chain(optax.clip_by_global_norm(CLIP), base)
        params = {k: jnp.asarray(v) for k, v in params0.items()}
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
            params = optax.apply_updates(params, updates)
        for k, v in params.items():
            out[f"{name}/{k}"] = np.asarray(v)
    return out


def main() -> None:
    import flax.serialization

    os.makedirs(HERE, exist_ok=True)
    tree = fixture_tree()
    with open(os.path.join(HERE, "tree.msgpack"), "wb") as f:
        f.write(flax.serialization.to_bytes(tree))
    np.savez(os.path.join(HERE, "tree.npz"), **npz_twin(tree))
    np.savez(os.path.join(HERE, "optax_trajectories.npz"), **trajectories())
    for name in sorted(os.listdir(HERE)):
        print(name, os.path.getsize(os.path.join(HERE, name)))


if __name__ == "__main__":
    main()
