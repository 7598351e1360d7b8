"""The port's optimiser loop against the JAX package's (optax), on the CPU.

* ``runtime.optim``: AdamW and Adafactor behind ``clip_by_global_norm``, on
  every learning-rate schedule the JAX driver builds, step by step against
  optax for 20 steps on seeded parameters and gradients: a factored
  128 x 160 matrix, a vector and a 4-D convolution kernel.  Tolerance: 2e-6
  absolute on parameters of order 1 (float32; optax and the port do the
  same operations, XLA may fuse them differently).
* ``Driver.train`` on the toy regression of JAX's
  ``tests/test_driver_train.py``, with gradient accumulation 2, a ragged
  epoch tail, warmup then linear decay and clipping that triggers: the same
  parameters at the end as the JAX driver's (1e-5: 30 steps of the above).
* Two gloo processes training the toy together end with equal parameters,
  equal to JAX's arithmetic for two processes (each rank's accumulated
  gradients averaged as ``process_allgather(g).mean(0)``, then optax),
  within 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyclediffusion_tpu.runtime.driver import Driver as JDriver
from cyclediffusion_tpu_torch.runtime import optim
from cyclediffusion_tpu_torch.runtime.driver import Driver
from test_torch_common import run_ranks

STEP_TOL = 2e-6
TRAIN_TOL = 1e-5
SHAPES = {"matrix": (128, 160), "vector": (7,), "conv": (3, 3, 8, 16)}
LR = 0.01
SCHEDULES = {   # name -> (warmup_steps, max_steps, lr_scheduler_type)
    "constant": (0, 0, "constant"),
    "warmup": (5, 0, "constant"),
    "linear": (0, 20, "linear"),
    "warmup_linear": (5, 20, "linear"),
}


def _optax_schedule(warmup: int, total: int, kind: str):
    """The JAX driver's schedule (``Driver._build_optimizer``)."""
    if kind == "linear" and total > 0:
        if warmup > 0:
            return optax.join_schedules([optax.linear_schedule(0.0, LR, warmup),
                                         optax.linear_schedule(LR, 0.0, max(total - warmup, 1))],
                                        boundaries=[warmup])
        return optax.linear_schedule(LR, 0.0, total)
    return optax.linear_schedule(0.0, LR, warmup) if warmup > 0 else LR


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    warmup, total, kind = SCHEDULES[name]
    want = _optax_schedule(warmup, total, kind)
    got = optim.build_schedule(LR, warmup, total, kind)
    for count in range(30):
        w = float(want(count)) if callable(want) else float(np.float32(want))
        assert got(count) == pytest.approx(w, rel=1e-6, abs=1e-12), count


@pytest.mark.parametrize("scale", [1e-3, 0.1])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(3)
    grads = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    want, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    got = {k: torch.tensor(v) for k, v in grads.items()}
    norm = optim.clip_by_global_norm_(got.values(), 1.0)
    assert (float(norm) >= 1.0) == (scale > 0.01)      # the global norm is ~146 x scale
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_optimisers_follow_optax(opt_name, sched):
    warmup, total, kind = SCHEDULES[sched]
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    lr = _optax_schedule(warmup, total, kind)
    base = (optax.adafactor(learning_rate=lr) if opt_name == "adafactor"
            else optax.adamw(learning_rate=lr, weight_decay=0.1))
    tx = optax.chain(optax.clip_by_global_norm(5.0), base)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jparams)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = optim.build_optimizer(list(params.values()), opt_name,
                                optim.build_schedule(LR, warmup, total, kind), 0.1)
    assert optim.factored_dims(SHAPES["matrix"]) is not None
    for step in range(20):
        grads = {k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.tensor(grads[k])
        optim.clip_by_global_norm_([p.grad for p in params.values()], 5.0)
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=STEP_TOL, err_msg=f"{k} at step {step}")
    moved = max(float(np.abs(params[k].numpy() - p0[k]).max()) for k in p0)
    assert moved > 1e-3


# the toy regression of tests/test_driver_train.py
W_TRUE = np.array([1.0, -2.0, 0.5], np.float32)


def _toy_items(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 3).astype(np.float32)
    return [{"x": xs[i], "y": np.float32(xs[i] @ W_TRUE)} for i in range(n)]


class _Items:
    def __init__(self, items):
        self.items = items

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


class _JaxToy:
    def __init__(self):
        self.trainable_params = {"w": jnp.zeros((3,))}

    @staticmethod
    def loss_fn(params, batch, key):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


class _Toy:
    def __init__(self):
        self.trainable_params = {"w": torch.zeros(3)}

    @staticmethod
    def loss_fn(params, batch, generator):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _train_args(tmp, optim_name: str, **kw):
    d = dict(output_dir=str(tmp), num_train_epochs=6, learning_rate=0.1,
             per_device_train_batch_size=4, gradient_accumulation_steps=2, logging_steps=0,
             save_steps=0, seed=0, max_grad_norm=0.5, weight_decay=0.01, optim=optim_name,
             warmup_steps=3, max_steps=30, lr_scheduler_type="linear")
    d.update(kw)
    return types.SimpleNamespace(**d)


@pytest.mark.parametrize("optim_name", ["adamw", "adafactor"])
def test_toy_regression_ends_where_jax_ends(tmp_path, optim_name):
    """37 items in batches of 4: 9 micro-batches an epoch, so 4 steps and a
    ragged tail that the next epoch drops; clipping at 0.5 triggers."""
    items = _toy_items(37)
    jmodel, model = _JaxToy(), _Toy()
    jm = JDriver(_train_args(tmp_path / "jax", optim_name), jmodel,
                 train_dataset=_Items(items)).train()
    m = Driver(_train_args(tmp_path / "port", optim_name), model,
               train_dataset=_Items(items)).train()
    np.testing.assert_allclose(model.trainable_params["w"].numpy(),
                               np.asarray(jmodel.trainable_params["w"]), rtol=0, atol=TRAIN_TOL)
    assert m["train_loss"] == pytest.approx(jm["train_loss"], rel=1e-4, abs=TRAIN_TOL)
    assert m["train_steps_per_second"] > 0 and "train_runtime" in m


def test_no_step_warns_and_logs(tmp_path, caplog):
    """A shard smaller than the batch runs no step, as in JAX."""
    model = _Toy()
    driver = Driver(_train_args(tmp_path, "adamw", per_device_train_batch_size=8), model,
                    train_dataset=_Items(_toy_items(5)))
    m = driver.train()
    assert "train_loss" not in m and "No optimizer step ran" in caplog.text
    assert torch.equal(model.trainable_params["w"], torch.zeros(3))


TRAIN_CHILD = """
import types
from cyclediffusion_tpu_torch.runtime.driver import Driver

class Toy:
    def __init__(self):
        self.trainable_params = {"w": torch.zeros(3)}

    @staticmethod
    def loss_fn(params, batch, generator):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

data = np.load(os.path.join(work, "toy.npz"))
items = [{"x": x, "y": y} for x, y in zip(data["x"], data["y"])]
args = types.SimpleNamespace(**json.loads(open(os.path.join(work, "args.json")).read()))
args.output_dir = os.path.join(work, f"out{rank}")
model = Toy()
metrics = Driver(args, model, train_dataset=items).train()
np.save(os.path.join(work, f"w{rank}.npy"), model.trainable_params["w"].numpy())
"""


def _jax_two_process_w(items, args) -> np.ndarray:
    """JAX's loop for two processes in lockstep: each rank's shard
    ``order[rank::2]``, its accumulated gradients divided by the
    accumulation, ``process_allgather(g).mean(axis=0)`` across the ranks,
    then the JAX driver's optax chain."""
    jd = JDriver(args, _JaxToy())
    params = {"w": jnp.zeros((3,))}
    tx, state = jd._build_optimizer(params)
    grad_fn = jax.jit(jax.grad(_JaxToy.loss_fn))
    rng = np.random.RandomState(args.seed)
    bs, accum = args.per_device_train_batch_size, args.gradient_accumulation_steps
    for _ in range(args.num_train_epochs):
        order = rng.permutation(len(items))
        shards = [order[r::2] for r in range(2)]
        acc = [None, None]
        for i in range(0, min(len(s) for s in shards) - bs + 1, bs):
            for r, shard in enumerate(shards):
                batch = {k: np.stack([items[int(j)][k] for j in shard[i:i + bs]])
                         for k in ("x", "y")}
                g = grad_fn(params, batch, None)
                acc[r] = g if acc[r] is None else jax.tree.map(lambda a, b: a + b, acc[r], g)
            if (i // bs + 1) % accum == 0:
                means = [jax.tree.map(lambda g: g / accum, a) for a in acc]
                mean = jax.tree.map(lambda *g: jnp.stack(g).mean(axis=0), *means)
                updates, state = tx.update(mean, state, params)
                params = optax.apply_updates(params, updates)
                acc = [None, None]
    return np.asarray(params["w"])


def test_two_processes_train_to_jax_two_process_arithmetic(tmp_path):
    import json

    items = _toy_items(40, seed=1)
    np.savez(tmp_path / "toy.npz", x=np.stack([it["x"] for it in items]),
             y=np.stack([it["y"] for it in items]))
    args = _train_args(tmp_path, "adamw", num_train_epochs=4, max_steps=8)
    with open(tmp_path / "args.json", "w") as f:
        json.dump(vars(args), f)
    run_ranks(TRAIN_CHILD, 2, tmp_path, timeout=120)
    w0, w1 = np.load(tmp_path / "w0.npy"), np.load(tmp_path / "w1.npy")
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_allclose(w0, _jax_two_process_w(items, args), rtol=0, atol=TRAIN_TOL)
