"""The port's driver against the JAX package's: ``EvalLoader``'s sharding and
batching, the cross-process gather, checkpoint save / resume / rotation /
best tracking, the metric files, the no-op ``train``, one step of the
optimiser loop and the wandb gate.
Batching and ordering are compared exactly; saved weights round-trip bit
for bit.
"""

import builtins
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from cyclediffusion_tpu.runtime import driver as jdriver
from cyclediffusion_tpu_torch.runtime import profiling
from cyclediffusion_tpu_torch.runtime.driver import (
    Driver,
    EvalLoader,
    TrainerState,
    gather_sharded_outputs,
    speed_metrics,
)


class _DS(list):
    pass


def _items(n):
    return [{"sample_id": np.asarray(i), "text": f"t{i}"} for i in range(n)]


def _batches(loader):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in b.items()}
            for b in loader]


def test_single_process_batching():
    loader = EvalLoader(_DS(_items(7)), batch_size=3)
    batches = list(loader)
    assert len(loader) == 3 and [b["sample_id"].shape[0] for b in batches] == [3, 3, 1]
    assert isinstance(batches[0]["sample_id"], np.ndarray)
    assert batches[0]["text"] == ["t0", "t1", "t2"]
    assert _batches(loader) == _batches(jdriver.EvalLoader(_DS(_items(7)), batch_size=3))


def test_multi_process_contiguous_shards():
    """Each of 3 shards holds ceil(10/3) items; the first 10 positions in
    process-major order cover the dataset once, as in JAX."""
    ds = _DS(_items(10))
    per_rank = []
    for rank in range(3):
        loader = EvalLoader(ds, batch_size=2, process_index=rank, process_count=3)
        want = jdriver.EvalLoader(ds, batch_size=2, process_index=rank, process_count=3)
        assert _batches(loader) == _batches(want)
        per_rank.append([s for b in loader for s in b["sample_id"].tolist()])
        assert len(per_rank[-1]) == 4
    assert [s for shard in per_rank for s in shard][:10] == list(range(10))


def test_excess_processes_wrap_pad():
    loader = EvalLoader(_DS(_items(2)), batch_size=2, process_index=3, process_count=4)
    assert len(loader) == 1 and next(iter(loader))["sample_id"].tolist() == [0]


def test_gather_matches_jax_and_needs_an_allgather():
    """Two processes' shards through an injected allgather (a stack of both
    shards, as on one host), against the JAX gather."""
    n, p = 5, 2
    shards = [np.arange(3) + 10 * r for r in range(p)]
    fake = lambda x: np.stack([shards[0], shards[1]])[:, :x.shape[0]]      # noqa: E731
    got = gather_sharded_outputs({"a": shards[0]}, n, p, allgather=fake)
    want = jdriver.gather_sharded_outputs({"a": shards[0]}, n, p, allgather=fake)
    np.testing.assert_array_equal(got["a"], want["a"])
    single = gather_sharded_outputs({"a": np.ones((2, 3))}, 3, 1)
    np.testing.assert_array_equal(single["a"], np.array([[1] * 3, [1] * 3, [0] * 3]))
    with pytest.raises(RuntimeError, match="process group"):
        gather_sharded_outputs({"a": shards[0]}, n, p)


def test_speed_metrics():
    m = speed_metrics("eval", time.time() - 2.0, num_samples=4, num_steps=2)
    assert set(m) == {"eval_runtime", "eval_samples_per_second", "eval_steps_per_second"}
    assert 1.5 < m["eval_samples_per_second"] < 2.1


class _FakeWrapper:
    def __init__(self, value):
        self.core = torch.nn.Linear(4, 4)
        torch.nn.init.constant_(self.core.weight, value)
        self.resolution = 16


class _FakeModel:
    def __init__(self, value=1.0):
        self.gan_wrapper = _FakeWrapper(value)


def _args(tmp_path, **kw):
    d = dict(output_dir=str(tmp_path), per_device_eval_batch_size=1, save_total_limit=2,
             metric_for_best_model="score", greater_is_better=True, num_train_epochs=0)
    d.update(kw)
    return types.SimpleNamespace(**d)


def test_save_load_roundtrip(tmp_path):
    model = _FakeModel(3.0)
    driver = Driver(_args(tmp_path), model)
    driver.save_model()
    assert os.path.exists(os.path.join(tmp_path, "model_params.msgpack"))
    with open(os.path.join(tmp_path, "training_args.json")) as f:
        assert json.load(f)["save_total_limit"] == 2
    torch.nn.init.zeros_(model.gan_wrapper.core.weight)
    driver.load_model(str(tmp_path))
    torch.testing.assert_close(model.gan_wrapper.core.weight, torch.full((4, 4), 3.0),
                               rtol=0, atol=0)


def test_checkpoint_rotation_keeps_best(tmp_path):
    driver = Driver(_args(tmp_path), _FakeModel())
    for step, score in ((1, 0.9), (2, 0.5), (3, 0.7)):
        driver.state.global_step = step
        driver._save_checkpoint(metrics={"eval_score": score})
    remaining = sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint-"))
    assert remaining == ["checkpoint-1", "checkpoint-3"]     # the best survives
    assert driver.state.best_metric == 0.9
    st = TrainerState.load(os.path.join(tmp_path, "checkpoint-3", "trainer_state.json"))
    assert st.best_model_checkpoint.endswith("checkpoint-1")
    assert np.load(os.path.join(tmp_path, "checkpoint-3", "rng_state_0.npy")).shape == (624,)


def test_train_noop_matches_reference_usage(tmp_path):
    driver = Driver(_args(tmp_path), _FakeModel(), train_dataset=[])
    assert "train_runtime" in driver.train()
    assert driver.state.log_history[-1]["step"] == 0


def test_metrics_save_and_combined(tmp_path):
    driver = Driver(_args(tmp_path), _FakeModel())
    driver.save_metrics("eval", {"eval_psnr": 30.0})
    driver.save_metrics("test", {"test_psnr": 29.0})
    with open(os.path.join(tmp_path, "all_results.json")) as f:
        assert json.load(f) == {"eval_psnr": 30.0, "test_psnr": 29.0}


class _Trainable:
    trainable_params = {"w": torch.zeros(3)}

    @staticmethod
    def loss_fn(params, batch, key):
        return params["w"].sum()


class _Wrap:
    def __init__(self, items):
        self.items = items

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def test_train_noop_without_trainables(tmp_path):
    model = _Trainable()
    model.loss_fn = None
    driver = Driver(types.SimpleNamespace(output_dir=str(tmp_path), num_train_epochs=1), model,
                    train_dataset=_Wrap([]))
    assert "train_runtime" in driver.train()


def test_train_with_trainables_is_not_ported(tmp_path):
    """The optimiser loop is ported now, and the test keeps its name
    (``test_torch_driver_train.py`` holds the loop to the JAX driver's): two
    epochs of one item take two AdamW steps at the default 5e-5 against the
    gradient of ``sum(w)``, each moving every weight by the learning rate (to
    1e-5 of it: optax's float32 bias correction ``1 - 0.999`` is 1.3e-5 off
    its value, as here)."""
    model = _Trainable()
    driver = Driver(types.SimpleNamespace(output_dir=str(tmp_path), num_train_epochs=2),
                    model, train_dataset=_Wrap([{"x": np.zeros(3)}]))
    metrics = driver.train()
    assert driver.state.global_step == 2 and "train_loss" in metrics
    torch.testing.assert_close(model.trainable_params["w"], torch.full((3,), -1e-4),
                               rtol=1e-5, atol=0)


def test_wandb_surface_gated_and_logged(tmp_path, monkeypatch):
    """report_to=wandb routes log() through a wandb module when importable
    (a fake here), and degrades to console logging otherwise."""
    calls = []
    fake = types.ModuleType("wandb")
    fake.run = None

    def init(**kw):
        fake.run = object()
        calls.append(("init", kw))

    fake.init = init
    fake.log = lambda logs, step=None: calls.append(("log", dict(logs), step))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    args = types.SimpleNamespace(output_dir=str(tmp_path), report_to="wandb",
                                 cfg="experiments/x.cfg", seed=0)
    drv = Driver(args, _FakeModel())
    drv.log({"loss": 1.0})
    assert [c[0] for c in calls] == ["init", "log"] and calls[1][1]["loss"] == 1.0

    monkeypatch.delitem(sys.modules, "wandb")
    real_import = builtins.__import__

    def no_wandb(name, *a, **k):
        if name == "wandb":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    drv2 = Driver(args, _FakeModel())
    drv2.log({"loss": 2.0})
    assert drv2._wandb() is None


class _EchoModel:
    """forward returns its batch's images as (original, translated) tensors."""

    gan_wrapper = None

    def forward(self, sample_id, image):
        t = torch.as_tensor(image, dtype=torch.float64)
        return (t, t * 0.5), torch.zeros(len(sample_id)), {"l": torch.ones(len(sample_id))}


def test_evaluate_brings_outputs_back_as_float32(tmp_path):
    data = _DS([{"sample_id": np.asarray(i), "image": np.full((2, 2, 3), i, np.float32)}
                for i in range(3)])
    seen = {}

    def compute_metrics(images, model, weighted_loss, losses, dataset, split):
        seen.update(images=images, losses=losses)
        return {"m": 1.0}

    driver = Driver(_args(tmp_path, per_device_eval_batch_size=2), _EchoModel(),
                    compute_metrics=compute_metrics, eval_dataset=data)
    metrics = driver.evaluate()
    assert metrics["eval_m"] == 1.0 and "eval_runtime" in metrics
    orig, trans = seen["images"]
    assert orig.dtype == trans.dtype == np.float32 and trans.shape == (3, 2, 2, 3)
    np.testing.assert_array_equal(trans[:, 0, 0, 0], [0.0, 0.5, 1.0])
    assert seen["losses"] == {"l": [1.0, 1.0, 1.0]}


def test_trace_if_enabled_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("CYCLEDIFFUSION_TRACE_DIR", str(tmp_path))
    with profiling.trace_if_enabled():
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    monkeypatch.delenv("CYCLEDIFFUSION_TRACE_DIR")
    profiling.reset()
    with profiling.trace_if_enabled():
        with profiling.span("encode", rows=4):
            time.sleep(0.01)
    # no trace: recording stays off, and the span records nothing
    assert profiling.recorded().spans == {}
    with profiling.recording(), profiling.span("encode", rows=4):
        time.sleep(0.01)
    rec = profiling.recorded().spans[("encode", None)]
    assert (rec.calls, rec.rows) == (1, 4) and rec.host_ns >= 10_000_000
    profiling.reset()


def test_save_load_with_a_latent_core(tmp_path):
    """``model_params.msgpack`` holds each wrapper core's JAX parameter
    tree; a resumed driver puts every weight of the tiny core back bit for
    bit."""
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore

    spec = LatentCoreSpec.tiny()
    model = types.SimpleNamespace(
        gan_wrapper=types.SimpleNamespace(core=LatentDiffusionCore.random_init(spec, 1, "cpu")))
    Driver(_args(tmp_path), model).save_model()
    other = types.SimpleNamespace(
        gan_wrapper=types.SimpleNamespace(core=LatentDiffusionCore.random_init(spec, 2, "cpu")))
    Driver(_args(tmp_path), other).load_model(str(tmp_path))
    want, got = model.gan_wrapper.core.state_dict(), other.gan_wrapper.core.state_dict()
    core = model.gan_wrapper.core
    assert want.keys() == got.keys()
    assert len(want) == sum(len(m.state_dict()) for m in core.modules())
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_load_model_reads_an_earlier_port_checkpoint(tmp_path):
    """A directory holding only an earlier port checkpoint's
    ``model_params.pt`` (each wrapper module's ``state_dict()``) still
    loads."""
    model = _FakeModel(3.0)
    torch.save({"gan_wrapper": model.gan_wrapper.core.state_dict()},
               os.path.join(tmp_path, "model_params.pt"))
    torch.nn.init.zeros_(model.gan_wrapper.core.weight)
    Driver(_args(tmp_path), model).load_model(str(tmp_path))
    torch.testing.assert_close(model.gan_wrapper.core.weight, torch.full((4, 4), 3.0),
                               rtol=0, atol=0)
