"""The port's driver across real processes on the CPU: ranks joined in one
gloo group through a ``file://`` init (``test_torch_common.run_ranks``),
each child process bounded by a timeout.

* ``gather_sharded_outputs`` over the group, without an injected
  ``allgather``, against the JAX package's gather (fed by an allgather that
  stacks every process's shard, as ``tests/test_multiprocess_gather.py``
  drives it) for the ragged and even cases of that test: equal arrays.
* The port's CLI on ``experiments/tiny_text_translation.cfg`` in two
  processes against one process, as JAX's ``tests/test_multihost_real.py``
  holds its two-process run: the same metric keys, each value within
  ``1e-4 + 1e-3 * |x|``; the gathered ``temp_gen`` images equal; rank 0
  alone writes the results.
"""

import json
import math
import os

import numpy as np
import pytest

from cyclediffusion_tpu.runtime import driver as jdriver
from cyclediffusion_tpu_torch import main as cli
from cyclediffusion_tpu_torch.data.png import read_png
from cyclediffusion_tpu_torch.runtime import context
from test_torch_common import run_ranks

CFG = "experiments/tiny_text_translation.cfg"

GATHER_CHILD = """
from cyclediffusion_tpu_torch.runtime.driver import Driver, EvalLoader, gather_sharded_outputs
import types
n = int(os.environ["GATHER_N"])
driver = Driver(types.SimpleNamespace(output_dir=os.path.join(work, f"out{rank}")), None)
assert (driver.process_index, driver.process_count) == (rank, world)
loader = EvalLoader([{"i": np.asarray(i)} for i in range(n)], 2, rank, world)
ids = [int(i) for b in loader for i in b["i"]]
img = np.stack([np.full((4, 4, 3), float(i), np.float32) for i in ids])
out = gather_sharded_outputs({"img": img, "loss": np.asarray(ids, np.float32) * 10.0},
                             n=n, process_count=world)
np.savez(os.path.join(work, f"rank{rank}.npz"), ids=np.asarray(ids), **out)
"""


def _jax_gather(n: int, procs: int):
    """Every process's shard through JAX's EvalLoader, gathered by JAX's
    ``gather_sharded_outputs`` with an allgather that stacks the shards."""
    shards = []
    for rank in range(procs):
        loader = jdriver.EvalLoader([{"i": np.asarray(i)} for i in range(n)], 2, rank, procs)
        ids = [int(i) for b in loader for i in b["i"]]
        shards.append({"img": np.stack([np.full((4, 4, 3), float(i), np.float32)
                                        for i in ids]),
                       "loss": np.asarray(ids, np.float32) * 10.0})

    def allgather(local):
        key = "img" if local.ndim > 1 else "loss"
        return np.stack([s[key] for s in shards])

    return jdriver.gather_sharded_outputs(shards[0], n=n, process_count=procs,
                                          allgather=allgather)


@pytest.mark.parametrize("n,procs", [(8, 2), (7, 2), (5, 4), (3, 4), (6, 3)])
def test_gather_over_processes_matches_jax(tmp_path, monkeypatch, n, procs):
    monkeypatch.setenv("GATHER_N", str(n))
    run_ranks(GATHER_CHILD, procs, tmp_path, timeout=120)
    want = _jax_gather(n, procs)
    for rank in range(procs):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert len(got["ids"]) == math.ceil(n / procs)       # wrap-padded shards
        for key in ("img", "loss"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got["img"][:, 0, 0, 0], np.arange(n, dtype=np.float32))
        np.testing.assert_array_equal(got["loss"], np.arange(n, dtype=np.float32) * 10.0)


CLI_CHILD = """
from cyclediffusion_tpu_torch import main as cli
metrics = cli.main(["--cfg", "experiments/tiny_text_translation.cfg",
                    "--output_dir", os.path.join(work, f"run{rank}"), "--seed", "42",
                    "--do_eval", "--per_device_eval_batch_size", "1"], device="cpu")
with open(os.path.join(work, f"metrics{rank}.json"), "w") as f:
    json.dump({k: float(v) for k, v in metrics.items()}, f)
"""


def test_two_process_cli_matches_one_process(tmp_path):
    context.reset()
    try:
        want = cli.main(["--cfg", CFG, "--output_dir", str(tmp_path / "single"), "--seed", "42",
                         "--do_eval", "--per_device_eval_batch_size", "1"], device="cpu")
    finally:
        context.reset()
    run_ranks(CLI_CHILD, 2, tmp_path, timeout=300)
    with open(tmp_path / "metrics0.json") as f:
        got = json.load(f)
    drop = {"eval_runtime", "eval_samples_per_second", "eval_steps_per_second"}
    keys = {k for k in want if k not in drop}
    assert keys == {k for k in got if k not in drop}
    for k in sorted(keys):
        x = float(want[k])
        assert abs(x - got[k]) <= 1e-4 + 1e-3 * abs(x), (k, x, got[k])
    run0, run1 = tmp_path / "run0", tmp_path / "run1"
    for i in range(int(want["eval_samples"])):
        np.testing.assert_array_equal(read_png(str(run0 / "temp_gen" / f"{i}.png")),
                                      read_png(str(tmp_path / "single" / "temp_gen" / f"{i}.png")))
    assert (run0 / "eval_results.json").exists() and not (run1 / "eval_results.json").exists()
    assert sorted(os.listdir(run0 / "visualization")) == ["eval_000000.png",
                                                          "eval_256_000000.png"]
