"""The ensemble's skip cycle (``drivers/ensemble_cycle.py``): each request
at its own skip, run to ``correct`` on the CPU at a tiny size, and
``t1_step_mfu`` counting the traced requests' own work."""

from __future__ import annotations

import json
import types

import pytest

from cdbench import counts, harness
from cdbench.registry import Registry, _load
from cdbench.tests.conftest import REPO, TINY_ENSEMBLE_LIMITS, TINY_ENSEMBLE_MIX

CELL = "tiny-guided-32.tiny_cycle"
MIX = {k: v for k, v in TINY_ENSEMBLE_MIX.items() if k != "skip"}
MIX.update(driver="ensemble_cycle", skips=[5, 3, 7])


def add_cycle(root) -> None:
    d = root / "cdbench"
    (d / "traffic" / "tiny_cycle.json").write_text(json.dumps(MIX))
    (d / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_ENSEMBLE_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny-guided-32", "traffic": "tiny_cycle",
                               "chips": 1, "why": "CPU test: the skip cycle"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_each_request_takes_its_skip(tiny_root):
    add_cycle(tiny_root)
    reg = Registry(tiny_root)
    driver = reg.driver("ensemble_cycle")
    cfg = reg.config("tiny-guided-32")
    assert [driver.skip_of(MIX, i) for i in (-1, 0, 1, 2, 3)] == [7, 5, 3, 7, 5]
    req = driver.make_request(cfg, MIX, 3, 1, "cpu")
    # 10 steps less skip 3: 7 posterior noises
    assert req["skip"] == 3 and req["posterior_noises"].shape[0] == 7
    work = [driver.work_of_request(cfg, MIX, i)["unet_row"] for i in range(3)]
    assert work == [2 * n * 7 for n in (5, 7, 3)]
    assert driver.work_per_request(cfg, MIX)["unet_row"] == pytest.approx(sum(work) / 3)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 11])
def test_a_tiny_cycle_runs_correct(tiny_root, seed):
    add_cycle(tiny_root)
    out = harness.run_cell(tiny_root, CELL, seed, 0.5, True, 0.0, device="cpu")
    line = out["line"]
    # a traced window runs at least two requests (skips 5 and 3) after the
    # warm-up's (skip 7), whatever the CPU's speed
    assert line["attempted"] >= 2 and line["correct"] is True and line["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert "t1_step_mfu" not in line["metrics"]      # nothing on a device to read


def test_t1_step_mfu_counts_the_traced_requests():
    reader = _load(REPO / "cdbench" / "metrics" / "t1_step_mfu.py", "t1")
    driver = _load(REPO / "cdbench" / "drivers" / "ensemble_cycle.py", "cycle")
    cfg = json.loads((REPO / "cdbench" / "configs" / "sd14-512.json").read_text())
    mix = json.loads((REPO / "cdbench" / "traffic" / "ensemble_t1_cycle.json").read_text())
    run = types.SimpleNamespace(cfg=cfg, mix=mix, driver=driver, slice_requests=1,
                                trace=types.SimpleNamespace(window_s=2.0, events=10))
    # the slice holds request 1: skip 40, 59 steps
    flops = sum(n * cfg["counts"][u] for u, n in driver.work_of_request(cfg, mix, 1).items())
    assert driver.work_of_request(cfg, mix, 1)["unet_row"] == 2 * 59 * 7
    assert reader.read(run) == pytest.approx(100 * flops / 2.0 / counts.PEAK_FLOPS)
    run.driver = types.SimpleNamespace()
    assert reader.read(run) is None
