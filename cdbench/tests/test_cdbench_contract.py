"""BENCHMARK.json against the contract's shape rules, each configuration,
mix, limits file and metric reader it names, and a tiny run's last line."""

from __future__ import annotations

import json
import re

import pytest

from cdbench import harness
from cdbench.registry import Registry
from cdbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["cdbench"] and b["command"][1].startswith("cdbench/")
    assert 1 <= b["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_keys():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cdbench/") and (REPO / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s", "images_per_min", "peak_mem_gib"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")


def test_every_part_is_found_by_name():
    reg = Registry(REPO)
    for w in bench()["workloads"]:
        cfg, mix = reg.config(w["config"]), reg.traffic(w["traffic"])
        assert cfg["name"] == w["config"]
        driver = reg.driver(mix["driver"])
        assert set(reg.limits(w["name"])) == set(driver.NUMBERS)
        for name, (entry, reader) in reg.per_layer(w["name"]).items():
            assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
                entry["unit"], entry["layer"], entry["moves"])


@pytest.mark.parametrize("cell,trace", [("tiny-clip-32.tiny_edit", False),
                                        ("tiny-clip-32.tiny_edit", True),
                                        ("tiny-guided-32.tiny_guided", False),
                                        ("tiny-guided-32.tiny_guided", True),
                                        ("tiny-ensemble-32.tiny_ensemble", False),
                                        ("tiny-ensemble-32.tiny_ensemble", True)])
def test_tiny_run_last_line(tiny_root, cell, trace):
    out = harness.run_cell(tiny_root, cell, 2 ** 31 + 12345, 0.2, trace, 0.0, device="cpu")
    line = json.loads(json.dumps(out["line"]))
    assert LINE_KEYS <= set(line) <= LINE_KEYS | {"breakdown", "checks"}
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and UNIT.match(m["unit"])
    if not trace:
        assert set(line["metrics"]) == {"images_per_min", "peak_mem_gib", "setup_s"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
