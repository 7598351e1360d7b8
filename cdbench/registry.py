"""Finds each part of the benchmark by the name ``BENCHMARK.json`` gives it.

Under ``<root>/cdbench/``: ``configs/<config>.json`` (a configuration:
sizes, dtype, source, cuts and the operation counts), ``traffic/<mix>.json``
(a traffic mix: the parameters of one of the drivers, named by its
``driver`` key), ``drivers/<driver>.py`` (the generator of a family of
mixes and its reference), ``metrics/<metric>.py`` (a per-layer metric's
reader) and ``limits/<workload>.json`` (the limits of a cell's
comparison).  A new configuration, mix, metric or cell is new files and
new entries in ``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Registry:
    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "cdbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{_checked(name)}.json").read_text())

    def _module(self, kind: str, name: str):
        path = self.dir / kind / f"{_checked(name)}.py"
        spec = importlib.util.spec_from_file_location(f"cdbench_{kind}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def driver(self, name: str):
        return self._module("drivers", name)

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.spec["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> dict:
        """{metric: (entry, reader module)} of the metrics reported in ``workload``."""
        return {m["name"]: (m, self._module("metrics", m["name"]))
                for m in self.spec["per_layer"] if workload in m.get("workloads", [workload])}
