"""Finds each part of the benchmark by the name ``BENCHMARK.json`` gives it.

Under ``<root>/cdbench/``: ``configs/<config>.json`` (a configuration:
its ``family``, sizes, dtype, source, cuts and the operation counts),
``traffic/<mix>.json`` (a traffic mix: the parameters of one of the
drivers, named by its ``driver`` key), ``drivers/<driver>.py`` (the
generator of a family of mixes and its reference), ``metrics/<metric>.py``
(a per-layer metric's reader), ``limits/<workload>.json`` (the limits of a
cell's comparison), and for each model family that a configuration's
``family`` key names, ``reference/<family>.py`` (the plain reference's
entry points) and ``cores/<family>.py`` (the program's).  A new
configuration, family, mix, metric or cell is new files and new entries in
``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the checkout this package lies in: where a configuration that no
# Registry loaded (a test's dict) finds its family
HOME = Path(__file__).resolve().parent.parent
# the key under which Registry.config records the checkout a configuration
# was read from, so that its family is found there too
CHECKOUT = "checkout"
SIDES = ("reference", "cores")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _load(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _family_module(path: Path, label: str):
    return _load(path, label)


def family(cfg: dict, side: str):
    """The module of ``cfg``'s model family on ``side``: ``reference``
    (``PARTS``, ``build_parts``, ``condition``, ``eps``, ``unit_calls``,
    ``self_attention_shapes``) or ``cores`` (``load_core``, ``tokenizer``),
    from the checkout the configuration was read from."""
    if side not in SIDES:
        raise ValueError(f"no side {side!r} of a family")
    name = _checked(cfg["family"])
    root = Path(cfg.get(CHECKOUT, HOME)).resolve()
    return _family_module(root / "cdbench" / side / f"{name}.py", f"cdbench_{side}_{name}")


class Registry:
    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "cdbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{_checked(name)}.json").read_text())

    def _module(self, kind: str, name: str):
        return _load(self.dir / kind / f"{_checked(name)}.py", f"cdbench_{kind}_{name}")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file, and the checkout it was read from."""
        return dict(self._json("configs", name), **{CHECKOUT: str(self.root.resolve())})

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
