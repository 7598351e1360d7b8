"""Program registry: a config's program name -> the port's class (counterpart
of ``cyclediffusion_tpu.runtime.registry``).

Names resolve inside ``cyclediffusion_tpu_torch.{tasks, data.preprocess,
evaluation, visualization}``; each module exports ``Model``,
``Preprocessor``, ``Evaluator`` or ``Visualizer``.  A name that the JAX
package's configs use but this port does not have yet raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import importlib

_BASE = "cyclediffusion_tpu_torch"

_FAMILIES = "ROADMAP §A queue item 3 (the other model families)"
_NOT_PORTED = {
    "tasks": {},
    "data.preprocess": {name: _FAMILIES for name in ("afhqcat256", "afhqwild256")},
    "evaluation": {"translate_to_dog": _FAMILIES},
    "visualization": {},
}


def _resolve(kind: str, name: str, symbol: str):
    if name in _NOT_PORTED[kind]:
        raise NotImplementedError(f"{kind} program {name!r} is not ported yet: "
                                  f"{_NOT_PORTED[kind][name]}")
    return getattr(importlib.import_module(f"{_BASE}.{kind}.{name}"), symbol)


def get_model(name: str):
    """The task model class; it takes ``(args, base_seed=..., device=...)``."""
    return _resolve("tasks", name, "Model")


def get_preprocessor(name: str):
    return _resolve("data.preprocess", name, "Preprocessor")


def get_evaluator(name: str):
    return _resolve("evaluation", name, "Evaluator")


def get_visualizer(name: str):
    return _resolve("visualization", name, "Visualizer")
