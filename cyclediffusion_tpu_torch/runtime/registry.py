"""Program registry: a config's program name -> the port's class (counterpart
of ``cyclediffusion_tpu.runtime.registry``).

Names resolve inside ``cyclediffusion_tpu_torch.{tasks, data.preprocess,
evaluation, visualization}``; each module exports ``Model``,
``Preprocessor``, ``Evaluator`` or ``Visualizer``.  Every program that the
JAX package's configs name is ported; an unknown name raises
``ModuleNotFoundError``.
"""

from __future__ import annotations

import importlib

_BASE = "cyclediffusion_tpu_torch"


def _resolve(kind: str, name: str, symbol: str):
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
