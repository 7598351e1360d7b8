"""The import guard: no JAX and no JAX package in the benchmark's process,
and nothing of the measured program in the reference.

Names are compared by their top-level part (before the first dot) as a
whole: the port's package name begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

BANNED = frozenset({"jax", "jaxlib", "flax", "cyclediffusion_tpu"})
PROGRAM = "cyclediffusion_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_banned(modules=None) -> list:
    """The banned top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names if top(n) in BANNED})


def imported_names(path: Path) -> set:
    """The absolute module names a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value))
    return names


def scan(bench_dir: Path) -> list:
    """(file, module) pairs that break the rule in the benchmark's sources."""
    bad = []
    for path in sorted(Path(bench_dir).rglob("*.py")):
        in_reference = "reference" in path.relative_to(bench_dir).parts
        for name in sorted(imported_names(path)):
            if top(name) in BANNED or (in_reference and top(name) == PROGRAM):
                bad.append((str(path), name))
    return bad
