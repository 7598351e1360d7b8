"""The import guard, in the sources and over the loaded modules."""

from __future__ import annotations

from cdbench import guard
from cdbench.tests.conftest import REPO


def test_sources_import_no_jax_and_reference_no_program():
    assert guard.scan(REPO / "cdbench") == []


def test_top_level_names_compared_whole():
    mods = {"cyclediffusion_tpu_torch": 1, "cyclediffusion_tpu_torch.ops": 1, "numpy": 1}
    assert guard.loaded_banned(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "cyclediffusion_tpu",
                "cyclediffusion_tpu.models"):
        assert guard.loaded_banned(dict(mods, **{bad: 1})) == [bad.split(".")[0]]


def test_scan_finds_a_planted_import(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text("import jax.numpy as jnp\n")
    (tmp_path / "b.py").write_text("from cyclediffusion_tpu.models import nn\n")
    (tmp_path / "c.py").write_text("import cyclediffusion_tpu_torch\n")
    (tmp_path / "reference" / "d.py").write_text("from cyclediffusion_tpu_torch import ops\n")
    (tmp_path / "e.py").write_text("import importlib\nimportlib.import_module('flax')\n")
    bad = {(p.split("/")[-1], m) for p, m in guard.scan(tmp_path)}
    assert bad == {("a.py", "jax.numpy"), ("b.py", "cyclediffusion_tpu.models"),
                   ("d.py", "cyclediffusion_tpu_torch"), ("e.py", "flax")}
