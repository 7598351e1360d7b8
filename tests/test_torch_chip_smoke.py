"""``chip_smoke.py`` on a machine without a GPU: it imports nothing of JAX
or of the JAX package, and it refuses to run — exit code non-zero and no
result line — both in a checkout and when it stands alone in a directory."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(SMOKE).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "cyclediffusion_tpu_torch" in roots
    assert not roots & {"jax", "flax", "cyclediffusion_tpu"}, roots


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        shutil.copy(SMOKE, script)
    else:
        script = SMOKE
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(script)], cwd=os.path.dirname(script),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "FAIL" in proc.stdout
