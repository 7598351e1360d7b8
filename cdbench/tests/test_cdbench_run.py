"""The command line: no result without a card, or without the program."""

from __future__ import annotations

import shutil
import subprocess
import sys

from cdbench.tests.conftest import REPO

ARGS = ["--workload", "sd14-edit-b4", "--seed", "3000000001", "--seconds", "1", "--trace", "0"]


def run(cwd, env_cuda_hidden=True):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "" if env_cuda_hidden else "0",
           "HOME": str(cwd), "TMPDIR": str(cwd)}
    return subprocess.run([sys.executable, "cdbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = run(REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "cdbench", tmp_path / "cdbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_port_missing_fails_before_any_result(tmp_path):
    """With the port absent, the program's import fails (on any machine)."""
    shutil.copytree(REPO / "cdbench", tmp_path / "cdbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = subprocess.run([sys.executable, "-c", "import cdbench.program"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "cyclediffusion_tpu_torch" in proc.stderr
