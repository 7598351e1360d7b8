"""Fixtures of the benchmark's CPU tests, and the ``card`` marker.

A test marked ``card`` needs an NVIDIA GPU: it is skipped, inside the
``card`` fixture it requests, where ``torch.cuda.is_available()`` is false.
The decision is made when the test runs, never at import.  On the card:
``python3 -m pytest cdbench/tests -m card -p no:cacheprovider``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from cdbench import counts

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny-clip-32", "source": "a CPU miniature of sd14-512", "preset": "tiny",
    "dtype": "float32", "resolution": 32,
    "arch": {
        "unet": {"in_channels": 4, "out_channels": 4, "model_channels": 32,
                 "channel_mult": [1, 2], "num_res_blocks": 1, "attention_resolutions": [1, 2],
                 "num_heads": 4, "transformer_depth": 1, "context_dim": 24},
        "first_stage": {"ch": 32, "ch_mult": [1, 2, 4], "num_res_blocks": 1, "in_channels": 3,
                        "out_ch": 3, "z_channels": 4, "embed_dim": 4, "resolution": 32},
        "cond": {"kind": "clip", "vocab_size": 96, "width": 24, "layers": 2, "heads": 4,
                 "ff": 48, "context_length": 16},
        "scale_factor": 0.18215, "linear_start": 0.00085, "linear_end": 0.012,
        "timesteps": 100},
    "reduced": [], "assumed": [], "counts": {},
}

TINY_BERT = dict(TINY_CONFIG, name="tiny-bert-32")
TINY_BERT["arch"] = dict(TINY_CONFIG["arch"], cond={
    "kind": "bert", "vocab_size": 96, "width": 24, "layers": 2, "heads": 2, "dim_head": 12,
    "ff_mult": 4, "context_length": 16})

TINY_GUIDED = dict(TINY_CONFIG, name="tiny-guided-32")
TINY_GUIDED["arch"] = dict(TINY_CONFIG["arch"], scorer={
    "embed_dim": 16, "image_resolution": 16, "vision_width": 32, "vision_layers": 2,
    "vision_heads": 4, "patch_size": 8, "vocab_size": 96, "context_length": 16,
    "text_width": 32, "text_layers": 2, "text_heads": 4})

TINY_GUIDED_MIX = {"driver": "guided", "images_per_request": 1, "steps": 5, "eta": 0.1,
                   "cfg_scale": 5.0, "weight": 0.05}

TINY_ENSEMBLE_MIX = {"driver": "ensemble", "steps": 10, "white_box_steps": 11, "eta": 0.1,
                     "skip": 5, "encoder_scale": 1, "decoder_scales": [1, 1.5, 2, 3, 4, 5],
                     "candidate_chunk": 4}

TINY_MIX = {"driver": "edit", "images_per_request": 2, "steps": 10, "white_box_steps": 11,
            "eta": 0.1, "skip": 5, "encoder_scale": 1, "decoder_scale": 5,
            "candidate_chunk": 4}

# fp32 on the CPU against the fp32 reference: rounding only
TINY_LIMITS = {"ctx": 1e-4, "x0": 1e-4, "code": 1e-3, "replay": 1e-4, "pixels": 1e-4}
TINY_GUIDED_LIMITS = {"ctx": 1e-4, "grad": 1e-4, "replay": 1e-4, "pixels": 1e-4}
TINY_ENSEMBLE_LIMITS = dict(TINY_LIMITS, clip=1e-4, scores=1e-4, choice=0, chosen=0)


def make_tiny_root(path: Path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``cdbench/``) with
    two tiny cells added as new files and new entries."""
    root = Path(path)
    shutil.copytree(REPO / "cdbench", root / "cdbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg, mix, limits in ((TINY_CONFIG, "tiny_edit", TINY_LIMITS),
                             (TINY_BERT, "tiny_edit", TINY_LIMITS),
                             (TINY_GUIDED, "tiny_guided", TINY_GUIDED_LIMITS),
                             (TINY_GUIDED, "tiny_ensemble", TINY_ENSEMBLE_LIMITS)):
        cfg = json.loads(json.dumps(cfg))
        cfg["counts"] = counts.model_flops(cfg)
        (root / "cdbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        cell = f"{cfg['name']}.{mix}"
        if mix == "tiny_ensemble":
            cell = "tiny-ensemble-32.tiny_ensemble"
        bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": mix,
                                   "chips": 1, "why": "CPU test"})
        (root / "cdbench" / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    (root / "cdbench" / "traffic" / "tiny_edit.json").write_text(json.dumps(TINY_MIX))
    (root / "cdbench" / "traffic" / "tiny_guided.json").write_text(json.dumps(TINY_GUIDED_MIX))
    (root / "cdbench" / "traffic" / "tiny_ensemble.json").write_text(
        json.dumps(TINY_ENSEMBLE_MIX))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "checkout")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest cdbench/tests -m card)")
    return torch.device("cuda")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skipped elsewhere")
