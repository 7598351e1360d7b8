"""A configuration, a traffic mix and a per-layer metric added as new files
(and new entries in BENCHMARK.json) are found, with no existing file of
``cdbench/`` edited."""

from __future__ import annotations

import hashlib
import json

from cdbench import harness
from cdbench.registry import Registry


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "cdbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_only(tiny_root):
    before = digests(tiny_root)
    d = tiny_root / "cdbench"
    cfg = json.loads((d / "configs" / "tiny-clip-32.json").read_text())
    cfg["name"] = "tiny-clip-32-b"
    (d / "configs" / "tiny-clip-32-b.json").write_text(json.dumps(cfg))
    mix = json.loads((d / "traffic" / "tiny_edit.json").read_text())
    mix["images_per_request"] = 3
    (d / "traffic" / "tiny_edit_b3.json").write_text(json.dumps(mix))
    (d / "metrics" / "unet_rows.py").write_text(
        'UNIT = "rows"\nLAYER = "models"\nMOVES = "images_per_min"\n\n\n'
        'def read(run):\n    return float(run.recorder.rows.get("unet", 0)) or None\n')
    limits = json.loads((d / "limits" / "tiny-clip-32.tiny_edit.json").read_text())
    (d / "limits" / "new.cell.json").write_text(json.dumps(limits))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new.cell", "config": "tiny-clip-32-b",
                               "traffic": "tiny_edit_b3", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "unet_rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "models",
                               "moves": "images_per_min", "workloads": ["new.cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())

    reg = Registry(tiny_root)
    assert "unet_rows" in reg.per_layer("new.cell")
    out = harness.run_cell(tiny_root, "new.cell", 5, 0.2, True, 0.0, device="cpu")
    rows = out["line"]["metrics"]["unet_rows"]["value"]
    # a traced window of n requests: 2 chains x (10 - 5) steps x the CFG pair x 3 images
    assert rows == out["line"]["attempted"] * 2 * 5 * 2 * 3
    assert out["line"]["correct"] is True
