"""On the card: the tiny cells through the whole run, graphs and all."""

from __future__ import annotations

import pytest
import torch

from cdbench import harness


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tiny-clip-32.tiny_edit", "tiny-bert-32.tiny_edit"])
def test_tiny_cells_on_the_card(tiny_root, card, cell):
    torch.backends.cudnn.allow_tf32 = False     # the tiny limits are float32's
    out = harness.run_cell(tiny_root, cell, 2 ** 32 + 5, 1.0, True, 0.0, device=card)
    line = out["line"]
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert "unet_ms_per_call" in line["metrics"]
