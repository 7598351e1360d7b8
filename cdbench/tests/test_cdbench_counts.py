"""The operation and byte counts against hand counts, and the stored
counts against ``counts.model_flops``."""

from __future__ import annotations

import json

import pytest

from cdbench import counts
from cdbench.tests.conftest import REPO


def config(name):
    return json.loads((REPO / "cdbench" / "configs" / f"{name}.json").read_text())


def test_k2_operations_by_hand():
    # K2 at the SD 512 px level: (B 4, T 4096, C 320), 8 heads of 40
    flops = 4 * 4 * 8 * 4096 * 4096 * 40
    assert flops == pytest.approx(85.9e9, rel=1e-3)
    nbytes = 4 * 4 * 4096 * 320 * 2
    assert counts.attention_bound_s(4, 4096, 8, 40) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert flops / 989e12 > nbytes / 3.35e12          # bound by operations


def test_sd_attention_shapes():
    shapes = counts.self_attention_shapes(config("sd14-512"))
    assert shapes.count((4096, 8, 40)) == 5 and shapes.count((1024, 8, 80)) == 5
    assert shapes.count((256, 8, 160)) == 5 and shapes.count((64, 8, 160)) == 1
    ldm = counts.self_attention_shapes(config("ldm-t2i-large-256"))
    assert ldm.count((1024, 8, 40)) == 5 and max(t for t, _, _ in ldm) == 1024


@pytest.mark.parametrize("name", ["sd14-512", "ldm-t2i-large-256"])
def test_stored_counts(name):
    cfg = config(name)
    assert cfg["counts"] == counts.model_flops(cfg)


def test_unet_row_by_hand_share():
    # a UNet row's attention at 4096 tokens: 5 calls of 4*8*4096^2*40 + the
    # 1024-token level's 5 of 4*8*1024^2*80; a part of the whole count
    cfg = config("sd14-512")
    attn = sum(4 * h * t * t * d for t, h, d in counts.self_attention_shapes(cfg))
    assert 0.05 < attn / cfg["counts"]["unet_row"] < 0.5
