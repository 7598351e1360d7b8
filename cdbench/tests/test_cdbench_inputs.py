"""Inputs and weights come from ``--seed`` alone."""

from __future__ import annotations

import json

import torch

from cdbench.drivers import edit
from cdbench.tests.conftest import TINY_CONFIG, TINY_MIX
from cdbench.weights import derive_seed, draw_state_dict

BIG = 2 ** 31 + 987_654_321_012


def same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)


def test_requests_repeat_per_seed_and_index():
    for seed in (0, 7, BIG):
        assert same(edit.make_request(TINY_CONFIG, TINY_MIX, seed, 3, "cpu"),
                    edit.make_request(TINY_CONFIG, TINY_MIX, seed, 3, "cpu"))
    a = edit.make_request(TINY_CONFIG, TINY_MIX, BIG, 0, "cpu")
    assert not same(a, edit.make_request(TINY_CONFIG, TINY_MIX, BIG + 1, 0, "cpu"))
    assert not same(a, edit.make_request(TINY_CONFIG, TINY_MIX, BIG, 1, "cpu"))


def test_every_request_has_the_same_sizes():
    shapes = {tuple((k, tuple(v.shape)) for k, v in sorted(
        edit.make_request(TINY_CONFIG, TINY_MIX, BIG, i, "cpu").items()) if torch.is_tensor(v))
        for i in range(-1, 6)}
    assert len(shapes) == 1
    req = edit.make_request(TINY_CONFIG, TINY_MIX, BIG, 0, "cpu")
    assert req["images"].min() >= 0 and req["images"].max() <= 1
    assert req["posterior_noises"].shape[0] == TINY_MIX["steps"] - TINY_MIX["skip"]


def test_weights_repeat_per_seed():
    a = draw_state_dict(TINY_CONFIG, BIG, "cpu", torch.bfloat16)
    b = draw_state_dict(TINY_CONFIG, BIG, "cpu", torch.bfloat16)
    c = draw_state_dict(TINY_CONFIG, BIG + 1, "cpu", torch.bfloat16)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(v.dtype == torch.bfloat16 for v in a.values())


def test_derived_seeds_fit_a_generator():
    for seed in (0, -5, BIG, 2 ** 63):
        s = derive_seed(seed, "weights", "unet")
        assert 0 <= s < 2 ** 63
        torch.Generator().manual_seed(s)
    assert json.dumps(derive_seed(1, "a")) != json.dumps(derive_seed(1, "b"))
