"""The model family behind the shared harness.

The drawn weights, the reference's names and shapes, the stored counts and
the attention shapes are what the harness gave before a configuration named
its family (digests recorded from that code, seed ``SEED``, on the CPU),
and no shared module of ``cdbench/`` names an architecture's keys: those
live in the family's files."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest
import torch

from cdbench import counts, harness
from cdbench.registry import family
from cdbench.tests.conftest import REPO, TINY_BERT, TINY_CONFIG, TINY_GUIDED
from cdbench.weights import draw_state_dict

SEED = 2 ** 33 + 17

# float32 and bfloat16 draws of each tiny configuration's parts
WEIGHTS = {
    "tiny-clip-32": ("94b91ff697826e6d040e2b85291c1c8cfd79bcd16b8f8f94edfba5b3d920049a",
                     "baddda332902434f8e1fe60c9974c78c4c80b131b16bafbf4b791074f52d8450"),
    "tiny-bert-32": ("0f00160ef3a81812cd2bab281f958d4e021cb0c58c23b13dcf1ff03dedddaeee",
                     "83a78098350afc7f10484f72ce1c8212cb5beb82a22d6dfb6c3afa5518f02701"),
    "tiny-guided-32": ("a18a4f92eee4b48f0c0f4e99bf8ef44c8b8ee532ba2698d519184e68544e8a52",
                       "c7fcb7d90e4e60dc387bb66e359faf09e7fb336ffb586e126465c2003413b1b1"),
}
# the names and shapes of every part, the scorer included, on the meta device
META = {"sd14-512": ("6f8e1b8e6fc2e5b16451b95a0b6a9d720694abf45b41b791781ad9d611a4157c", 1431),
        "ldm-t2i-large-256": (
            "a5e45323af867019cfe44229036672305a44fe827e76d524fe63c6839544c656", 1354)}

# what only an architecture's own files may name
ARCH_KEYS = ("cond_stage_model", '["cond"]', '["num_heads"]', '["transformer_depth"]',
             '["context_dim"]')


def digest(named) -> str:
    """sha256 over each (name, shape, bytes) in order; a meta tensor adds
    no bytes."""
    h = hashlib.sha256()
    for name, t in named:
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        if t.device.type != "meta":
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def config(name):
    return json.loads((REPO / "cdbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("cfg,extra", [(TINY_CONFIG, ()), (TINY_BERT, ()),
                                       (TINY_GUIDED, ("scorer",))],
                         ids=["clip", "bert", "guided"])
def test_drawn_weights_are_the_parents(cfg, extra):
    names = tuple(family(cfg, "reference").PARTS) + extra
    for dtype, want in zip((torch.float32, torch.bfloat16), WEIGHTS[cfg["name"]]):
        assert digest(draw_state_dict(cfg, SEED, "cpu", dtype, names).items()) == want


@pytest.mark.parametrize("name", ["sd14-512", "ldm-t2i-large-256"])
def test_meta_names_and_shapes_are_the_parents(name):
    cfg = config(name)
    ref = family(cfg, "reference")
    names = tuple(ref.PARTS) + (("scorer",) if "scorer" in cfg["arch"] else ())
    named = [(prefix + k, p) for prefix, m in ref.build_parts(cfg["arch"], "meta", names).values()
             for k, p in m.named_parameters()]
    assert (digest(named), len(named)) == META[name]
    assert harness.part_names(cfg) == ("unet", "first_stage", "cond")
    # the parent's list: 8 heads at every level, from the first level's tokens
    t = {"sd14-512": 4096, "ldm-t2i-large-256": 1024}[name]
    assert counts.self_attention_shapes(cfg) == (
        [(t, 8, 40)] * 2 + [(t // 4, 8, 80)] * 2 + [(t // 16, 8, 160)] * 2
        + [(t // 64, 8, 160)] + [(t // 16, 8, 160)] * 3 + [(t // 4, 8, 80)] * 3
        + [(t, 8, 40)] * 3)


def architecture_keys(root) -> list:
    """(file, key) pairs of the architecture's keys in the shared files of
    ``root/cdbench``: all but the tests, the ``latent_text`` family's
    modules and its configurations."""
    d = root / "cdbench"
    own = {d / "reference" / "latent_text.py", d / "cores" / "latent_text.py"}
    own |= {p for p in (d / "configs").glob("*.json")
            if json.loads(p.read_text()).get("family") == "latent_text"}
    found = []
    for path in sorted(d.rglob("*")):
        rel = path.relative_to(d)
        if (not path.is_file() or path in own or rel.parts[0] == "tests"
                or any(p.startswith(".") or p == "__pycache__" for p in rel.parts)):
            continue
        text = path.read_bytes().decode("utf-8", errors="replace")
        found += [(str(rel), key) for key in ARCH_KEYS if key in text]
    return found


def test_the_shared_harness_names_no_architecture_key():
    assert architecture_keys(REPO) == []


def test_the_scan_finds_a_planted_key(tmp_path):
    shutil.copytree(REPO / "cdbench", tmp_path / "cdbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (tmp_path / "cdbench" / "drivers" / "planted.py").write_text(
        'def heads(cfg):\n    return cfg["arch"]["unet"]["num_heads"]\n')
    (tmp_path / "cdbench" / "metrics" / "planted.py").write_text(
        '"""reads cond_stage_model.transformer"""\n')
    assert architecture_keys(tmp_path) == [("drivers/planted.py", '["num_heads"]'),
                                           ("metrics/planted.py", "cond_stage_model")]
