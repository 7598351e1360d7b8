"""A conditioning of more than one tensor, at the reference's level: a
family whose ``condition`` gives a dict of a context and a pooled vector,
and whose UNet adds the vector's embedding to the timestep's, as SDXL's
``label_emb`` does.  The edit driver's reference path, its readings and
the sampler carry the dict through as it is, and a fault in the vector
alone reads as not correct."""

from __future__ import annotations

import math
import shutil

import torch

from cdbench import compare, harness, registry
from cdbench.drivers import edit
from cdbench.reference import sampling
from cdbench.tests.conftest import REPO, TINY_CONFIG, TINY_LIMITS, TINY_MIX

SEED = 2 ** 33 + 41

REFERENCE = '''"""A context and a pooled vector: the plain reference."""

import torch
from torch import nn

from cdbench.reference import latent_text
from cdbench.reference.models import UNet, timestep_embedding
from cdbench.reference.numerics import Linear

PARTS = latent_text.PARTS
unit_calls = latent_text.unit_calls
self_attention_shapes = latent_text.self_attention_shapes


class PooledUNet(UNet):
    """The UNet with a vector embedding added to the timestep's."""

    def __init__(self, adm_in_channels, **unet):
        super().__init__(**unet)
        emb_dim = 4 * self.model_channels
        self.label_emb = nn.Sequential(nn.Sequential(
            Linear(adm_in_channels, emb_dim), nn.SiLU(), Linear(emb_dim, emb_dim)))

    def forward(self, x, t, cond):
        dtype = self.time_embed[0].weight.dtype
        emb = (self.time_embed(timestep_embedding(t, self.model_channels).to(dtype))
               + self.label_emb(cond["vector"].to(dtype)))
        h = x.permute(0, 3, 1, 2).to(dtype)
        context = cond["context"].to(dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h).permute(0, 2, 3, 1).float()


def build_parts(arch, device="cpu", names=PARTS):
    parts = latent_text.build_parts(arch, device, [n for n in names if n != "unet"])
    if "unet" in names:
        with torch.device(device):
            unet = PooledUNet(arch["adm_in_channels"], **arch["unet"])
        parts["unet"] = (latent_text.PREFIXES["unet"], unet.eval().requires_grad_(False))
    return {n: parts[n] for n in names}


def condition(cfg, parts, texts, device):
    h = latent_text.condition(cfg, parts, texts, device)
    return {"context": h, "vector": h.mean(dim=1)}


def eps(cfg, parts, x, t, cond):
    return parts["unet"][1](x, t, cond)
'''


def pooled_checkout(tmp_path):
    """A checkout whose ``cdbench/`` holds the pooled family besides a copy
    of the benchmark's own files, and its configuration."""
    shutil.copytree(REPO / "cdbench", tmp_path / "cdbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (tmp_path / "cdbench" / "reference" / "tiny_pooled.py").write_text(REFERENCE)
    arch = dict(TINY_CONFIG["arch"], adm_in_channels=TINY_CONFIG["arch"]["cond"]["width"])
    return dict(TINY_CONFIG, name="tiny-pooled-32", family="tiny_pooled", arch=arch,
                **{registry.CHECKOUT: str(tmp_path)})


def test_the_edit_reference_carries_a_dict_through(tmp_path):
    cfg = pooled_checkout(tmp_path)
    parts = harness.reference_parts(cfg, SEED, "cpu")
    assert hasattr(parts["unet"][1], "label_emb")
    req = edit.make_request(cfg, TINY_MIX, SEED, 0, "cpu")
    outs = edit.reference_outputs(cfg, TINY_MIX, parts, req)
    b, width = TINY_MIX["images_per_request"], cfg["arch"]["cond"]["width"]
    for cond in outs["contexts"].values():
        assert set(cond) == {"context", "vector"}
        assert tuple(cond["context"].shape) == (b, 16, width)
        assert tuple(cond["vector"].shape) == (b, width)
    readings = edit.readings(cfg, TINY_MIX, parts, req, outs)
    assert compare.judge(readings, TINY_LIMITS)[0], readings
    assert readings["ctx"] == 0.0


def test_the_sampler_takes_a_dict_through(tmp_path):
    cfg = pooled_checkout(tmp_path)
    parts = harness.reference_parts(cfg, SEED, "cpu")
    ref = registry.family(cfg, "reference")
    uncond = ref.condition(cfg, parts, ["", ""], "cpu")
    cond = ref.condition(cfg, parts, ["a red cat", "a small dog"], "cpu")
    seen = []

    def model(x, t, c):
        seen.append(c)
        return ref.eps(cfg, parts, x, t, c)

    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    e = sampling.guided_eps(model, x, 31, uncond, cond, 5.0)
    both = sampling.cat_rows(uncond, cond)
    whole = ref.eps(cfg, parts, torch.cat([x, x]), torch.full((4,), 31), both)
    assert torch.equal(e, whole[:2] + 5.0 * (whole[2:] - whole[:2]))
    s = sampling.Schedule(0.00085, 0.012, 100, 10, 0.1)
    noise = torch.randn(6, 2, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    sampling.dpm_encode(s, model, x, uncond, cond, 1.0, 5, noise[0], noise[1:])
    assert len(seen) == 1 + 5
    for c in seen:
        assert set(c) == {"context", "vector"}
        assert torch.equal(c["vector"], torch.cat([uncond["vector"], cond["vector"]]))
        assert torch.equal(c["context"], torch.cat([uncond["context"], cond["context"]]))
    four = sampling.repeat_rows(cond, 2)
    assert torch.equal(four["vector"], cond["vector"].repeat(2, 1))


def test_a_fault_in_the_vector_is_not_correct(tmp_path, monkeypatch):
    cfg = pooled_checkout(tmp_path)
    parts = harness.reference_parts(cfg, SEED, "cpu")
    req = edit.make_request(cfg, TINY_MIX, SEED, 0, "cpu")
    ref = registry.family(cfg, "reference")
    good = ref.condition

    def faulty(*args):
        c = good(*args)
        return dict(c, vector=1.02 * c["vector"])

    monkeypatch.setattr(ref, "condition", faulty)
    outs = edit.reference_outputs(cfg, TINY_MIX, parts, req)
    monkeypatch.setattr(ref, "condition", good)
    readings = edit.readings(cfg, TINY_MIX, parts, req, outs)
    correct = compare.judge(readings, TINY_LIMITS)[0]
    assert not correct and readings["ctx"] > TINY_LIMITS["ctx"], readings


def test_conditionings_of_another_structure_differ():
    t = torch.ones(2, 3)
    assert compare.worst_rel_rms(t, t) == 0.0
    assert compare.worst_rel_rms({"context": t}, {"context": t, "vector": t}) == math.inf
    assert compare.worst_rel_rms(t, {"context": t}) == math.inf
    assert compare.worst_rel_rms(None, t) == math.inf
    assert compare.worst_rel_rms({"a": t, "b": 2 * t}, {"b": t, "a": t}) == 1.0
