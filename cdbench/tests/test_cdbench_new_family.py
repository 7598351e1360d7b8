"""A model family added as new files only: ``reference/tiny_two_towers.py``
and ``cores/tiny_two_towers.py``, a configuration, a limits file and a cell,
with no existing file of ``cdbench/`` edited, run to ``correct`` by the
unchanged edit driver.

The family has two CLIP text towers under prefixes that ``latent_text``
does not use; their last hidden states, side by side along the width, are
the UNet's context.  The program's side is a thin wrapper, written here, of
the port's core around two of the port's CLIP text encoders."""

from __future__ import annotations

import json

import pytest
import torch

from cdbench import counts, harness, registry
from cdbench.tests.conftest import TINY_CONFIG, TINY_LIMITS
from cdbench.tests.test_cdbench_registry import digests
from cdbench.weights import draw_state_dict

SEED = 2 ** 33 + 29
CELL = "tiny-two-towers-32.tiny_edit"
PREFIX_A = "conditioner.embedders.0.transformer.text_model."
PREFIX_B = "conditioner.embedders.1.transformer.text_model."

REFERENCE = f'''"""Two CLIP text towers side by side: the plain reference."""

import torch

from cdbench.counts import latent_size
from cdbench.reference import sampling
from cdbench.reference.latent_text import self_attention_shapes  # noqa: F401  (the same UNet)
from cdbench.reference.models import AutoencoderKL, CLIPText, UNet

PREFIXES = {{"unet": "model.diffusion_model.", "first_stage": "first_stage_model.",
            "text_a": "{PREFIX_A}", "text_b": "{PREFIX_B}"}}
PARTS = ("unet", "first_stage", "text_a", "text_b")


def build_parts(arch, device="cpu", names=PARTS):
    makers = {{"unet": lambda: UNet(**arch["unet"]),
              "first_stage": lambda: AutoencoderKL(arch["first_stage"]),
              "text_a": lambda: CLIPText(arch["text_a"]),
              "text_b": lambda: CLIPText(arch["text_b"])}}
    with torch.device(device):
        return {{n: (PREFIXES[n], makers[n]().eval().requires_grad_(False)) for n in names}}


def _ids(cfg, texts, device):
    a = cfg["arch"]["text_a"]
    return torch.as_tensor(sampling.hash_tokens(texts, a["vocab_size"], a["context_length"]),
                           device=device)


def condition(cfg, parts, texts, device):
    ids = _ids(cfg, texts, device)
    return torch.cat([parts["text_a"][1](ids), parts["text_b"][1](ids)], dim=-1)


def eps(cfg, parts, x, t, cond):
    return parts["unet"][1](x, t, cond)


def unit_calls(cfg, parts):
    arch, n, res = cfg["arch"], latent_size(cfg), cfg["resolution"]
    t, zc = arch["text_a"]["context_length"], arch["first_stage"]["embed_dim"]
    meta = dict(device="meta")
    ids = torch.zeros(1, t, dtype=torch.int64, **meta)
    return {{
        "unet_row": lambda: parts["unet"][1](
            torch.empty(1, n, n, arch["unet"]["in_channels"], **meta),
            torch.zeros(1, dtype=torch.int64, **meta),
            torch.empty(1, t, arch["text_a"]["width"] + arch["text_b"]["width"], **meta)),
        "encode_image": lambda: parts["first_stage"][1].encode(
            torch.empty(1, res, res, 3, **meta), torch.empty(1, n, n, zc, **meta)),
        "decode_image": lambda: parts["first_stage"][1].decode(torch.empty(1, n, n, zc, **meta)),
        "prompt": lambda: (parts["text_a"][1](ids), parts["text_b"][1](ids)),
    }}
'''

CORE = f'''"""Two CLIP text towers side by side: the port's core around them."""

import torch
from torch import nn

from cdbench.registry import family
from cyclediffusion_tpu_torch.convert import from_torch
from cyclediffusion_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore
from cyclediffusion_tpu_torch.runtime import graphs
from cyclediffusion_tpu_torch.text import HashTokenizer


def clip_config(c):
    return CLIPTextConfig(vocab_size=c["vocab_size"], hidden_size=c["width"],
                          num_layers=c["layers"], num_heads=c["heads"],
                          max_positions=c["context_length"], intermediate_size=c["ff"])


class Towers(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a, self.b = a, b

    def forward(self, ids):
        return torch.cat([self.a(ids), self.b(ids)], dim=-1)


class TwoTowerCore(LatentDiffusionCore):
    """The port's core, its one text encoder joined by a second."""

    def __init__(self, spec, tower_b, device, dtype):
        super().__init__(spec, device, dtype)
        with self.device:
            b = CLIPTextEncoder(tower_b).to(dtype=dtype).eval().requires_grad_(False)
        self.cond_model = Towers(self.cond_model, b)
        self._graphed_cond = graphs.GraphedCall(self.cond_model, self._graphed_apply.pool,
                                                name="text", time_device=True)


def load_core(cfg, state_dict, device, dtype):
    a = cfg["arch"]
    # the UNet and first stage are latent_text's, with tower a as its text encoder
    one = dict(cfg, family="latent_text", arch=dict(a, cond=dict(a["text_a"], kind="clip")))
    core = TwoTowerCore(family(one, "cores").core_spec(one), clip_config(a["text_b"]),
                        device, dtype)
    unet_sd, fs_sd, _ = from_torch.split_latent_diffusion_state(state_dict)

    def sub(prefix):
        return {{k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}}

    for module, convert, part in (
            (core.unet, from_torch.convert_gd_unet, unet_sd),
            (core.first_stage, from_torch.convert_vae, fs_sd),
            (core.cond_model.a, from_torch.convert_clip_text, sub("{PREFIX_A}")),
            (core.cond_model.b, from_torch.convert_clip_text, sub("{PREFIX_B}"))):
        module.load_state_dict(convert(part, module), strict=True)
    return core


def tokenizer(cfg):
    a = cfg["arch"]["text_a"]
    return HashTokenizer(a["vocab_size"], a["context_length"])
'''


def two_towers_config() -> dict:
    arch = {k: v for k, v in TINY_CONFIG["arch"].items() if k != "cond"}
    text_a = {"vocab_size": 96, "width": 24, "layers": 2, "heads": 4, "ff": 48,
              "context_length": 16}
    text_b = dict(text_a, width=16, layers=1, heads=2, ff=32)
    arch.update(text_a=text_a, text_b=text_b,
                unet=dict(arch["unet"], context_dim=text_a["width"] + text_b["width"]))
    return dict(TINY_CONFIG, name="tiny-two-towers-32", family="tiny_two_towers",
                source="a CPU miniature with two text towers", arch=arch)


def add_two_towers(root) -> None:
    """The family, its configuration, limits and cell, as new files and
    new entries in ``BENCHMARK.json``."""
    d = root / "cdbench"
    (d / "reference" / "tiny_two_towers.py").write_text(REFERENCE)
    (d / "cores" / "tiny_two_towers.py").write_text(CORE)
    cfg = two_towers_config()
    cfg["counts"] = counts.model_flops(dict(cfg, **{registry.CHECKOUT: str(root)}))
    (d / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (d / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": cfg["name"], "traffic": "tiny_edit",
                               "chips": 1, "why": "CPU test: a second model family"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_family_added_as_new_files_runs_correct(tiny_root):
    before = digests(tiny_root)
    add_two_towers(tiny_root)
    after = digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())
    assert {k for k in after if k not in before} == {
        "cdbench/reference/tiny_two_towers.py", "cdbench/cores/tiny_two_towers.py",
        "cdbench/configs/tiny-two-towers-32.json", f"cdbench/limits/{CELL}.json"}

    reg = registry.Registry(tiny_root)
    cfg = reg.config("tiny-two-towers-32")
    assert harness.part_names(cfg) == ("unet", "first_stage", "text_a", "text_b")
    sd = draw_state_dict(cfg, SEED, "cpu", torch.float32)
    assert any(k.startswith(PREFIX_B) for k in sd)
    assert not any(k.startswith("cond_stage_model.") for k in sd)

    out = harness.run_cell(tiny_root, CELL, SEED, 0.2, True, 0.0, device="cpu")
    line = out["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    # every per-layer metric that the latent_text cell of the same driver
    # reads on this device
    same = harness.run_cell(tiny_root, "tiny-clip-32.tiny_edit", SEED, 0.2, True, 0.0,
                            device="cpu")
    assert set(line["metrics"]) == set(same["line"]["metrics"]) != set()


def test_a_fault_in_the_second_tower_is_not_correct(tiny_root, monkeypatch):
    add_two_towers(tiny_root)
    cfg = registry.Registry(tiny_root).config("tiny-two-towers-32")
    towers = registry.family(cfg, "cores").Towers

    def forward(self, ids):
        return torch.cat([self.a(ids), 0.98 * self.b(ids)], dim=-1)

    monkeypatch.setattr(towers, "forward", forward)
    out = harness.run_cell(tiny_root, CELL, SEED, 0.2, False, 0.0, device="cpu")
    checks = out["line"]["checks"]
    assert out["line"]["correct"] is False and checks["ctx"]["value"] > checks["ctx"]["limit"]


@pytest.mark.card
def test_a_new_family_on_the_card(tiny_root, card):
    torch.backends.cudnn.allow_tf32 = False     # the tiny limits are float32's
    add_two_towers(tiny_root)
    out = harness.run_cell(tiny_root, CELL, 2 ** 32 + 5, 1.0, True, 0.0, device=card)
    same = harness.run_cell(tiny_root, "tiny-clip-32.tiny_edit", 2 ** 32 + 5, 1.0, True, 0.0,
                            device=card)
    assert out["line"]["correct"] is True and out["line"]["device"]["platform"] == "gpu"
    assert set(out["line"]["metrics"]) == set(same["line"]["metrics"])
