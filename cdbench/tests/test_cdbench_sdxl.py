"""The ``sdxl`` model family: the full configuration's published names,
parameter counts and operation counts on the meta device, the port's spec
of it against ``LatentCoreSpec.sdxl_base``, and a tiny SDXL-shaped cell run
to ``correct`` through the unchanged edit driver on the CPU."""

from __future__ import annotations

import json

from cdbench import counts, harness
from cdbench.registry import family
from cdbench.tests.conftest import REPO, TINY_LIMITS

SEED = 2 ** 33 + 41
CELL = "tiny-sdxl-32.tiny_edit"

# SDXL's shape at a CPU size: three levels, attention at ds 2 and 4 with
# depths 2 and 3 (3 in the middle), heads of 8 channels, two towers (the
# first read at its second of three layers), a vector of 16 + 6 x 8
TINY_SDXL = {
    "name": "tiny-sdxl-32", "source": "a CPU miniature of sdxl-base-1024", "family": "sdxl",
    "preset": "tiny_sdxl", "dtype": "float32", "resolution": 32,
    "arch": {
        "unet": {"in_channels": 4, "out_channels": 4, "model_channels": 32,
                 "channel_mult": [1, 2, 4], "num_res_blocks": 1,
                 "attention_resolutions": [4, 2], "num_head_channels": 8,
                 "transformer_depth": [1, 2, 3], "context_dim": 40, "adm_in_channels": 64,
                 "num_classes": "sequential", "use_linear_in_transformer": True},
        "first_stage": {"ch": 32, "ch_mult": [1, 2, 4], "num_res_blocks": 1, "in_channels": 3,
                        "out_ch": 3, "z_channels": 4, "embed_dim": 4, "resolution": 32},
        "text_l": {"vocab_size": 96, "width": 16, "layers": 3, "heads": 2, "ff": 32,
                   "context_length": 16, "layer_idx": 2},
        "text_g": {"vocab_size": 96, "width": 24, "layers": 3, "heads": 4, "mlp": 48,
                   "context_length": 16, "embed_dim": 16},
        "size_embed_dim": 8, "micro_conditioning": [32, 32, 0, 0, 32, 32],
        "scale_factor": 0.13025, "linear_start": 0.00085, "linear_end": 0.012,
        "timesteps": 100},
    "reduced": [], "assumed": [], "counts": {},
}


def full_config() -> dict:
    return json.loads((REPO / "cdbench" / "configs" / "sdxl-base-1024.json").read_text())


def test_full_configuration_on_meta():
    cfg = full_config()
    ref = family(cfg, "reference")
    parts = ref.build_parts(cfg["arch"], "meta")
    assert {k: sum(p.numel() for p in m.parameters()) for k, (_, m) in parts.items()} \
        == cfg["parameters"]
    # the published sizes: the UNet's 2.57 B and OpenCLIP bigG's text tower
    assert cfg["parameters"]["unet"] == 2_567_463_684
    assert cfg["parameters"]["text_g"] == 694_659_841
    names = {prefix + k for prefix, m in parts.values() for k, _ in m.named_parameters()}
    for key in ("model.diffusion_model.label_emb.0.0.weight",
                "model.diffusion_model.label_emb.0.2.bias",
                "model.diffusion_model.input_blocks.4.1.proj_in.weight",
                "model.diffusion_model.middle_block.1.transformer_blocks.9.ff.net.0.proj.weight",
                "conditioner.embedders.0.transformer.text_model.encoder.layers.11.mlp.fc2.bias",
                "conditioner.embedders.1.model.transformer.resblocks.31.attn.in_proj_weight",
                "conditioner.embedders.1.model.text_projection",
                "conditioner.embedders.1.model.logit_scale",
                "first_stage_model.decoder.mid.attn_1.q.weight"):
        assert key in names, key
    assert not any(n.startswith("cond_stage_model.") for n in names)
    assert parts["unet"][1].input_blocks[4][1].proj_in.weight.shape == (640, 640)
    assert cfg["counts"] == counts.model_flops(cfg)


def test_full_attention_shapes():
    shapes = counts.self_attention_shapes(full_config())
    assert len(shapes) == 70
    assert shapes.count((4096, 10, 64)) == 10 and shapes.count((1024, 20, 64)) == 60
    assert shapes[:4] == [(4096, 10, 64)] * 4 and shapes[-6:] == [(4096, 10, 64)] * 6


def test_the_port_spec_is_the_preset():
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec

    cfg = full_config()
    assert family(cfg, "cores").core_spec(cfg) == LatentCoreSpec.sdxl_base()


def add_tiny_sdxl(root) -> None:
    """The tiny SDXL configuration, its limits and its cell, as new files and
    new entries in ``BENCHMARK.json``."""
    d = root / "cdbench"
    cfg = json.loads(json.dumps(TINY_SDXL))
    cfg["counts"] = counts.model_flops(cfg)
    (d / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (d / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": cfg["name"], "traffic": "tiny_edit",
                               "chips": 1, "why": "CPU test: the sdxl family"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_tiny_sdxl_cell_runs_correct(tiny_root):
    add_tiny_sdxl(tiny_root)
    out = harness.run_cell(tiny_root, CELL, SEED, 0.2, True, 0.0, device="cpu")
    line = out["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == set(TINY_LIMITS) | {"failed_requests"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    # the unconditional contexts are zeros on both sides, and compared
    assert out["side"]["readings"]["ctx"] < TINY_LIMITS["ctx"]


def test_a_tiny_sdxl_cell_catches_an_encoded_empty_prompt(tiny_root, monkeypatch):
    from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore

    add_tiny_sdxl(tiny_root)
    real = LatentDiffusionCore.get_learned_conditioning

    def encoded(self, token_ids, unconditional=False):
        return real(self, token_ids)

    monkeypatch.setattr(LatentDiffusionCore, "get_learned_conditioning", encoded)
    out = harness.run_cell(tiny_root, CELL, SEED, 0.2, False, 0.0, device="cpu")
    assert out["line"]["correct"] is False
    assert out["line"]["checks"]["ctx"]["value"] > TINY_LIMITS["ctx"]
