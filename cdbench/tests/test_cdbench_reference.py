"""The frozen reference against the port at tiny sizes (float32, CPU), the
control's readings, and runs whose timed path is broken underneath."""

from __future__ import annotations

import json

import pytest
import torch

from cdbench import harness
from cdbench.drivers import edit, ensemble, guided
from cdbench.registry import family
from cdbench.tests.conftest import (REPO, TINY_BERT, TINY_CONFIG, TINY_ENSEMBLE_MIX,
                                    TINY_GUIDED, TINY_GUIDED_MIX, TINY_MIX)
from cdbench.weights import draw_state_dict
from cyclediffusion_tpu_torch.pipelines import latent_text
from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore, LatentCoreSpec

SEED = 2 ** 33 + 17


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("cfg", [TINY_CONFIG, TINY_BERT], ids=["clip", "bert"])
def test_modules_match_the_port(cfg):
    sd = draw_state_dict(cfg, SEED, "cpu", torch.float32)
    core = family(cfg, "cores").load_core(cfg, sd, "cpu", torch.float32)
    parts = family(cfg, "reference").build_parts(cfg["arch"], "cpu")
    for prefix, m in parts.values():
        m.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    unet, fs, cond = (parts[k][1] for k in ("unet", "first_stage", "cond"))
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 90, (2, 16), generator=g)
    assert rel(core.get_learned_conditioning_eager(ids), cond(ids)) < 1e-5
    ctx = cond(ids)
    x = torch.randn(2, 8, 8, 4, generator=g)
    t = torch.tensor([3, 61])
    assert rel(core.apply_model_eager(x, t, ctx), unet(x, t, ctx)) < 1e-5
    img = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    noise = torch.randn(2, 8, 8, 4, generator=g)
    assert rel(core.encode_first_stage_eager(img, noise) / 0.18215, fs.encode(img, noise)) < 1e-5
    assert rel(core.decode_first_stage_eager(x * 0.18215), fs.decode(x)) < 1e-5


def test_spec_matches_the_presets():
    for name, preset in (("sd14-512", LatentCoreSpec.sd_v1()),
                         ("ldm-t2i-large-256", LatentCoreSpec.ldm_text2img_large())):
        cfg = json.loads((REPO / "cdbench" / "configs" / f"{name}.json").read_text())
        assert family(cfg, "cores").core_spec(cfg) == preset
        assert cfg["preset"] == preset.name


@pytest.mark.parametrize("cfg,mix,cell", [
    (TINY_CONFIG, TINY_MIX, "sd14-edit-b4"),
    (TINY_GUIDED, TINY_GUIDED_MIX, "sd14-guided-w005"),
    (TINY_GUIDED, TINY_ENSEMBLE_MIX, "sd14-ensemble-s50")], ids=["edit", "guided", "ensemble"])
def test_control_fails_the_cells_limits(cfg, mix, cell):
    """The float8 control in the program's place, on the tiny request,
    reads above the cell's limits on at least one number."""
    driver = {"edit": edit, "guided": guided, "ensemble": ensemble}[mix["driver"]]
    names = harness.part_names(cfg, driver)
    req = driver.make_request(cfg, mix, SEED, 0, "cpu")
    got = driver.reference_outputs(
        cfg, mix, harness.reference_parts(cfg, SEED, "cpu", names, control=True), req)
    readings = driver.readings(cfg, mix, harness.reference_parts(cfg, SEED, "cpu", names), req,
                               got)
    limits = json.loads((REPO / "cdbench" / "limits" / f"{cell}.json").read_text())
    assert any(readings[k] > limits[k] for k in limits), readings


def _unchanged_step(x, e_t, a_t, a_prev, sigma_t, s1ma, noise, temperature=1.0):
    return x, x


def _half_batch(original):
    def decode_chains(self, xT, eps, c_ctx, uc_ctx, *args):
        half = xT.shape[1] // 2
        out = original(self, xT[:, :half], eps[:, :, :half], c_ctx[:half], uc_ctx[:half], *args)
        return torch.cat([out, out], dim=1)
    return decode_chains


def _half_candidates(original):
    """Half the candidates folded into a launch's batch left out (one
    image a request: the batch is the candidates)."""
    def decode_chains(self, xT, eps, c_ctx, uc_ctx, scales, *args):
        half = max(1, xT.shape[0] // 2)
        out = original(self, xT[:half], eps[:half], c_ctx, uc_ctx, scales[:half], *args)
        return torch.cat([out, out])[:xT.shape[0]]
    return decode_chains


def _altered_answer(original):
    def decode(self, z):
        out = original(self, z)
        return torch.cat([out[:1] * 0.98, out[1:]])
    return decode


def _wrong_candidate(original):
    """The ranking's worst candidate chosen in place of its best."""
    def rank(self, *args):
        scores, _ = original(self, *args)
        return scores, torch.argmin(scores, dim=1)
    return rank


def _reversed_direction(original):
    """The text direction taken from the target prompt to the source."""
    def rank(self, img_ensemble, original_img01, encode_text, decode_text):
        return original(self, img_ensemble, original_img01, decode_text, encode_text)
    return rank


@pytest.mark.parametrize("cell,fault", [
    ("tiny-clip-32.tiny_edit", "unchanged_step"), ("tiny-clip-32.tiny_edit", "half_batch"),
    ("tiny-clip-32.tiny_edit", "altered_answer"),
    ("tiny-guided-32.tiny_guided", "unchanged_step"),
    ("tiny-guided-32.tiny_guided", "altered_answer"),
    ("tiny-ensemble-32.tiny_ensemble", "unchanged_step"),
    ("tiny-ensemble-32.tiny_ensemble", "half_batch"),
    ("tiny-ensemble-32.tiny_ensemble", "altered_answer"),
    ("tiny-ensemble-32.tiny_ensemble", "wrong_candidate"),
    ("tiny-ensemble-32.tiny_ensemble", "reversed_direction")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    if fault == "unchanged_step":
        monkeypatch.setattr("cyclediffusion_tpu_torch.ops.steps.ddim_step", _unchanged_step)
    elif fault == "half_batch":
        broken = _half_candidates if "ensemble" in cell else _half_batch
        monkeypatch.setattr(latent_text.StochasticTextPipeline, "_decode_chains",
                            broken(latent_text.StochasticTextPipeline._decode_chains))
    elif fault in ("wrong_candidate", "reversed_direction"):
        broken = _wrong_candidate if fault == "wrong_candidate" else _reversed_direction
        monkeypatch.setattr(latent_text.StochasticTextPipeline, "rank",
                            broken(latent_text.StochasticTextPipeline.rank))
    else:
        monkeypatch.setattr(LatentDiffusionCore, "decode_first_stage",
                            _altered_answer(LatentDiffusionCore.decode_first_stage))
    out = harness.run_cell(tiny_root, cell, SEED, 0.2, False, 0.0, device="cpu")
    assert out["line"]["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["line"]["checks"].values())
