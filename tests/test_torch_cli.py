"""The port's command line end to end on the CPU, on the tiny text config,
with what ``tests/test_e2e_main.py`` asserts of the JAX CLI; its images
against the task model run directly with the same seed (equal as the PNGs'
uint8); the registry and the packaged config root.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cyclediffusion_tpu_torch import main as cli
from cyclediffusion_tpu_torch.data.png import read_png
from cyclediffusion_tpu_torch.evaluation.utils import to_uint8
from cyclediffusion_tpu_torch.runtime import context, registry
from cyclediffusion_tpu_torch.runtime.config import config_root, get_config
from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import (
    TextUnsupervisedTranslation,
)
from test_torch_common import REPO

CFG = "experiments/tiny_text_translation.cfg"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(output dir, returned metrics) of one tiny CLI run on the CPU."""
    context.reset()
    out = str(tmp_path_factory.mktemp("cli") / "text")
    metrics = cli.main(["--cfg", CFG, "--output_dir", out, "--seed", "42", "--do_eval",
                        "--per_device_eval_batch_size", "2", "--local_rank", "0"],
                       device="cpu")
    yield out, metrics
    context.reset()


def test_tiny_text_translation_e2e(run):
    out, metrics = run
    for key in ("eval_translate/psnr", "eval_translate/d-clip", "eval_avr"):
        assert np.isfinite(metrics[key]), key
    assert os.path.exists(os.path.join(out, "eval_results.csv"))
    with open(os.path.join(out, "all_results.json")) as f:
        results = json.load(f)
    assert "eval_translate/ssim" in results and results["eval_samples"] == 2
    vis = os.listdir(os.path.join(out, "visualization"))
    assert sorted(vis) == ["eval_000000.png", "eval_256_000000.png"]


def test_cli_images_equal_the_task_model_run_directly(run):
    out, _ = run
    args = get_config(CFG)
    model = TextUnsupervisedTranslation(args, base_seed=42, device="cpu")
    from cyclediffusion_tpu_torch.data.preprocess.tiny_text import Preprocessor
    dev = Preprocessor(None, args).build_dev()
    items = [dev[i] for i in range(2)]
    (_, img), _, _ = model.forward(np.stack([it["sample_id"] for it in items]),
                                   np.stack([it["original_image"] for it in items]),
                                   [it["encode_text"] for it in items],
                                   [it["decode_text"] for it in items])
    for i in range(2):
        png = read_png(os.path.join(out, "temp_gen", f"{i}.png"))
        np.testing.assert_array_equal(png, to_uint8(np.clip(img[i].numpy(), 0, 1)))


def test_parse_training_args_ignores_reference_launch_flags():
    args = cli.parse_training_args(["--cfg", "x.cfg", "--local_rank", "3",
                                    "--greater_is_better", "False"])
    assert args.cfg == "x.cfg" and args.greater_is_better is False
    assert args.per_device_eval_batch_size == 1 and args.num_train_epochs == 0


def test_command_line_refuses_to_run_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "cyclediffusion_tpu_torch.main", "--cfg", CFG,
                           "--output_dir", str(tmp_path / "o"), "--do_eval"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not os.path.exists(tmp_path / "o" / "eval_results.json")


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--cfg", CFG])


def test_config_root_is_packaged(monkeypatch):
    monkeypatch.delenv("CYCLEDIFFUSION_CONFIG_ROOT", raising=False)
    assert config_root() == os.path.join(REPO, "cyclediffusion_tpu_torch", "config")
    monkeypatch.setenv("CYCLEDIFFUSION_CONFIG_ROOT", os.path.join(REPO, "cyclediffusion_tpu",
                                                                  "config"))
    assert get_config("experiments/tiny_text_translation_fast.cfg").gan.fast_key_every == 2


@pytest.mark.parametrize("name", [f"translate_text2img256_{family}_stochastic_{i}"
                                  for family in ("stable_diffusion", "latentdiff")
                                  for i in list(range(1, 9)) + ["full"]]
                         + ["translate_text2img256_stable_diffusion_stochastic_fast",
                            "tiny_text_translation", "tiny_text_translation_latent",
                            "tiny_text_translation_fast"])
def test_packaged_configs_equal_the_jax_packages(name):
    """Every value of the port's copy equals the JAX package's config."""
    from cyclediffusion_tpu.runtime.config import get_config as jget_config
    assert get_config(f"experiments/{name}.cfg").to_dict() == \
        jget_config(f"experiments/{name}.cfg").to_dict()


@pytest.mark.parametrize("getter,name,symbol", [
    (registry.get_model, "text_unsupervised_translation", "TextUnsupervisedTranslation"),
    (registry.get_preprocessor, "translate_text512", "Preprocessor"),
    (registry.get_evaluator, "multi_task", "Evaluator"),
    (registry.get_visualizer, "multi_image", "Visualizer"),
    (registry.get_model, "unsupervised_translation", "UnsupervisedTranslation"),
    (registry.get_preprocessor, "ffhq256", "Preprocessor"),
    (registry.get_preprocessor, "tiny_images", "Preprocessor"),
])
def test_registry_resolves_in_the_port(getter, name, symbol):
    cls = getter(name)
    assert cls.__name__ == symbol and cls.__module__.startswith("cyclediffusion_tpu_torch.")


@pytest.mark.parametrize("getter,name", [
    (registry.get_preprocessor, "afhqwild256"),
    (registry.get_preprocessor, "afhqcat256"),
    (registry.get_evaluator, "translate_to_dog"),
])
def test_registry_names_the_roadmap_for_unported_programs(getter, name):
    """The AFHQ programs, which the registry refused naming the ROADMAP
    item before the pixel slice, resolve in the port now; an unknown name
    raises."""
    cls = getter(name)
    assert cls.__module__.startswith("cyclediffusion_tpu_torch.")
    assert cls.__module__.endswith(f".{name}")
    with pytest.raises(ModuleNotFoundError):
        getter("no_such_program")


def test_max_sample_size_matches_jax():
    from cyclediffusion_tpu.utils import MAX_SAMPLE_SIZE as JMAX
    from cyclediffusion_tpu_torch.utils import MAX_SAMPLE_SIZE
    assert MAX_SAMPLE_SIZE == JMAX == 4096
