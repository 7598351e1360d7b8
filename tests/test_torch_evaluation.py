"""The port's evaluators and visualizer against the JAX package's.

PSNR, SSIM and L2 agree to 1e-6 on seeded image pairs (float64 filters on
both sides; the JAX package filters with OpenCV, the port with
``scipy.ndimage``, in other summation orders).  ``translate_text`` and
``multi_task`` run with the same tiny DirectionalCLIP weights (the JAX
scorer's tree carried over by ``convert.from_jax``): clip and d-clip agree
to 1e-4 (the tolerance of ``test_torch_clip.py``), the other metrics to
1e-6; the port's CSV parses to the values of the JAX package's pandas CSV
at the same tolerances.  The visualizer's grid decodes to the JAX grid's
pixels exactly; its bicubic 256 px copy may differ by 2/255 (Pillow's
fixed-point weights against float weights in two rounded passes) and
measures at most 1/255.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from cyclediffusion_tpu.energy.clean_clip import CLIPScorer as JScorer
from cyclediffusion_tpu.energy.clean_clip import DirectionalCLIP as JDirectionalCLIP
from cyclediffusion_tpu.evaluation import multi_task as jmulti_task
from cyclediffusion_tpu.evaluation import translate_text as jtranslate_text
from cyclediffusion_tpu.evaluation import utils as jutils
from cyclediffusion_tpu.models.clip import CLIPConfig as JCLIPConfig
from cyclediffusion_tpu.runtime import context as jcontext
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from cyclediffusion_tpu.visualization.multi_image import Visualizer as JVisualizer
from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
from cyclediffusion_tpu_torch.evaluation import empty, multi_task, translate_text, utils
from cyclediffusion_tpu_torch.pipelines.factory import TINY_CLIP
from cyclediffusion_tpu_torch.runtime import context
from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.text import HashTokenizer
from cyclediffusion_tpu_torch.visualization.multi_image import Visualizer, _make_grid

METRIC_TOL = 1e-6
CLIP_TOL = 1e-4
TEXTS = [("a photo of a cat", "a photo of a dog"), ("a red car", "a blue car"),
         ("an old house", "a new house")]


def _pairs(n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    orig = rng.uniform(size=(n, size, size, 3)).astype(np.float32)
    trans = np.clip(orig + 0.2 * rng.standard_normal(orig.shape), -0.1, 1.1).astype(np.float32)
    return orig, trans


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_primitives_match_jax(seed):
    orig, trans = _pairs(2, size=40, seed=seed)
    a, b = orig[0], np.clip(trans[0], 0, 1)
    assert abs(utils.calculate_psnr(a, b) - jutils.calculate_psnr(a, b)) < METRIC_TOL
    assert abs(utils.calculate_l2(a, b) - jutils.calculate_l2(a, b)) < METRIC_TOL
    for x, y in ((a * 255, b * 255), (a[..., :1] * 255, b[..., :1] * 255),
                 (a[..., 0] * 255, b[..., 0] * 255)):
        assert abs(utils.calculate_ssim(x, y) - jutils.calculate_ssim(x, y)) < METRIC_TOL
    assert utils.calculate_psnr(a, a) == 100.0
    with pytest.raises(ValueError):
        utils.calculate_ssim(a, b[:-1])


def test_save_image_and_ensure_empty_dir(tmp_path):
    img = _pairs(1)[0][0]
    d = str(tmp_path / "gen")
    utils.ensure_empty_dir(d)
    utils.save_image(os.path.join(d, "0.png"), img)
    jutils.save_image(str(tmp_path / "j.png"), img)
    with Image.open(os.path.join(d, "0.png")) as a, Image.open(str(tmp_path / "j.png")) as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    utils.ensure_empty_dir(d)
    assert os.listdir(d) == []


@pytest.fixture(scope="module")
def scorers():
    """(JAX DirectionalCLIP, port DirectionalCLIP) with one tiny tree."""
    jcfg = JCLIPConfig(**vars(TINY_CLIP))
    jscorer = JScorer.random_init(jax.random.PRNGKey(3), jcfg)
    params = jax.tree.map(np.asarray, jscorer.params)
    return (JDirectionalCLIP(jscorer, JHashTokenizer(96, 16)),
            DirectionalCLIP(CLIPScorer.from_jax_params(params, TINY_CLIP, "cpu"),
                            HashTokenizer(96, 16)))


@pytest.fixture
def installed(scorers):
    jcontext.reset()
    context.reset()
    jcontext.set_directional_clip(scorers[0])
    context.set_directional_clip(scorers[1])
    yield
    jcontext.reset()
    context.reset()


def _meta(get_cfg, out_dir):
    meta = get_cfg("experiments/tiny_text_translation.cfg")
    meta.output_dir = out_dir
    return meta


def _assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        tol = CLIP_TOL if "clip" in k else METRIC_TOL
        assert abs(got[k] - want[k]) < tol, (k, got[k], want[k])


def test_translate_text_matches_jax(installed, tmp_path):
    orig, trans = _pairs(3)
    data = [{"encode_text": e, "decode_text": d} for e, d in TEXTS]
    images = list(zip(orig, trans))
    out = {side: str(tmp_path / side) for side in ("jax", "port")}
    for d in out.values():
        os.makedirs(d)
    task = get_config("tasks/tiny_translate_text.cfg")
    want = jtranslate_text.Evaluator(None, _meta(jget_config, out["jax"])).evaluate(
        images, None, [0.0] * 3, {}, data, "eval")
    got = translate_text.Evaluator(task, _meta(get_config, out["port"])).evaluate(
        images, None, [0.0] * 3, {}, data, "eval")
    assert np.isfinite(list(got.values())).all()
    _assert_metrics_close(got, want)

    jcsv = pd.read_csv(os.path.join(out["jax"], "eval_results.csv"))
    csv = pd.read_csv(os.path.join(out["port"], "eval_results.csv"))
    assert list(csv.columns) == list(jcsv.columns)
    assert csv[["encode_text", "decode_text"]].equals(jcsv[["encode_text", "decode_text"]])
    for col in ("clip", "dclip", "psnr", "ssim", "l2"):
        tol = CLIP_TOL if "clip" in col else METRIC_TOL
        np.testing.assert_allclose(csv[col], jcsv[col], rtol=0, atol=tol)
    for i in range(3):
        with Image.open(os.path.join(out["port"], "temp_gen", f"{i}.png")) as a, \
                Image.open(os.path.join(out["jax"], "temp_gen", f"{i}.png")) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_translate_text_without_scorer_gives_nan(tmp_path, monkeypatch):
    monkeypatch.delenv("CYCLEDIFFUSION_CLIP_CKPT", raising=False)
    context.reset()
    orig, trans = _pairs(1)
    got = translate_text.Evaluator(None, _meta(get_config, str(tmp_path))).evaluate(
        list(zip(orig, trans)), None, [0.0], {}, [{"encode_text": "a", "decode_text": "b"}],
        "test")
    assert np.isnan(got["clip"]) and np.isnan(got["d-clip"]) and np.isfinite(got["psnr"])
    csv = pd.read_csv(str(tmp_path / "test_results.csv"))
    assert np.isnan(csv["clip"][0])
    context.reset()


class _Dataset:
    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(self.data)


def test_multi_task_matches_jax(installed, tmp_path):
    orig, trans = _pairs(3, seed=5)
    data = [{"name": "translate", "encode_text": e, "decode_text": d} for e, d in TEXTS]
    kw = dict(images=(orig, trans), model=None, weighted_loss=[0.0] * 3,
              losses={"l": [1.0, 2.0, 3.0]}, dataset=_Dataset(data), split="eval")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(pdir)
    want = jmulti_task.Evaluator(_meta(jget_config, jdir)).evaluate(**kw)
    got = multi_task.Evaluator(_meta(get_config, pdir)).evaluate(**kw)
    assert set(got) == {"translate/psnr", "translate/ssim", "translate/l2", "translate/clip",
                        "translate/d-clip", "avr"}
    _assert_metrics_close(got, want)
    with pytest.raises(ValueError):
        multi_task.Evaluator(_meta(get_config, pdir)).evaluate(**dict(kw, split="train"))


def test_empty_evaluator():
    assert empty.Evaluator(None, None).evaluate(None, None, [], {}, [], "eval") == {}


def _read(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(int)


@pytest.mark.parametrize("k,n,size", [(2, 3, 16), (3, 2, 16), (2, 10, 16), (2, 2, 300)])
def test_visualizer_matches_jax(k, n, size, tmp_path):
    """16 px tiles are upscaled to the 256 px copy, 300 px ones downscaled;
    a third set of half the size is nearest-upsampled into the grid."""
    rng = np.random.default_rng(size + n)
    sets = [rng.uniform(size=(n, size, size, 3)).astype(np.float32) for _ in range(2)]
    if k == 3:
        sets.append(rng.uniform(size=(n, size // 2, size // 2, 3)).astype(np.float32))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JVisualizer(None).visualize(tuple(sets), None, "eval", jdir, 7)
    Visualizer(None).visualize(tuple(sets), None, "eval", pdir, 7)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "eval_000007.png", "eval_256_000007.png"]
    np.testing.assert_array_equal(_read(os.path.join(pdir, "eval_000007.png")),
                                  _read(os.path.join(jdir, "eval_000007.png")))
    small = np.abs(_read(os.path.join(pdir, "eval_256_000007.png"))
                   - _read(os.path.join(jdir, "eval_256_000007.png")))
    assert small.max() <= 2


def test_make_grid_dimensions():
    grid = _make_grid(np.zeros((10, 16, 16, 3), np.float32), nrows=8, pad=2)
    assert grid.shape == (2 * 18 + 2, 8 * 18 + 2, 3)
