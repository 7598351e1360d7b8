"""Shared helpers of the PyTorch-port parity tests, and the port's
JAX-free import check.

Every parity test feeds the JAX package and its PyTorch port the same
numbers: inputs and weights drawn from ``np.random.default_rng(seed)``, and
for a model, one Flax parameter tree filled with seeded normals (the
zero-initialised layers included, so that no path is hidden behind a zero)
that goes to JAX as it is and to the port through ``convert.from_jax``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def fill_flax_tree(tree, seed: int):
    """Seeded normals in the shape of a Flax tree (leaves with a ``shape``:
    arrays or ``jax.eval_shape`` structs): kernels
    and embeddings std 1/sqrt(fan_in), norm scales 1 + 0.1 N(0,1), biases
    and other vectors 0.1 N(0,1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(leaf.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(shape[:-1]))
        if len(shape) >= 2:          # embeddings, position embeddings
            return z / np.sqrt(shape[-1])
        if name == "scale":
            return 1.0 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, tree)


def to_torch(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def max_abs(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


def test_fill_flax_tree_draws_every_leaf():
    tree = {"params": {"dense": {"kernel": np.zeros((4, 3)), "bias": np.zeros(3)},
                       "norm": {"scale": np.zeros(3), "bias": np.zeros(3)}}}
    out = fill_flax_tree(tree, 0)["params"]
    assert np.all(out["dense"]["kernel"] != 0)
    assert abs(float(out["norm"]["scale"].mean()) - 1.0) < 0.3
    again = fill_flax_tree(tree, 0)["params"]
    np.testing.assert_array_equal(out["dense"]["kernel"], again["dense"]["kernel"])


def test_port_imports_without_jax():
    """Every module of the port imports with jax and flax made unimportable
    (the card's machine has neither), and with PIL, cv2 and pandas too
    (that machine does not promise them); none pulls in the JAX package.
    The fast mode's, LDM-BERT's and the pixel slice's entry points import
    too (FID and Inception included)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "for blocked in ('PIL', 'cv2', 'pandas'):\n"
        "    sys.modules[blocked] = None\n"
        "import cyclediffusion_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "want = {'pipelines.latent_text', 'pipelines.factory', 'models.clip',\n"
        "        'energy.clean_clip', 'runtime.config', 'runtime.context',\n"
        "        'tasks.text_unsupervised_translation', 'text.tokenizer', 'main', 'utils',\n"
        "        'runtime.registry', 'runtime.driver', 'runtime.profiling',\n"
        "        'convert.from_torch', 'data.png', 'data.transforms', 'data.raw',\n"
        "        'data.preprocess.common', 'data.preprocess.translate_text512',\n"
        "        'data.preprocess.translate_text256', 'data.preprocess.tiny_text',\n"
        "        'data.preprocess.to_model', 'evaluation.utils', 'evaluation.translate_text',\n"
        "        'evaluation.multi_task', 'evaluation.empty', 'visualization.multi_image',\n"
        "        'tools.sd_assets', 'samplers.ddim', 'ops.cfg', 'models.text_encoders',\n"
        "        'models.unet_gd', 'pipelines.latent', 'convert.from_torch',\n"
        "        'tasks.unsupervised_translation', 'data.preprocess.ffhq256',\n"
        "        'data.preprocess.tiny_images', 'tools.ldm_assets', 'samplers.pixel',\n"
        "        'pipelines.zoo', 'pipelines.ddpm_ddim', 'models.unet_ddpm',\n"
        "        'models.inception', 'convert.inception_import', 'evaluation.fid',\n"
        "        'evaluation.translate_to_dog', 'data.preprocess.afhqcat256',\n"
        "        'data.preprocess.afhqwild256', 'tools.pixel_assets'}\n"
        "from cyclediffusion_tpu_torch.samplers import dpm_encode_cached, ddim_decode_cached\n"
        "from cyclediffusion_tpu_torch.ops.cfg import cfg_model_fn_pair\n"
        "from cyclediffusion_tpu_torch.models.text_encoders import LDMBertEncoder\n"
        "from cyclediffusion_tpu_torch.text import BertWordPieceTokenizer\n"
        "from cyclediffusion_tpu_torch.convert.from_torch import convert_ldm_bert\n"
        "from cyclediffusion_tpu_torch.pipelines.latent_text import (\n"
        "    latentdiff_stochastic_text_pipeline)\n"
        "from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffStochasticPipeline\n"
        "from cyclediffusion_tpu_torch.models.autoencoder import VQModel\n"
        "from cyclediffusion_tpu_torch.models.nn import GDAttentionBlock\n"
        "from cyclediffusion_tpu_torch.samplers import ddim_refine\n"
        "from cyclediffusion_tpu_torch.samplers import pixel_encode, pixel_generate\n"
        "from cyclediffusion_tpu_torch.pipelines.ddpm_ddim import DDPMDDIMPipeline\n"
        "from cyclediffusion_tpu_torch.pipelines.zoo import PIXEL_ZOO\n"
        "from cyclediffusion_tpu_torch.models.inception import InceptionV3Features\n"
        "from cyclediffusion_tpu_torch.evaluation.fid import compute_fid_kid\n"
        "missing = {w for w in want if 'cyclediffusion_tpu_torch.' + w not in names}\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'flax', 'cyclediffusion_tpu', 'PIL', 'cv2', 'pandas')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 50
