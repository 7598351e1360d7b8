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


def port_fields(config, theirs: dict) -> dict:
    """``dataclasses.asdict(config)`` without the fields that the JAX
    package's config (``theirs``, as a dict) lacks: the port's own options
    (SDXL's depth by level, linear projections, vector conditioning, exact
    GEGLU), each checked to be at its default, the JAX behaviour."""
    import dataclasses

    defaults = {f.name: f.default for f in dataclasses.fields(config)}
    ours = dataclasses.asdict(config)
    own = {k: v for k, v in ours.items() if k not in theirs}
    assert own == {k: defaults[k] for k in own}, own
    return {k: v for k, v in ours.items() if k in theirs}


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
    too (FID and Inception included), and guided sampling's, the samplers',
    the energies', the tiled first stage's and the plain pipeline's, and the
    process group, tensor parallelism, the optimisers, the Flax msgpack
    reader and writer (the card's machine has no ``msgpack`` either), the
    GIF decoder and the inverse Flax converter."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "for blocked in ('PIL', 'cv2', 'pandas', 'msgpack', 'optax'):\n"
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
        "        'data.preprocess.afhqwild256', 'tools.pixel_assets', 'samplers.guided',\n"
        "        'energy.clip_energy', 'energy.prior_z', 'energy.factory', 'ops.fold',\n"
        "        'pipelines.latentdiff_plain', 'tools.guided_probe', 'parallel',\n"
        "        'parallel.mesh', 'parallel.tp', 'runtime.optim', 'convert.flax_msgpack',\n"
        "        'data.gif', 'data.jpeg', 'convert.to_jax', 'runtime.graphs'}\n"
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
        "from cyclediffusion_tpu_torch.samplers import (ddim_sample, ddim_invert,\n"
        "    stochastic_encode, stochastic_decode, energy_guided_decode)\n"
        "from cyclediffusion_tpu_torch.energy import get_energy, parse_key, prior_z_energy\n"
        "from cyclediffusion_tpu_torch.energy.clip_energy import clip_energy_fn\n"
        "from cyclediffusion_tpu_torch.ops.fold import split_first_stage_apply\n"
        "from cyclediffusion_tpu_torch.pipelines.latentdiff_plain import LatentDiffPlainPipeline\n"
        "from cyclediffusion_tpu_torch.parallel import init_distributed, data_mesh\n"
        "from cyclediffusion_tpu_torch.parallel.tp import shard_params_tp, tp_param_specs\n"
        "from cyclediffusion_tpu_torch.runtime.optim import AdamW, Adafactor\n"
        "from cyclediffusion_tpu_torch.convert.flax_msgpack import from_bytes\n"
        "from cyclediffusion_tpu_torch.runtime.graphs import GraphedCall\n"
        "missing = {w for w in want if 'cyclediffusion_tpu_torch.' + w not in names}\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'flax', 'cyclediffusion_tpu', 'PIL', 'cv2', 'pandas',"
        " 'msgpack', 'optax')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 50


def tiny_latent_cores(cond_kind=None, fs_kind: str = "kl", seed: int = 3,
                      resolution: int = 32):
    """(JAX core, port core on the CPU) of ``LatentCoreSpec.tiny`` sharing
    one filled parameter tree."""
    import jax.numpy as jnp

    from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
    from cyclediffusion_tpu.pipelines.latent import LatentDiffusionCore as JCore
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore

    jspec = JSpec.tiny(cond_kind=cond_kind, resolution=resolution, fs_kind=fs_kind)
    shell = JCore(jspec, {})
    k = jax.random.PRNGKey(0)
    lat = jspec.image_size
    ctx = None if cond_kind is None else jnp.zeros((1, 8, jspec.unet.context_dim))
    img = jnp.zeros((1, resolution, resolution, 3))
    fs_args = (img, jnp.zeros((1, lat, lat, jspec.embed_dim))) if fs_kind == "kl" else (img,)
    shapes = {
        "unet": jax.eval_shape(shell.unet.init, k, jnp.zeros((1, lat, lat, 4)),
                               jnp.zeros((1,), jnp.int32), ctx),
        "first_stage": jax.eval_shape(shell.first_stage.init, k, *fs_args),
    }
    if cond_kind is not None:
        shapes["cond"] = jax.eval_shape(shell.cond_model.init, k,
                                        jnp.zeros((1, 8), jnp.int32))
    tree = fill_flax_tree(shapes, seed)
    jcore = JCore(jspec, jax.tree.map(jnp.asarray, tree))
    core = LatentDiffusionCore.from_jax_params(
        LatentCoreSpec.tiny(cond_kind, resolution, fs_kind), tree, device="cpu")
    return jcore, core


# the start of every rank's program under run_ranks: argv is (rank, world
# size, file:// init method, work dir); the rank joins one gloo group and
# fails within a minute if another rank does not come
RANK_PREAMBLE = """
import json, os, sys
rank, world, init, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch
torch.set_num_threads(1)
from cyclediffusion_tpu_torch.parallel import init_distributed
init_distributed(init, rank=rank, world_size=world, backend="gloo", timeout_s=60)
"""
# and its end: no rank leaves the group while another may still talk to it
# (a process that exits with gloo's threads alive aborts)
RANK_POSTAMBLE = """
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def start_ranks(code: str, world: int, work) -> list:
    """Start ``RANK_PREAMBLE + code + RANK_POSTAMBLE`` as ``world``
    processes on the CPU, joined by a ``file://`` init in ``work`` -> the
    processes (see :func:`wait_ranks`)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    init = "file://" + os.path.join(str(work), "process_group_init")
    program = RANK_PREAMBLE + code + RANK_POSTAMBLE
    return [subprocess.Popen([sys.executable, "-c", program, str(r), str(world), init, str(work)],
                             cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(world)]


def wait_ranks(procs: list, timeout: float = 180) -> list:
    """Wait for every process at most ``timeout`` seconds, killing any left
    past it -> their outputs; each must have exited 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {len(procs)} failed:\n{out[-3000:]}"
    return outs


def run_ranks(code: str, world: int, work, timeout: float = 180) -> list:
    """:func:`start_ranks`, then :func:`wait_ranks`."""
    return wait_ranks(start_ranks(code, world, work), timeout)
