"""The port's ``parallel`` package against the JAX package's, on the CPU.

* Row sharding: ``shard_rows`` gives each rank the rows that JAX's
  ``P("data")`` puts on each device of a mesh (``addressable_shards``);
  ``pad_to_multiple`` equals JAX's.
* ``tp_param_specs`` picks the parameters that JAX's rule picks, mapped by
  name through ``convert.from_jax``, on the tiny UNet of
  ``tests/test_tensor_parallel.py`` and on SD v1's UNet tree.
* Two gloo ranks (``test_torch_common.run_ranks``, each with a timeout):
  the mesh helpers; the tiny UNet sharded at ``n_model`` 2 against the
  unsharded call within rtol 2e-4 / atol 2e-5 (the tolerance of JAX's own
  test); and the candidate axis of ``StochasticTextPipeline`` split over
  the ranks (the problem of JAX's ``test_parallel_eval.py``), against the
  unsplit port within 1e-4 (JAX's tolerance for its sharded ensemble:
  ``|a - b| <= 1e-4 + 1e-4 |b|``) and against JAX's ensemble sharded over two
  devices within 2e-4 in the same form (the port-vs-JAX tolerance of
  ``test_torch_ensemble.py``).  A second split draws every noise from seeded
  generators, with ``white_box_steps`` short of the chain so that decoding
  draws a fresh tail too: each rank must draw the whole launch's noise in
  the unsplit order, so it equals the unsplit run on the same seeds within
  1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cyclediffusion_tpu.energy.clean_clip import CLIPScorer as JScorer
from cyclediffusion_tpu.energy.clean_clip import DirectionalCLIP as JDirectional
from cyclediffusion_tpu.models.clip import CLIPConfig as JCLIPConfig
from cyclediffusion_tpu.models.unet_gd import GDUNet as JGDUNet
from cyclediffusion_tpu.models.unet_gd import GDUNetConfig as JGDUNetConfig
from cyclediffusion_tpu.parallel import mesh as jmesh
from cyclediffusion_tpu.parallel.tp import tp_param_specs as jtp_param_specs
from cyclediffusion_tpu.pipelines.latent_text import StochasticTextPipeline as JPipeline
from cyclediffusion_tpu.text import HashTokenizer as JHashTokenizer
from cyclediffusion_tpu_torch.convert.from_jax import _LEAF_NAMES, module_name
from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
from cyclediffusion_tpu_torch.models.clip import CLIPConfig
from cyclediffusion_tpu_torch.models.unet_gd import GDUNet, GDUNetConfig
from cyclediffusion_tpu_torch.parallel import pad_to_multiple, shard_rows
from cyclediffusion_tpu_torch.parallel.tp import tp_param_specs
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.text import HashTokenizer
from test_torch_common import max_abs, start_ranks, tiny_latent_cores, wait_ranks
from test_torch_ensemble import _jax_encode_draws

# the tiny UNet of tests/test_tensor_parallel.py
TINY_UNET = dict(in_channels=4, model_channels=64, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=4,
                 use_spatial_transformer=True, transformer_depth=1, context_dim=32,
                 legacy=False)
# the candidate problem of tests/test_parallel_eval.py
CLIP_CFG = dict(embed_dim=16, image_resolution=32, vision_width=32, vision_layers=2,
                vision_heads=2, patch_size=8, vocab_size=96, context_length=16,
                text_width=32, text_layers=2, text_heads=2)
PIPE_KW = dict(custom_steps=6, eta=0.1, white_box_steps=7, skip_steps=[0, 2],
               encoder_unconditional_guidance_scales=[1.0],
               decoder_unconditional_guidance_scales=[1.0, 3.0], n_trials=3)
# 4 stored entries of a 6-step chain: decoding draws 3 fresh steps at each skip
FRESH_KW = dict(PIPE_KW, white_box_steps=4)
ENC_SEED, DEC_SEED = 5, 6
SRC, TGT = ["a cat"], ["a dog"]
SPLIT_TOL = 1e-4      # JAX's bound between its sharded and unsharded ensembles
JAX_TOL = 2e-4        # port vs JAX, test_torch_ensemble.py's bound
TP_RTOL, TP_ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("n_dev,n", [(8, 16), (8, 8), (4, 12), (2, 6)])
def test_shard_rows_are_jax_data_shards(devices, n_dev, n):
    mesh = jmesh.data_mesh(devices[:n_dev])
    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    order = list(mesh.devices.flat)
    for shard in jmesh.shard_batch(mesh, {"x": arr})["x"].addressable_shards:
        rows = shard_rows(n, order.index(shard.device), n_dev)
        assert (rows.start, rows.stop) == (shard.index[0].start or 0, shard.index[0].stop or n)
        np.testing.assert_array_equal(arr[rows], np.asarray(shard.data))
    with pytest.raises(ValueError, match="pad"):
        shard_rows(n + 1, 0, n_dev)


@pytest.mark.parametrize("n", [1, 5, 8, 13])
def test_pad_to_multiple_matches_jax(n):
    arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    (got, n_got), (want, n_want) = pad_to_multiple(arr, 8), jmesh.pad_to_multiple(arr, 8)
    assert n_got == n_want == n
    np.testing.assert_array_equal(got, want)


def _jax_picked(params, n_model: int, min_size: int) -> dict:
    """Port name -> the Flax leaf's last-axis size, for every leaf JAX's
    rule shards on ``model``."""
    specs = jtp_param_specs(params, n_model, min_size)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    picked = {}
    for (path, leaf), spec in zip(flat, spec_leaves):
        if "model" in spec:
            keys = [k.key for k in path if k.key != "params"]
            name = ".".join([module_name(k) for k in keys[:-1]]
                            + [_LEAF_NAMES.get(keys[-1], keys[-1])])
            picked[name] = leaf.shape[-1]
    return picked


def _port_picked(module, n_model: int, min_size: int) -> dict:
    params = dict(module.named_parameters())
    return {name: params[name].shape[dim]
            for name, dim in tp_param_specs(module, n_model, min_size).items()
            if dim is not None}


def _unet_trees(jcfg, pcfg, x_hw: int, ctx_len: int):
    """(JAX's parameter shapes, the port's module on the meta device)."""
    args = (jnp.zeros((1, x_hw, x_hw, jcfg.in_channels)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, ctx_len, jcfg.context_dim)))
    shapes = jax.eval_shape(JGDUNet(jcfg).init, jax.random.PRNGKey(0), *args)
    with torch.device("meta"):
        port = GDUNet(pcfg)
    return shapes, port


@pytest.mark.parametrize("n_model,min_size", [(4, 128), (2, 64), (8, 256)])
def test_tp_param_specs_pick_what_jax_picks(n_model, min_size):
    shapes, port = _unet_trees(JGDUNetConfig(**TINY_UNET), GDUNetConfig(**TINY_UNET), 8, 7)
    want = _jax_picked(shapes, n_model, min_size)
    assert want, "the rule must pick some parameters of the tiny UNet"
    assert _port_picked(port, n_model, min_size) == want


def test_tp_param_specs_on_the_sd_v1_unet():
    """SD v1's UNet tree at ``n_model`` 2, ``min_size`` 512: the same 206
    parameters as JAX's rule (the count ``__graft_entry__``'s dry run and
    JAX's SD test read)."""
    shapes, port = _unet_trees(JGDUNetConfig.sd_v1(), GDUNetConfig.sd_v1(), 16, 77)
    want = _jax_picked(shapes, 2, 512)
    assert len(want) >= 200
    assert _port_picked(port, 2, 512) == want


RANK_CODE = """
from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
from cyclediffusion_tpu_torch.models.clip import CLIPConfig
from cyclediffusion_tpu_torch.models.nn import fill_random_
from cyclediffusion_tpu_torch.models.unet_gd import GDUNet, GDUNetConfig
from cyclediffusion_tpu_torch.parallel import all_gather_cat, data_mesh, replicate, shard_batch
from cyclediffusion_tpu_torch.parallel.tp import data_model_mesh, shard_params_tp
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.text import HashTokenizer

prob = torch.load(os.path.join(work, "problem.pt"), weights_only=False)
out = {}
mesh = data_mesh("cpu")
out["shard"] = shard_batch(mesh, {"x": torch.arange(8.0)})["x"]
out["whole"] = all_gather_cat(out["shard"], mesh.get_group("data"))
out["replicated"] = replicate(mesh, torch.full((3,), rank + 1.0))

unet = GDUNet(GDUNetConfig(**prob["unet_cfg"])).eval().requires_grad_(False)
fill_random_(unet, torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
x, ctx = torch.randn((4, 8, 8, 4), generator=g), torch.randn((4, 7, 32), generator=g)
t = torch.tensor([0, 10, 500, 999])
with torch.no_grad():
    out["eps"] = unet(x, t, ctx)
    n_before = sum(p.numel() for p in unet.parameters())
    out["n_sharded"] = shard_params_tp(data_model_mesh(1, 2, "cpu"), unet, min_size=128)
    out["param_share"] = sum(p.numel() for p in unet.parameters()) / n_before
    out["eps_tp"] = unet(x, t, ctx)

core = LatentDiffusionCore(LatentCoreSpec.tiny("clip"), "cpu")
core.load_state_dict(prob["core"])
scorer = CLIPScorer(CLIPConfig(**prob["clip_cfg"]), "cpu")
scorer.model.load_state_dict(prob["scorer"])
pipe = StochasticTextPipeline(core, HashTokenizer(96, 16),
                              DirectionalCLIP(scorer, HashTokenizer(96, 16)), mesh=mesh,
                              **prob["kw"])
z = pipe.encode(prob["image"], prob["src"], vae_noise=prob["vae"], xT_noises=prob["xT"],
                posterior_noises=prob["posts"])
out["z"] = z
out["best"], out["combos"] = pipe.forward(z, prob["image"], prob["src"], prob["tgt"])
fresh = StochasticTextPipeline(core, HashTokenizer(96, 16),
                               DirectionalCLIP(scorer, HashTokenizer(96, 16)), mesh=mesh,
                               **prob["fresh_kw"])
z = fresh.encode(prob["image"], prob["src"], torch.Generator().manual_seed(prob["seeds"][0]))
out["fresh_z"] = z
out["fresh_best"], out["fresh_combos"] = fresh.forward(
    z, prob["image"], prob["src"], prob["tgt"], torch.Generator().manual_seed(prob["seeds"][1]))
torch.save(out, os.path.join(work, f"rank{rank}.pt"))
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(JAX's ensemble on a 2-device mesh, the unsplit port's, each rank's).
    The ranks run while this process computes the other two."""
    work = tmp_path_factory.mktemp("ranks")
    jcore, core = tiny_latent_cores(cond_kind="clip")
    jscorer = JScorer.random_init(jax.random.PRNGKey(1), JCLIPConfig(**CLIP_CFG))
    scorer = CLIPScorer.from_jax_params(jax.tree.map(np.asarray, jscorer.params),
                                        CLIPConfig(**CLIP_CFG), "cpu")
    jtok, tok = JHashTokenizer(96, 16), HashTokenizer(96, 16)
    jpipe = JPipeline(jcore, jtok, JDirectional(jscorer, jtok),
                      mesh=jmesh.data_mesh(jax.devices()[:2]), **PIPE_KW)
    image = np.array(jax.random.uniform(jax.random.PRNGKey(2), (1, 32, 32, 3)))
    vae, xT, posts = _jax_encode_draws(jpipe, jax.random.PRNGKey(3), 1)
    torch.save(dict(core=core.state_dict(), scorer=scorer.model.state_dict(),
                    clip_cfg=CLIP_CFG, unet_cfg=TINY_UNET, kw=PIPE_KW, image=image, src=SRC,
                    tgt=TGT, vae=vae, xT=xT, posts=posts, fresh_kw=FRESH_KW,
                    seeds=(ENC_SEED, DEC_SEED)), work / "problem.pt")
    procs = start_ranks(RANK_CODE, 2, work)
    try:
        jz = jpipe.encode(jnp.asarray(image), SRC, jax.random.PRNGKey(3))
        jbest, jcombos = jpipe.forward(jz, jnp.asarray(image), SRC, TGT, jax.random.PRNGKey(4))
        pipe = StochasticTextPipeline(core, tok, DirectionalCLIP(scorer, tok), **PIPE_KW)
        z = pipe.encode(image, SRC, vae_noise=vae, xT_noises=xT, posterior_noises=posts)
        scores, _ = pipe.rank(pipe.generate(z, TGT), torch.from_numpy(image), SRC, TGT)
        best, combos = pipe.forward(z, image, SRC, TGT)
        fresh = StochasticTextPipeline(core, tok, DirectionalCLIP(scorer, tok), **FRESH_KW)
        fresh_z = fresh.encode(image, SRC, torch.Generator().manual_seed(ENC_SEED))
        fresh_best, fresh_combos = fresh.forward(fresh_z, image, SRC, TGT,
                                                 torch.Generator().manual_seed(DEC_SEED))
    finally:
        wait_ranks(procs, timeout=240)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(jz=jz, jbest=jbest, jcombos=jcombos, z=z, best=best, combos=combos,
                scores=scores, ranks=ranks, fresh_z=fresh_z, fresh_best=fresh_best,
                fresh_combos=fresh_combos)


def test_mesh_helpers_on_two_ranks(two_ranks):
    for rank, out in enumerate(two_ranks["ranks"]):
        torch.testing.assert_close(out["shard"], torch.arange(4.0) + 4 * rank, rtol=0, atol=0)
        torch.testing.assert_close(out["whole"], torch.arange(8.0), rtol=0, atol=0)
        torch.testing.assert_close(out["replicated"], torch.ones(3), rtol=0, atol=0)


def test_tensor_parallel_unet_matches_unsharded(two_ranks):
    for out in two_ranks["ranks"]:
        assert out["n_sharded"] > 0 and out["param_share"] < 0.75
        torch.testing.assert_close(out["eps_tp"], out["eps"], rtol=TP_RTOL, atol=TP_ATOL)


def _close(a, b, tol: float) -> None:
    """JAX's form: |a - b| <= tol + tol * |b| (eps entries reach ~40)."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_candidate_split_matches_unsplit_and_jax(two_ranks):
    r = two_ranks
    assert len(r["z"]) == len(r["jz"]) == 6           # 3 trials x 2 skips
    for out in r["ranks"]:
        assert len(out["z"]) == 6
        for a, b, jb in zip(out["z"], r["z"], r["jz"]):
            _close(a, b, SPLIT_TOL)
            _close(a, jb, JAX_TOL)
        _close(out["best"], r["best"], SPLIT_TOL)
        assert out["combos"] == r["combos"]
    a, b = r["ranks"]
    assert all(torch.equal(x, y) for x, y in zip(a["z"], b["z"]))
    assert torch.equal(a["best"], b["best"]) and a["combos"] == b["combos"]
    # JAX's winner, where the port's scores leave a clear gap under the best
    top2 = np.sort(r["scores"][0].numpy())[-2:]
    if top2[1] - top2[0] > JAX_TOL:
        assert r["combos"] == list(r["jcombos"])
        _close(r["best"], r["jbest"], JAX_TOL)


def test_candidate_split_draws_the_unsplit_noise(two_ranks):
    """Encode and decode on seeded generators, decoding past the stored eps:
    both ranks give the unsplit run's z, best image and combos."""
    r = two_ranks
    assert FRESH_KW["white_box_steps"] < FRESH_KW["custom_steps"] + 1
    for out in r["ranks"]:
        assert len(out["fresh_z"]) == len(r["fresh_z"]) == 6
        for a, b in zip(out["fresh_z"], r["fresh_z"]):
            _close(a, b, SPLIT_TOL)
        _close(out["fresh_best"], r["fresh_best"], SPLIT_TOL)
        assert out["fresh_combos"] == r["fresh_combos"]
