"""``chip_smoke.py`` on a machine without a GPU: it imports nothing of JAX
or of the JAX package, and it refuses to run — exit code non-zero and no
result line — both in a checkout and when it stands alone in a directory."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(SMOKE).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "cyclediffusion_tpu_torch" in roots
    assert not roots & {"jax", "flax", "cyclediffusion_tpu"}, roots


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        shutil.copy(SMOKE, script)
    else:
        script = SMOKE
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(script)], cwd=os.path.dirname(script),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "FAIL" in proc.stdout


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("name,shape,gflop,mb", [
    ("flash_attention_bhtd", (4, 8, 1024, 1024, 80), 10.7, 21.0),
    ("flash_attention_packed", (4, 4096, 4096, 8, 40), 85.9, 41.9),
    ("qout_self_attention_block", (4, 4096, 4096, 320, 8), 92.6, 42.35),
    ("fused_self_attention_block", (4, 4096, 320, 8), 99.3, 21.8),
])
def test_kernel_work_and_bounds_at_the_main_path_shapes(smoke, name, shape, gflop, mb):
    """Each kernel's matrix-product work and compulsory traffic at the
    main-path shapes; all four are bound by operations on the H100."""
    flops, nbytes = smoke.work(name, shape, "bf16")
    assert abs(flops / 1e9 - gflop) < 0.05 and abs(nbytes / 1e6 - mb) < 0.05
    ms, by = smoke.bound_of(name, shape, "bf16")
    assert by == "operations" and ms == pytest.approx(1e3 * flops / 989e12)


@pytest.mark.parametrize("backward,bound_ms", [(False, 0.0401), (True, 0.0601)])
def test_group_norm_bound_counts_each_byte_once(smoke, backward, bound_ms):
    """Phase 3b's GroupNorm bound at the KL-f8 decoder's 512 px level in
    bf16: x read and y written once (67.1 MB each), the backward's dy read
    too, at 3.35 TB/s."""
    assert smoke.group_norm_bound_ms((1, 128, 512, 512), backward) == pytest.approx(
        bound_ms, abs=5e-5)
    assert [shape for _, shape in smoke.GN_CASES] == [(1, 128, 512, 512), (8, 320, 64, 64)]


@pytest.mark.parametrize("shape,gflop,mb,bound_ms", [
    ((16384, 320, 320, True), 3.355, 21.18, 0.0063),    # q, with the bias of the output
    ((16384, 960, 320, False), 10.07, 42.56, 0.0127),   # K4's [q | k | v]
])
def test_projection_work_and_bound_at_the_main_path_shapes(smoke, shape, gflop, mb, bound_ms):
    """K3/K4's projection kernel, (M, N, K, bias) at the main path: 2*M*N*K
    operations against X, W (and b) read and Y written once; bound by the
    bytes on the H100."""
    flops, nbytes = smoke.work("linear", shape, "bf16")
    assert abs(flops / 1e9 - gflop) < 0.005 and abs(nbytes / 1e6 - mb) < 0.005
    ms, by = smoke.bound_of("linear", shape, "bf16")
    assert by == "bytes" and ms == pytest.approx(bound_ms, abs=5e-5)
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)


@pytest.mark.parametrize("name,shape,exps_m,floor_ms", [
    ("flash_attention_packed", (4, 4096, 4096, 8, 40), 536.9, 0.1377),
    ("flash_attention_bhtd", (4, 8, 1024, 1024, 80), 33.55, 0.0086),
])
def test_exp_floor_at_the_main_path_shapes(smoke, name, shape, exps_m, floor_ms):
    """K1/K2's exponentials, one per logit (B*H*Tq*Tk), at 3.9e12 per
    second: for K2 (d = 40) a floor above its matrix-product bound, for K1
    (d = 80) below it."""
    b, h, tq, tk = ((shape[0], shape[3], shape[1], shape[2]) if name == "flash_attention_packed"
                    else shape[:4])
    assert abs(b * h * tq * tk / 1e6 - exps_m) < 0.05
    floor = smoke.exp_floor_ms(name, shape)
    assert floor == pytest.approx(floor_ms, abs=5e-5)
    bound_ms, _ = smoke.bound_of(name, shape, "bf16")
    assert (floor > bound_ms) == (name == "flash_attention_packed")


@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_expected_unet_calls_counts_the_chains(smoke, chunk):
    """The smoke's expected UNet call count equals what encode + generate
    run on the tiny pipeline (2 trials x skips [0, 2] x 2 decoder scales)."""
    import torch
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
    from cyclediffusion_tpu_torch.samplers import num_recovered_eps
    from cyclediffusion_tpu_torch.text import HashTokenizer

    core = LatentDiffusionCore.random_init(LatentCoreSpec.tiny(), device="cpu")
    pipe = StochasticTextPipeline(
        core, HashTokenizer(96, 16), custom_steps=4, eta=0.1, white_box_steps=4,
        skip_steps=[0, 2], encoder_unconditional_guidance_scales=[1],
        decoder_unconditional_guidance_scales=[1, 3], n_trials=2, candidate_chunk=chunk)
    calls = [0]
    apply_model = core.apply_model

    def counted(*a):
        calls[0] += 1
        return apply_model(*a)

    core.apply_model = counted
    gen = torch.Generator().manual_seed(0)
    z = pipe.encode(torch.rand(1, 32, 32, 3), ["a cat"], gen)
    pipe.generate(z, ["a dog"], gen)
    assert calls[0] == smoke.expected_unet_calls(pipe, num_recovered_eps)


def test_cut_config_sets_the_cuts_and_keeps_the_rest(smoke, tmp_path):
    """Phase 7's config: the shipped SD experiment with ``CLI_CUTS`` applied,
    read back through the port's config reader."""
    from cyclediffusion_tpu_torch.runtime.config import config_root, get_config

    with open(os.path.join(config_root(), smoke.CLI_CFG)) as f:
        text = f.read()
    path = tmp_path / "cut.cfg"
    path.write_text(smoke.cut_config(text, smoke.CLI_CUTS))
    cut, full = get_config(str(path)), get_config(smoke.CLI_CFG)
    assert (cut.gan.custom_steps, cut.gan.white_box_steps, cut.gan.eta) == (50, 51, 0.1)
    assert cut.gan.skip_steps == [25] and cut.gan.n_trials == 1 and cut.gan.candidate_chunk == 4
    assert cut.gan.decoder_unconditional_guidance_scales == [1, 5]
    assert cut.raw_data.range == [4, 6]
    kept = {k: v for k, v in full.to_dict().items() if k not in ("gan", "raw_data")}
    assert {k: v for k, v in cut.to_dict().items() if k not in ("gan", "raw_data")} == kept
    assert cut.gan.source_model_type == "sd-v1-4.ckpt"
    with pytest.raises(ValueError, match="not in the config"):
        smoke.cut_config(text, {("gan", "no_such_key"): "1"})


def test_expected_cli_files_are_what_the_cli_writes(smoke, tmp_path):
    """The file list phase 7 checks equals what a tiny CLI run on the CPU
    writes (2 samples)."""
    from cyclediffusion_tpu_torch import main as cli
    from cyclediffusion_tpu_torch.runtime import context

    context.reset()
    out = str(tmp_path / "out")
    cli.main(["--cfg", "experiments/tiny_text_translation.cfg", "--output_dir", out,
              "--do_eval", "--per_device_eval_batch_size", "2"], device="cpu")
    context.reset()
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert files == sorted(smoke.expected_cli_files(2))


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("key_every", [None, 2, 3])
def test_expected_calls_by_kind_counts_key_and_reuse_calls(smoke, key_every, chunk):
    """Phase 8's expected UNet calls by kind equal what encode + generate
    run on the tiny pipeline: exact calls, or with ``fast_key_every`` the
    key calls (every k-th step of each chain, its first included) and the
    reuse calls."""
    import torch
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
    from cyclediffusion_tpu_torch.samplers import num_recovered_eps
    from cyclediffusion_tpu_torch.text import HashTokenizer

    core = LatentDiffusionCore.random_init(LatentCoreSpec.tiny(), device="cpu")
    pipe = StochasticTextPipeline(
        core, HashTokenizer(96, 16), custom_steps=5, eta=0.1, white_box_steps=5,
        skip_steps=[0, 2], encoder_unconditional_guidance_scales=[1],
        decoder_unconditional_guidance_scales=[1, 3], n_trials=2, candidate_chunk=chunk,
        fast_key_every=key_every)
    calls = {"full": 0, "key": 0, "reuse": 0}
    apply_model, apply_model_cached = core.apply_model, core.apply_model_cached

    def counted(*a):
        calls["full"] += 1
        return apply_model(*a)

    def counted_cached(x, t, c, encoder_cache=None):
        calls["key" if encoder_cache is None else "reuse"] += 1
        return apply_model_cached(x, t, c, encoder_cache)

    core.apply_model, core.apply_model_cached = counted, counted_cached
    gen = torch.Generator().manual_seed(0)
    z = pipe.encode(torch.rand(1, 32, 32, 3), ["a cat"], gen)
    pipe.generate(z, ["a dog"], gen)
    assert calls == smoke.expected_calls_by_kind(pipe, num_recovered_eps)
    assert sum(calls.values()) == smoke.expected_unet_calls(pipe, num_recovered_eps)
    assert (calls["full"] > 0) == (key_every is None) and (calls["reuse"] > 0) != (
        key_every is None)


@pytest.mark.parametrize("name,full,reuse", [
    ("sd_v1", (5, 5), (3, 3)),
    ("ldm_text2img_large", (5, 0), (3, 0)),
])
def test_launches_per_call_at_the_published_widths(smoke, name, full, reuse):
    """K1/K2 launches per UNet call by kind: SD v1's 64x64 level (4096
    tokens, K2) and 32x32 level (1024, K1), 5 transformers each of which the
    decoder half holds 3; LDM text2img-large's 32x32 latent puts its 1024
    tokens at ds 1 through K1 and nothing through K2."""
    from cyclediffusion_tpu_torch.ops.flash_attention import attention_route
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec

    spec = getattr(LatentCoreSpec, name)()
    for want, is_reuse in ((full, False), (reuse, True)):
        got = smoke.launches_per_call(spec, attention_route, reuse=is_reuse)
        assert (got["flash_attention_bhtd"], got["flash_attention_packed"]) == want


@pytest.mark.parametrize("reuse", [False, True])
def test_launches_per_call_counts_the_unets_self_attention(smoke, reuse, monkeypatch):
    """The helper's count equals the routed self-attention calls of a real
    (tiny) UNet call, full or on a cache, under a route that sends each of
    the tiny UNet's self-attention token counts (64 at ds 1, 16 at ds 2) to
    a kernel."""
    import torch
    from cyclediffusion_tpu_torch.ops import flash_attention as fa
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore

    def route(tq, tk):
        return {64: "packed", 16: "bhtd"}.get(tq, "plain") if tq == tk else "plain"

    spec = LatentCoreSpec.tiny()
    core = LatentDiffusionCore.random_init(spec, device="cpu")
    # a 12-token context: no cross-attention has as many keys as queries
    x, ctx = torch.randn(2, 8, 8, 4), torch.randn(2, 12, 24)
    t = torch.tensor([3, 4])
    _, cache = core.apply_model_cached(x, t, ctx)
    seen = {"flash_attention_bhtd": 0, "flash_attention_packed": 0}

    def recording(tq, tk):
        r = route(tq, tk)
        if r != "plain":
            seen[smoke.ROUTE_KERNELS[r]] += 1
        return r

    monkeypatch.setattr(fa, "attention_route", recording)
    core.apply_model_cached(x, t, ctx, cache if reuse else None)
    assert seen == smoke.launches_per_call(spec, route, reuse=reuse)
    assert seen["flash_attention_packed"] and seen["flash_attention_bhtd"]


@pytest.mark.parametrize("cfg_name,model_type,fast", [
    ("FAST_CLI_CFG", "sd-v1-4.ckpt", 2),
    ("LDM_CLI_CFG", "text2img-large", None),
])
def test_cut_configs_of_the_fast_and_ldm_phases(smoke, tmp_path, cfg_name, model_type, fast):
    """Phases 8 and 9 cut the shipped fast-mode SD and LDM text2img-large
    experiments with phase 7's ``CLI_CUTS``; the model, the fast mode and
    the task stay as shipped."""
    from cyclediffusion_tpu_torch.runtime.config import config_root, get_config

    name = getattr(smoke, cfg_name)
    with open(os.path.join(config_root(), name)) as f:
        text = f.read()
    path = tmp_path / "cut.cfg"
    path.write_text(smoke.cut_config(text, smoke.CLI_CUTS))
    cut, full = get_config(str(path)), get_config(name)
    assert (cut.gan.custom_steps, cut.gan.white_box_steps, cut.gan.skip_steps) == (50, 51, [25])
    assert cut.gan.decoder_unconditional_guidance_scales == [1, 5]
    assert cut.raw_data.range == [4, 6] and cut.gan.candidate_chunk == 4
    assert cut.gan.source_model_type == model_type
    assert getattr(cut.gan, "fast_key_every", None) == fast
    assert cut.arg_paths.to_dict() == full.arg_paths.to_dict()


def test_unpaired_cut_config_and_expected_counts(smoke, tmp_path):
    """Phase 10's config: the shipped FFHQ -> CelebA-HQ experiment with
    ``UNPAIRED_CUTS`` (100 steps, white_box_steps 101, refine 40, eta 0.1),
    the models and the task as shipped; 100 + 100 + 40 = 240 UNet calls per
    batch, 5 K1 launches per call at the published widths, 1,200 in all."""
    from cyclediffusion_tpu_torch.ops.flash_attention import attention_route
    from cyclediffusion_tpu_torch.pipelines.latent import (
        LatentCoreSpec,
        LatentDiffStochasticPipeline,
        LatentDiffusionCore,
    )
    from cyclediffusion_tpu_torch.runtime.config import config_root, get_config
    from cyclediffusion_tpu_torch.samplers import num_recovered_eps

    with open(os.path.join(config_root(), smoke.UNPAIRED_CFG)) as f:
        text = f.read()
    path = tmp_path / "cut.cfg"
    path.write_text(smoke.cut_config(text, smoke.UNPAIRED_CUTS))
    cut, full = get_config(str(path)), get_config(smoke.UNPAIRED_CFG)
    g = cut.gan
    assert (g.custom_steps, g.white_box_steps, g.refine_steps, g.eta) == (100, 101, 40, 0.1)
    assert (g.source_model_type, g.target_model_type) == ("ffhq256", "celeba256")
    assert set(smoke.UNPAIRED_MODELS) == {g.source_model_type, g.target_model_type}
    kept = {k: v for k, v in full.to_dict().items() if k != "gan"}
    assert {k: v for k, v in cut.to_dict().items() if k != "gan"} == kept
    spec = LatentCoreSpec.ldm_ffhq256()
    core = LatentDiffusionCore(dataclasses.replace(LatentCoreSpec.tiny(None, 16, "vq"),
                                                   num_timesteps=1000), device="cpu")
    pipe = LatentDiffStochasticPipeline(core, custom_steps=100, eta=0.1,
                                        white_box_steps=101, refine_steps=40)
    calls = smoke.unpaired_unet_calls(pipe, num_recovered_eps)
    assert calls == {"source": 100, "target": 140}
    per_call = smoke.launches_per_call(spec, attention_route)
    assert per_call == {"flash_attention_bhtd": 5, "flash_attention_packed": 0}
    assert sum(calls.values()) * per_call["flash_attention_bhtd"] == 1200
    assert smoke.launches_per_call(spec, attention_route, reuse=True)[
        "flash_attention_bhtd"] == 3


def test_unpaired_calls_are_what_the_task_model_runs(smoke):
    """``unpaired_unet_calls`` equals the UNet calls that the task model's
    forward makes on the tiny unpaired config, per model, at the batch."""
    import numpy as np
    from cyclediffusion_tpu_torch.runtime.config import get_config
    from cyclediffusion_tpu_torch.samplers import num_recovered_eps
    from cyclediffusion_tpu_torch.tasks.unsupervised_translation import (
        UnsupervisedTranslation,
    )

    model = UnsupervisedTranslation(get_config("experiments/tiny_unpaired_latent.cfg"),
                                    device="cpu")
    calls, batches = [], set()
    for pipe in (model.source_gan_wrapper, model.target_gan_wrapper):
        apply_model, i = pipe.core.apply_model, len(calls)
        calls.append(0)

        def counted(x, *a, i=i, apply_model=apply_model):
            calls[i] += 1
            batches.add(x.shape[0])
            return apply_model(x, *a)
        pipe.core.apply_model = counted
    images = [np.full((16, 16, 3), v, np.float32) for v in (0.2, 0.5, 0.9)]
    model.forward(np.array([0, 1, 2]), original_image=images)
    want = smoke.unpaired_unet_calls(model.target_gan_wrapper, num_recovered_eps)
    assert dict(zip(("source", "target"), calls)) == want == {"source": 8, "target": 11}
    assert batches == {3}


@pytest.mark.parametrize("reuse", [False, True])
def test_launches_per_call_counts_the_attention_blocks(smoke, reuse, monkeypatch):
    """The unconditional UNet's attention blocks count one launch each: the
    helper's count equals the routed attention calls of a tiny unconditional
    UNet call (16 tokens at ds 1 to K2, 4 at ds 2 to K1 under a test route)."""
    import torch
    from cyclediffusion_tpu_torch.ops import flash_attention as fa
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore

    def route(tq, tk):
        return {16: "packed", 4: "bhtd"}.get(tq, "plain")

    spec = LatentCoreSpec.tiny(None, 16, "vq")
    core = LatentDiffusionCore.random_init(spec, device="cpu")
    x, t = torch.randn(2, 4, 4, 4), torch.tensor([3, 4])
    _, cache = core.apply_model_cached(x, t)
    seen = {"flash_attention_bhtd": 0, "flash_attention_packed": 0}

    def recording(tq, tk):
        r = route(tq, tk)
        if r != "plain":
            seen[smoke.ROUTE_KERNELS[r]] += 1
        return r

    monkeypatch.setattr(fa, "attention_route", recording)
    core.apply_model_cached(x, t, None, cache if reuse else None)
    assert seen == smoke.launches_per_call(spec, route, reuse=reuse)
    assert seen["flash_attention_packed"] and seen["flash_attention_bhtd"]


@pytest.mark.parametrize("shape,gflop,bound_ms,floor_ms", [
    ((3, 14, 1024, 1024, 32), 5.637, 0.0057, 0.0113),
])
def test_k1_work_and_bounds_at_the_ffhq_level(smoke, shape, gflop, bound_ms, floor_ms):
    """K1 at the FFHQ/CelebA LDM's ds-2 level, batch 3: 5.6 GFLOP, bound by
    operations at ~0.0057 ms on the H100; its exponentials take ~0.011 ms,
    twice that."""
    flops, _ = smoke.work("flash_attention_bhtd", shape, "bf16")
    assert abs(flops / 1e9 - gflop) < 0.005
    ms, by = smoke.bound_of("flash_attention_bhtd", shape, "bf16")
    assert by == "operations" and ms == pytest.approx(bound_ms, abs=5e-5)
    assert smoke.exp_floor_ms("flash_attention_bhtd", shape) == pytest.approx(floor_ms,
                                                                              abs=5e-5)


def test_cut_config_adds_keys_to_their_section(smoke):
    text = "[a]\nx = 1\n\n[b]\ny = 2\n"
    assert smoke.cut_config(text, {("a", "x"): "3"}, {("a", "z"): "4"}) == (
        "[a]\nx = 3\n\nz = 4\n[b]\ny = 2\n")
    assert smoke.cut_config(text, {}, {("b", "z"): "5"}).endswith("y = 2\nz = 5\n")
    with pytest.raises(ValueError):
        smoke.cut_config(text, {}, {("a", "x"): "5"})        # present already
    with pytest.raises(ValueError):
        smoke.cut_config(text, {}, {("c", "x"): "5"})        # no such section


def test_afhq_cut_config_and_expected_counts(smoke, tmp_path):
    """Phase 11's config: the shipped AFHQ cat -> dog experiment with
    ``AFHQ_CUTS`` (100 encode steps of the 1000-step grid, refine 20) and
    ``eval_num`` 2 added, the rest as shipped; 99 source + 120 target UNet
    calls per batch; the full-width UNet's operations at batch 2."""
    from cyclediffusion_tpu_torch.pipelines import zoo
    from cyclediffusion_tpu_torch.pipelines.ddpm_ddim import DDPMDDIMPipeline
    from cyclediffusion_tpu_torch.runtime.config import config_root, get_config

    with open(os.path.join(config_root(), smoke.AFHQ_CFG)) as f:
        text = f.read()
    path = tmp_path / "cut.cfg"
    path.write_text(smoke.cut_config(text, smoke.AFHQ_CUTS, smoke.AFHQ_ADDS))
    cut, full = get_config(str(path)), get_config(smoke.AFHQ_CFG)
    g = cut.gan
    assert (g.es_steps, g.refine_steps, g.custom_steps, g.eta, g.sample_type) == (
        100, 20, 1000, 0.1, "ddim")
    assert cut.raw_data.eval_num == smoke.AFHQ_SAMPLES == 2 < smoke.AFHQ_CATS
    assert {k: v for k, v in cut.to_dict().items() if k not in ("gan", "raw_data")} == {
        k: v for k, v in full.to_dict().items() if k not in ("gan", "raw_data")}
    assert set(smoke.AFHQ_MODELS) == {"source_model_path", "target_model_path"}
    spec = dataclasses.replace(zoo.tiny_pixel_spec(16), num_diffusion_timesteps=1000)
    pipe = DDPMDDIMPipeline.random_init(spec, 0, device="cpu", custom_steps=1000,
                                        es_steps=100, eta=0.1, refine_steps=20)
    assert smoke.pixel_unet_calls(pipe) == {"source": 99, "target": 120}
    import torch
    from cyclediffusion_tpu_torch.tools.pixel_probe import unet_flops
    with torch.device("meta"):
        afhq = zoo.build_pixel_model(zoo.PIXEL_ZOO["afhqdog256"])
    assert unet_flops(afhq, 2) == 775_868_383_232


def test_pixel_calls_and_round_trip_on_the_tiny_config(smoke):
    """``pixel_unet_calls`` equals the UNet calls that the task model makes
    on the tiny pixel config, per pipeline, at the batch; the round-trip
    helper on the tiny pipeline reads the replay on the encode chain's
    states to roundoff."""
    import numpy as np
    import torch
    from cyclediffusion_tpu_torch.runtime.config import get_config
    from cyclediffusion_tpu_torch.tasks.unsupervised_translation import (
        UnsupervisedTranslation,
    )

    model = UnsupervisedTranslation(get_config("experiments/tiny_unpaired_translation.cfg"),
                                    device="cpu")
    calls, batches = [], set()
    for pipe in (model.source_gan_wrapper, model.target_gan_wrapper):
        model_fn, i = pipe._model_fn, len(calls)
        calls.append(0)

        def counted(x, t, i=i, model_fn=model_fn):
            calls[i] += 1
            batches.add(x.shape[0])
            return model_fn(x, t)
        pipe._model_fn = counted
    images = [np.full((16, 16, 3), v, np.float32) for v in (0.2, 0.5, 0.9)]
    model.forward(np.array([0, 1, 2]), original_image=images)
    want = smoke.pixel_unet_calls(model.target_gan_wrapper)
    assert dict(zip(("source", "target"), calls)) == want == {"source": 19, "target": 24}
    assert batches == {3}
    pipe = model.source_gan_wrapper
    del pipe._model_fn
    pipe.refine_steps = 0
    traj, x0_err = smoke.pixel_round_trip(torch, pipe, torch.rand(2, 16, 16, 3),
                                          torch.Generator().manual_seed(0))
    assert traj < 1e-5 and 1e-4 < x0_err < 0.1
    assert "_model_fn" not in vars(pipe)


def test_afhq_cli_files_are_what_translate_to_dog_writes(smoke, tmp_path, monkeypatch):
    """``expected_cli_files(n, csv=False)`` is what the CLI writes with the
    AFHQ task evaluator (``translate_to_dog``; no dog set here, so no FID):
    the sample PNGs and no CSV."""
    from cyclediffusion_tpu_torch import main as cli
    from cyclediffusion_tpu_torch.runtime.config import config_root

    task = tmp_path / "task.cfg"
    with open(os.path.join(config_root(), "tasks", "tiny_cat_dog.cfg")) as f:
        task.write_text(f.read().replace("evaluator_program = empty",
                                         "evaluator_program = translate_to_dog"))
    with open(os.path.join(config_root(), "experiments", "tiny_unpaired_translation.cfg")) as f:
        text = smoke.cut_config(f.read(), {("arg_paths", "translate"): str(task)})
    cfg = tmp_path / "exp.cfg"
    cfg.write_text(text)
    monkeypatch.setenv("CYCLEDIFFUSION_DATA_ROOT", str(tmp_path))
    out = tmp_path / "out"
    cli.main(["--cfg", str(cfg), "--output_dir", str(out), "--do_eval",
              "--per_device_eval_batch_size", "2"], device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
                   for f in fs)
    assert files == smoke.expected_cli_files(2, csv=False)
    assert "temp_gen/1.png" in files and "eval_results.csv" not in files


@pytest.mark.parametrize("name,calls,want", [
    ("sd_v1", 50, (250, 250)),              # the guided chain: 5 + 5 per call
    ("ldm_ffhq256", 100, (500, 0)),         # the plain pipeline: 50 + 50 calls, K1 at d = 32
])
def test_guided_phase_expected_launches(smoke, name, calls, want):
    """Phase 12's launch counts: every UNet call's K1/K2 launches, none
    elsewhere (the energy's decoder attention and the ViT run plain)."""
    from cyclediffusion_tpu_torch.ops.flash_attention import attention_route
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec

    got = smoke.guided_launches(getattr(LatentCoreSpec, name)(), attention_route, calls)
    assert (got["flash_attention_bhtd"], got["flash_attention_packed"]) == want
    assert smoke.STEPS == 50 and 2 * smoke.STEPS == 100


def test_guided_chain_makes_one_unet_call_per_step(smoke):
    """The tiny guided chain calls its eps model once per step, as phase 12
    counts it, and its energy sees pred_x0 at batch 1."""
    import torch
    from cyclediffusion_tpu_torch.models.clip import CLIPConfig
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec
    from cyclediffusion_tpu_torch.tools import guided_probe

    clip = CLIPConfig(embed_dim=16, image_resolution=16, vision_width=32, vision_layers=1,
                      vision_heads=2, patch_size=8, vocab_size=96, context_length=16,
                      text_width=32, text_layers=1, text_heads=2)
    g = guided_probe.build(LatentCoreSpec.tiny("clip"), clip, steps=4, device="cpu",
                           dtype=torch.float32)
    calls, shapes = [0], []
    model_fn, energy_fn = g.model_fn, g.energy_fn

    def counted(x, t):
        calls[0] += 1
        return model_fn(x, t)

    def seen(x, p, t):
        shapes.append(tuple(p.shape))
        return energy_fn(x, p, t)

    g.model_fn, g.energy_fn = counted, seen
    g.guided(smoke.GUIDED_WEIGHT)
    assert calls[0] == 4 and shapes == [(1, 8, 8, 4)] * 4


@pytest.mark.parametrize("h", [1e-1, 1e-2])
def test_directional_check_on_a_toy_function(smoke, h):
    """The central difference of a smooth toy energy matches its gradient
    along a unit direction (the gap shrinks as h^2), and a gradient off by
    5% shows as a 5% gap."""
    import torch

    gen = torch.Generator().manual_seed(0)
    p = torch.randn(2, 4, 4, 3, generator=gen, dtype=torch.float64)   # no rounding noise
    v = torch.randn(p.shape, generator=gen, dtype=torch.float64)
    v = v / v.norm()
    energy = lambda q: torch.sin(q).sum() + 0.5 * (q ** 2).sum()
    grad = torch.cos(p) + p
    gv, fd, rel = smoke.directional_check(energy, grad, p, v, h)
    assert gv == pytest.approx(float((grad * v).sum()))
    assert rel < h ** 2 and rel <= smoke.FD_REL_BOUND
    _, _, off = smoke.directional_check(energy, 1.05 * grad, p, v, h)
    assert off == pytest.approx(0.05 / 1.05, rel=0.05)
    assert smoke.directional_check(lambda q: q.sum() * 0, torch.zeros(3), torch.zeros(3),
                                   torch.ones(3), h)[2] == 0.0      # no division by zero


def test_plain_group_norm_swaps_the_models_group_norm_for_the_block(smoke):
    """Inside ``plain_group_norm()`` the models' GroupNorm is the plain
    version; after it, the kernels' wrapper again, also when the block raises."""
    from cyclediffusion_tpu_torch.models import nn as tnn
    from cyclediffusion_tpu_torch.ops import group_norm as gn

    with smoke.plain_group_norm():
        assert tnn.group_norm is gn.group_norm_reference
    assert tnn.group_norm is gn.group_norm
    with pytest.raises(KeyError), smoke.plain_group_norm():
        raise KeyError
    assert tnn.group_norm is gn.group_norm


def test_launched_reads_the_one_launch_count_dict(smoke, monkeypatch):
    """``launched()`` gives K1-K4's counts by default and the GroupNorm
    kernels' when asked; ``reset_launches()`` zeroes them all."""
    from cyclediffusion_tpu_torch.ops import launches

    monkeypatch.setattr(launches, "counts", dict.fromkeys(launches.counts, 3))
    assert smoke.launched() == dict.fromkeys(smoke.ATTENTION_KERNELS, 3)
    assert smoke.launched(smoke.GROUP_NORM_KERNELS) == {"group_norm": 3,
                                                       "group_norm_backward": 3}
    smoke.reset_launches()
    assert set(launches.counts.values()) == {0}
    assert set(launches.counts) == set(smoke.ATTENTION_KERNELS + smoke.GROUP_NORM_KERNELS)


def test_afhq_cats_are_the_jpeg_fixtures(smoke, tmp_path, monkeypatch):
    """Phase 11's cats: the committed JPEG fixtures copied into the
    stargan-v2 layout, read by the port's AFHQ preprocessor as the CLI
    reads them, equal the fixtures' stored Pillow decode resized (the
    phase's gate), and the JAX package's reading of the same files to one
    level; the dogs are PNGs."""
    import numpy as np
    import torch

    from cyclediffusion_tpu.data.transforms import pil_loader, resize as jresize, to_array
    from cyclediffusion_tpu_torch.data.preprocess.afhqcat256 import load_afhq
    from cyclediffusion_tpu_torch.data.transforms import list_image_files_recursively

    smoke.write_afhq_images(torch, str(tmp_path))
    cats = list_image_files_recursively(str(tmp_path / "stargan-v2" / "data" / "test" / "cat"))
    dogs = list_image_files_recursively(str(tmp_path / "stargan-v2" / "data" / "test" / "dog"))
    assert [os.path.splitext(c)[1] for c in cats] == [".jpg"] * smoke.AFHQ_CATS
    assert [os.path.splitext(d)[1] for d in dogs] == [".png"] * smoke.AFHQ_DOGS
    got = np.stack([load_afhq(c) for c in cats])
    np.testing.assert_array_equal(got, smoke.expected_afhq_sources(smoke.AFHQ_CATS))
    want = np.stack([to_array(jresize(pil_loader(c), 256, "bilinear")) for c in cats])
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-7


def test_phase13_checks_pass_on_the_cpu(smoke, tmp_path):
    """Phase 13's checks run here at small sizes with the CPU on both
    sides: the JPEG fixtures decode to Pillow's stored decode, the
    device-transform and LPIPS comparisons run every method and gate, and
    the YAML loaders equal the presets.  The phase's SD YAML reads as
    ``yaml.safe_load`` reads it and as the JAX package's ``from_yaml``."""
    import dataclasses

    import torch
    import yaml

    from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec
    from cyclediffusion_tpu_torch.runtime import yaml_subset

    differ, ms, pillow = smoke.check_jpeg_fixtures(reps=1)
    assert len(differ) == 7 and not any(differ.values()) and pillow
    assert len(ms) == len(smoke.AFHQ_CAT_JPEGS)
    errs = smoke.check_device_transforms(torch, "cpu", cases=((48, 24), (24, 48)), batch=2)
    assert set(m for _, _, m in errs) == set(smoke.DT_METHODS) and max(errs.values()) == 0
    rel, same, small, large, _ = smoke.check_lpips(torch, "cpu", pairs=2, size=32)
    assert rel == 0 and not bool(same.any()) and bool((small < large).all())
    assert smoke.check_yaml_specs(str(tmp_path)) == []
    for text in (smoke.SD_V1_YAML, smoke.AFHQ_YML):
        assert repr(yaml_subset.safe_load(text)) == repr(yaml.safe_load(text))
    path = tmp_path / "v1-inference.yaml"
    path.write_text(smoke.SD_V1_YAML)
    spec, jspec = LatentCoreSpec.from_yaml(str(path)), JSpec.from_yaml(str(path))
    assert dataclasses.asdict(spec.unet) == {k: v for k, v in dataclasses.asdict(jspec.unet)
                                             .items() if k in dataclasses.asdict(spec.unet)}
    assert (spec.resolution, spec.scale_factor, spec.cond_kind) == (
        jspec.resolution, jspec.scale_factor, jspec.cond_kind)


def test_phase_14_cuts_three_images(smoke):
    """Phase 14 runs phase 7's cuts on 3 images (``range [4, 7]``), so that
    two processes get ragged shards."""
    from cyclediffusion_tpu_torch.runtime.config import config_root

    with open(os.path.join(config_root(), smoke.CLI_CFG)) as f:
        text = smoke.cut_config(f.read(), smoke.PAR_CUTS)
    assert "range = [4, 7]" in text and "candidate_chunk = 4" in text
    assert smoke.PAR_SAMPLES == 3


def test_phase_14_children_refuse_without_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, SMOKE, "--child", "nccl", "0", "1",
                           "file://" + str(tmp_path / "init"), str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "FAIL" in proc.stdout
    assert '"ok"' not in proc.stdout and not list(tmp_path.glob("*.json"))


def test_phase_15_fixture_checks_pass_on_the_cpu(smoke):
    """Phase 15 (a) here: every image fixture decodes to Pillow's stored
    decode, and each timed kind names a 512 px fixture."""
    import numpy as np

    differ, ms, pillow = smoke.check_image_fixtures(reps=1)
    assert len(differ) >= 40 and not any(differ.values()) and pillow
    assert set(ms) == set(smoke.IMAGE_TIMED) and all(len(t) == 1 for t in ms.values())
    stored = np.load(os.path.join(REPO, smoke.IMAGE_DIR, "pillow_rgb.npz"))
    assert all(stored[name].shape == (512, 512, 3) for name in smoke.IMAGE_TIMED.values())
    assert {os.path.splitext(f)[1] for f in smoke.INPUT_FILES} == {".png", ".gif", ".jpg"}
    decode_ms, smooth_ms = smoke.smoothing_share(reps=2)
    assert len(decode_ms) == len(smooth_ms) == 2
    assert all(0 < s < d for s, d in zip(smooth_ms, decode_ms))


def test_phase_15_inputs_are_what_the_preprocessor_gives(smoke, tmp_path, monkeypatch):
    """Phase 15 (b)'s data root, read by the SD task's preprocessor with the
    phase's cut config: one item per input file, each ``original_image``
    bit for bit the phase's expectation from the stored decode."""
    import numpy as np

    from cyclediffusion_tpu_torch.runtime.config import Args, config_root, get_config
    from cyclediffusion_tpu_torch.runtime.registry import get_preprocessor

    with open(os.path.join(config_root(), smoke.CLI_CFG)) as f:
        text = smoke.cut_config(f.read(), smoke.INPUT_CUTS)
    assert f"range = [0, {len(smoke.INPUT_FILES)}]" in text
    monkeypatch.setenv("CYCLEDIFFUSION_DATA_ROOT", smoke.write_input_root(str(tmp_path)))
    task = get_config("tasks/translate_text512.cfg")
    meta = Args(raw_data=Args(range=[0, len(smoke.INPUT_FILES)], upsample_temp=1))
    pre = get_preprocessor(task.preprocess.preprocess_program)(task, meta)
    dev = pre.preprocess({"train": [], "validation": [], "test": []}, cache_root="unused")["dev"]
    want = smoke.expected_inputs()
    assert len(dev) == len(want) == len(smoke.INPUT_FILES)
    for i in range(len(dev)):
        np.testing.assert_array_equal(dev[i]["original_image"], want[i])


def test_phase_15_checkpoint_round_trip_on_a_tiny_core(smoke, tmp_path):
    """Phase 15 (c) at the tiny size on the CPU, in bf16 as on the card."""
    import torch

    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore

    cores = [LatentDiffusionCore.random_init(LatentCoreSpec.tiny("clip"), seed, "cpu",
                                             dtype=torch.bfloat16) for seed in (0, 1)]
    nbytes, write_s, read_s, differ = smoke.checkpoint_round_trip(torch, *cores, str(tmp_path))
    n = sum(v.numel() for v in cores[0].state_dict().values())
    assert differ == [] and 2 * n < nbytes < 2 * n + 200_000
    assert write_s > 0 and read_s > 0


def test_graphs_of_names_each_owners_graphed_calls(smoke):
    """Every entry point ``graphed_chain`` and ``graphed_program`` swap has
    its ``*_eager`` twin and the ``GraphedCall`` attributes ``GRAPHS_OF``
    names, on each kind of owner: a text core, a VQ core, a pixel
    pipeline, a CLIP scorer, a guided energy."""
    import torch
    from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer
    from cyclediffusion_tpu_torch.pipelines import zoo
    from cyclediffusion_tpu_torch.pipelines.ddpm_ddim import DDPMDDIMPipeline
    from cyclediffusion_tpu_torch.pipelines.factory import TINY_CLIP
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.runtime.graphs import GraphedCall
    from cyclediffusion_tpu_torch.samplers.guided import GraphedEnergy

    text = LatentDiffusionCore(LatentCoreSpec.tiny("clip"), device="cpu")
    vq = LatentDiffusionCore(LatentCoreSpec.tiny(None, fs_kind="vq"), device="cpu")
    pixel = DDPMDDIMPipeline.random_init(zoo.tiny_pixel_spec(16), 0, device="cpu",
                                         custom_steps=20, es_steps=5, eta=0.1)
    owners = [(text, ("apply_model", "apply_model_cached") + smoke.TEXT_PROGRAMS),
              (vq, smoke.FIRST_STAGE),
              (pixel, ("_model_fn",)),
              (CLIPScorer(TINY_CLIP, device="cpu"), ("embed_image", "embed_text")),
              (GraphedEnergy(lambda x, p, t: torch.sum(p)), ("grad",))]
    for owner, names in owners:
        for name in names:
            assert callable(getattr(owner, name)) and callable(getattr(owner, name + "_eager"))
            assert all(isinstance(getattr(owner, a), GraphedCall)
                       for a in smoke.GRAPHS_OF[name]), (type(owner).__name__, name)
    assert vq._graphed_cond is None and smoke.graphs_of(vq, "get_learned_conditioning") == []
