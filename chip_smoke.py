#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cyclediffusion_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):

1. Device: refuses to run without CUDA; prints the card's name and power
   limit (nvidia-smi).
2. Build: compiles the flash-attention kernels from ``csrc/`` with nvcc.
3. Kernel against plain: each kernel and its plain PyTorch version on the
   same inputs, at the SD shapes in bf16, at a ragged shape, and in fp32
   with TF32 off; max abs error relative to max|plain| against a stated
   bound, median times.
4. The slice: SD-v1 at 512 px (full widths, seeded random weights, bf16),
   2 translate requests through ``StochasticTextPipeline`` — 50 DDIM steps,
   eta 0.1, encoder scale 1, decoder scale 5 — with the kernels' launch
   counts checked (5 of each per UNet call), and one UNet call checked
   against the same call with plain attention.
5. Round trip: encode, then decode under the same text and scale 1, with
   deterministic cuDNN; with the UNet in fp32 the replay must give back the
   encoded latent (the bf16 round trip is printed, not bounded).

The last two lines of output are the kernels' JSON record and the result
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain, max abs error / max|plain output|.  bf16: the kernel
# rounds its output once after normalising, the plain version rounds the
# softmax weights before P.V, so the two differ by about one bf16 ulp, at
# most 2^-7 (7.8e-3) of the largest output.  A kernel that dropped one
# 64-key tile of 4096 would miss by ~2% of it.
BF16_REL_BOUND = 1e-2
FP32_REL_BOUND = 1e-4  # fp32, TF32 off: only the summation order differs
UNET_REL_BOUND = 5e-2  # whole bf16 UNet, kernels vs plain attention, / max|eps|
ROUND_TRIP_BOUND = 1e-3  # max|replay - x0| on the latent, fp32 UNet (|x0| ~ 2.5)
STEPS = 50
ETA = 0.1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds per call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_kernels(torch, fa):
    """Phase 3: every kernel against its plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    # (kernel, label, dtype, shape args); packed: (B, Tq, Tk, H, d),
    # bhtd: (B, H, Tq, Tk, d).  "main path": what the slice below gives the
    # kernels (2 requests x the CFG pair); its numbers go to the JSON record
    cases = [
        ("flash_attention_packed", "main path", bf16, (4, 4096, 4096, 8, 40)),
        ("flash_attention_bhtd", "main path", bf16, (4, 8, 1024, 1024, 80)),
        ("flash_attention_packed", "sd 64x64", bf16, (2, 4096, 4096, 8, 40)),
        ("flash_attention_bhtd", "sd 32x32", bf16, (2, 8, 1024, 1024, 80)),
        ("flash_attention_packed", "ragged", bf16, (2, 300, 200, 4, 64)),
        ("flash_attention_bhtd", "ragged", bf16, (1, 2, 1024, 77, 40)),
        ("flash_attention_packed", "sd 64x64", f32, (2, 4096, 4096, 8, 40)),
        ("flash_attention_bhtd", "sd 32x32", f32, (2, 8, 1024, 1024, 80)),
    ]
    record = {}
    for name, label, dtype, shp in cases:
        if name == "flash_attention_packed":
            b, tq, tk, h, d = shp
            q, k, v = rand((b, tq, h * d), dtype), rand((b, tk, h * d), dtype), rand((b, tk, h * d), dtype)
            scale = d ** -0.5
            kernel = functools.partial(fa.flash_attention_packed, q, k, v, h, scale)
            plain = functools.partial(fa.attention_packed_reference, q, k, v, h, scale)
        else:
            b, h, tq, tk, d = shp
            q, k, v = rand((b, h, tq, d), dtype), rand((b, h, tk, d), dtype), rand((b, h, tk, d), dtype)
            scale = d ** -0.5
            kernel = functools.partial(fa.flash_attention_bhtd, q, k, v, scale)
            plain = functools.partial(fa.attention_reference, q, k, v, scale)
        out = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((out.float() - want.float()).abs().max())
        peak = float(want.float().abs().max())
        rel = err / peak
        bound = BF16_REL_BOUND if dtype == bf16 else FP32_REL_BOUND
        if not torch.isfinite(out).all():
            fail(f"{name} {label} {dtype}: non-finite output")
        # the kernel is deterministic: a second launch gives the same bits
        again = kernel()
        if not torch.equal(out, again):
            fail(f"{name} {label} {dtype}: two launches differ")
        ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain)
        say(f"kernel {name} [{label}] {str(dtype).split('.')[-1]} shape={shp}: "
            f"max_abs_err={err:.3e}, max|plain|={peak:.3e}, ratio {rel:.3e} "
            f"(bound {bound:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not rel <= bound:
            fail(f"{name} {label} {dtype}: max_abs_err / max|plain| = {rel} > {bound}")
        if label == "main path":
            record[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def phase_slice(torch, fa, attention, HashTokenizer, LatentCoreSpec,
                LatentDiffusionCore, StochasticTextPipeline):
    """Phase 4 (+5): the SD-v1 translate path at 512 px."""
    t0 = time.perf_counter()
    spec = LatentCoreSpec.sd_v1()
    core = LatentDiffusionCore.random_init(spec, seed=0, device="cuda",
                                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say(f"slice: SD-v1 core (UNet {sum(p.numel() for p in core.unet.parameters()):,} "
        f"params, VAE {sum(p.numel() for p in core.first_stage.parameters()):,}, "
        f"CLIP {sum(p.numel() for p in core.cond_model.parameters()):,}) in bf16, "
        f"random init {time.perf_counter() - t0:.2f} s")
    tok = HashTokenizer(49408, 77)
    kw = dict(custom_steps=STEPS, eta=ETA, white_box_steps=STEPS + 1, skip_steps=[0],
              encoder_unconditional_guidance_scales=[1.0], n_trials=1)
    pipe = StochasticTextPipeline(core, tok, decoder_unconditional_guidance_scales=[5.0], **kw)
    gen = torch.Generator(device="cuda").manual_seed(1)
    # two requests: smooth random images (upsampled 8x8 noise) in [0, 1]
    small = torch.rand((2, 3, 8, 8), generator=gen, device="cuda")
    images = torch.nn.functional.interpolate(small, size=(512, 512), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    src = ["a photo of a cat", "a painting of a house"]
    dst = ["a photo of a dog", "a painting of a castle"]

    # warm-up: one UNet call per batch shape, off the counted run
    x_warm = torch.zeros((4, 64, 64, 4), device="cuda")
    ctx = pipe.get_condition(src + dst)
    t_warm = torch.full((4,), 981, dtype=torch.int64, device="cuda")
    core.apply_model(x_warm, t_warm, ctx)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    unet_calls = [0]
    apply_model = core.apply_model

    def counted(*a):
        unet_calls[0] += 1
        return apply_model(*a)

    core.apply_model = counted
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = pipe.encode(images, src, gen)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    out = pipe.generate(z, dst, gen)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts = dict(fa.launch_counts)
    core.apply_model = apply_model
    peak = torch.cuda.max_memory_allocated()

    say(f"slice: 2 requests in {t_all:.3f} s (encode {t_enc:.3f} s, generate "
        f"{t_all - t_enc:.3f} s) = {t_all / 2:.3f} s/request; {unet_calls[0]} UNet "
        f"calls; peak device memory {peak / 2**30:.2f} GiB")
    if len(out) != 1:
        fail(f"expected 1 image batch (1 z x 1 decoder scale), got {len(out)}")
    img = out[0]
    if tuple(img.shape) != (2, 512, 512, 3):
        fail(f"image shape {tuple(img.shape)}")
    if not torch.isfinite(img).all():
        fail("non-finite image values")
    lo, hi = float(img.min()), float(img.max())
    shown = img.clamp(0.0, 1.0)   # as the repo's evaluators clip before saving
    say(f"slice: images {tuple(img.shape)} finite, raw range [{lo:.4f}, {hi:.4f}], "
        f"{float(((img < 0) | (img > 1)).float().mean()):.4%} of values outside "
        f"[0, 1] before clipping; clipped range [{float(shown.min()):.4f}, "
        f"{float(shown.max()):.4f}]")
    if unet_calls[0] != 2 * STEPS:
        fail(f"expected {2 * STEPS} UNet calls, got {unet_calls[0]}")
    for name in ("flash_attention_packed", "flash_attention_bhtd"):
        if counts[name] != 5 * unet_calls[0]:
            fail(f"{name}: {counts[name]} launches, expected 5 per UNet call "
                 f"({5 * unet_calls[0]})")
    say(f"slice: launches {counts} = 5 per UNet call for each kernel; the "
        f"folded-attention kernels K3/K4 are not ported, so nothing can launch them")

    # per-UNet-step time at the CFG dual batch of the 2 requests
    step_ms = cuda_time_ms(lambda: core.apply_model(x_warm, t_warm, ctx), reps=10)
    say(f"slice: UNet step (batch 4 = 2 requests x CFG pair, 64x64x4 latent) "
        f"{step_ms:.3f} ms median")

    # one UNet call with the kernels against the same call on plain attention
    x_chk = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    eps_kernel = core.apply_model(x_chk, t_warm, ctx)
    with attention("plain"):
        eps_plain = core.apply_model(x_chk, t_warm, ctx)
    rel = float((eps_kernel - eps_plain).abs().max() / eps_plain.abs().max())
    say(f"slice: UNet eps with kernels vs plain attention: max abs diff / max|eps| "
        f"= {rel:.3e} (bound {UNET_REL_BOUND:.0e})")
    if not rel <= UNET_REL_BOUND:
        fail(f"UNet with kernels disagrees with plain attention: {rel}")

    rt_bf16 = round_trip(torch, core, pipe, images, src)
    say(f"round trip, bf16 UNet: max|replay - x0| = {rt_bf16:.3e} (not bounded: a "
        f"bf16 cast of the replayed latent that rounds one element the other way "
        f"than the encoder's gives a different eps, and the random-weight UNet "
        f"amplifies it)")
    del core, pipe
    torch.cuda.empty_cache()
    core = LatentDiffusionCore.random_init(spec, seed=0, device="cuda",
                                           dtype=torch.float32)
    pipe = StochasticTextPipeline(core, tok, decoder_unconditional_guidance_scales=[1.0], **kw)
    err = round_trip(torch, core, pipe, images, src)
    say(f"round trip, fp32 UNet (TF32 off): max|replay - x0| = {err:.3e} "
        f"(bound {ROUND_TRIP_BOUND:.0e})")
    if not err <= ROUND_TRIP_BOUND:
        fail(f"round trip error {err} > {ROUND_TRIP_BOUND}")
    return counts


def round_trip(torch, core, pipe, images, src) -> float:
    """Phase 5: encode, then replay under the same text and scale 1 with
    deterministic cuDNN -> max|replay - x0| on the latent."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    vae = torch.randn((images.shape[0], 64, 64, 4), generator=gen, device="cuda")
    x0 = core.encode_first_stage(images * 2.0 - 1.0, vae)
    z = pipe.encode(images, src, gen, vae_noise=vae)[0]
    xT, eps = pipe._unflatten(z, 0)
    c, uc = pipe.get_condition(src), pipe.uncond(images.shape[0])
    replay = pipe._decode_chains(xT[None], eps[None], c, uc, [1.0], None, 0)[0]
    return float((replay - x0).abs().max())


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "cyclediffusion_tpu_torch")):
        fail("run from a checkout of the repository: cyclediffusion_tpu_torch/ not found")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cyclediffusion_tpu_torch.ops import flash_attention as fa
    from cyclediffusion_tpu_torch.pipelines.latent import (
        LatentCoreSpec,
        LatentDiffusionCore,
    )
    from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
    from cyclediffusion_tpu_torch.text import HashTokenizer
    from cyclediffusion_tpu_torch.tools.step_probe import attention

    t0 = time.perf_counter()
    info = fa.load_kernels()
    say(f"build: {info.path.name} {'built' if info.built else 'found'} in "
        f"{info.seconds:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"build: {line.strip()}")

    record = phase_kernels(torch, fa)
    counts = phase_slice(torch, fa, attention, HashTokenizer, LatentCoreSpec,
                         LatentDiffusionCore, StochasticTextPipeline)

    source = "cyclediffusion_tpu_torch/csrc/flash_attention.cu"
    replaces = {"flash_attention_packed": "cyclediffusion_tpu/ops/flash_attention.py:267",
                "flash_attention_bhtd": "cyclediffusion_tpu/ops/flash_attention.py:187"}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name], "launches": counts[name], **record[name]}
               for name in ("flash_attention_packed", "flash_attention_bhtd")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
