"""Where the SD-v1 UNet step's time goes on one NVIDIA GPU, and what the
flash-attention kernels change end to end.

    python -m cyclediffusion_tpu_torch.tools.step_probe

SD-v1 at full width with seeded random bf16 weights; the UNet runs at batch
4 (two translate requests x the CFG pair, 64x64x4 latent, 77-token context),
the step of ``chip_smoke.py``'s slice.  Every measurement runs once with the
kernels and once with their plain PyTorch versions swapped into the
dispatcher, in alternating order (kernels, plain, plain, kernels, ...), so
that a drift of the host or the card hits both sides alike:

* ``eager``: ``CALLS`` back-to-back UNet calls.  ``host_ms`` is the host's
  time to enqueue them (until the last call returns), ``device_ms`` the span
  between CUDA events recorded before the first and after the last; both per
  call.  ``device_ms`` close to ``host_ms`` means the card waits on Python.
* ``graph``: one UNet call captured in a CUDA graph and replayed ``CALLS``
  times: the device's own time per call, without Python dispatch.  The
  replay's output is checked bitwise against the eager call's.
* ``translate``: the 2-request translate of ``chip_smoke.py`` (50 encode +
  50 decode steps, eta 0.1, scales 1 / 5, the UNet calls replayed as CUDA
  graphs, one core per mode), seconds per request by the host clock around
  work that ends in a synchronize.
* ``profile``: ``torch.profiler`` over ``CALLS`` eager calls with the
  kernels; device-kernel time and launches per call, grouped by kind.
* ``folded``: the same UNet step in the three self-attention modes of the
  64x64 level — the default (K2 between separate projections), ``qo`` (K3)
  and ``1`` (K4) — one core per mode from the same seed, in rotating order
  (default, qo, 1, 1, qo, default, ...): eager host and device ms and the
  CUDA-graph replay ms per call.

Each run's line ends with the card's SM clock, power, temperature and
throttle reasons (nvidia-smi) read just after it: the card's speed drifts
within one call.  Prints one line per measurement and, last, a JSON summary
of every run.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import time

import torch

from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.runtime import graphs
from cyclediffusion_tpu_torch.text import HashTokenizer

MODES = ("kernels", "plain")
FOLDED_MODES = ("default", "qo", "1")
STEPS = 50
ROUNDS = 3     # alternating rounds, each runs every mode once
CALLS = 10     # UNet calls per eager, graph and profile measurement

# device-kernel name fragments -> kind, first match wins (convolutions
# before GEMMs: cuDNN's implicit-GEMM conv kernels carry "gemm" too)
KINDS = (
    ("flash_fwd", "flash kernels (K1, K2)"),
    ("linear_bf16", "folded kernels (K3, K4)"),
    ("qout_", "folded kernels (K3, K4)"),
    ("kv_proj", "folded kernels (K3, K4)"),
    ("nchwToNhwc", "cuDNN layout conversions"),
    ("nhwcToNchw", "cuDNN layout conversions"),
    ("fprop", "convolutions"),
    ("conv", "convolutions"),
    ("gemm", "GEMMs"),
    ("nvjet", "GEMMs"),
    ("GroupNorm", "GroupNorm"),
    ("RowwiseMoments", "GroupNorm"),
    ("group_norm", "GroupNorm"),
    ("layer_norm", "LayerNorm"),
    ("softmax", "softmax"),
    ("copy", "copies"),
    ("elementwise", "elementwise"),
    ("reduce", "reductions"),
)


def kernel_kind(name: str) -> str:
    """The kind of a device kernel, by its (mangled or demangled) name."""
    low = name.lower()
    for frag, kind in KINDS:
        if frag.lower() in low:
            return kind
    return "other"


# each kernel's wrapper in ops/flash_attention.py -> its plain version
PLAIN_VERSIONS = {
    "flash_attention_packed": "attention_packed_reference",
    "flash_attention_bhtd": "attention_reference",
    "qout_self_attention_block": "qout_self_attention_reference",
    "fused_self_attention_block": "fused_self_attention_reference",
}


@contextlib.contextmanager
def attention(mode: str):
    """The kernels' entry points (K1-K4) as they are ("kernels"), or
    replaced by their plain versions ("plain") inside the block."""
    saved = {name: getattr(fa, name) for name in PLAIN_VERSIONS}
    if mode == "plain":
        for name, plain in PLAIN_VERSIONS.items():
            setattr(fa, name, getattr(fa, plain))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)


def alternating(rounds: int, modes=MODES):
    """``modes`` forward, then backward, then forward, ... (``rounds`` passes):
    kernels, plain, plain, kernels, kernels, plain, ... by default."""
    for r in range(rounds):
        yield from (modes if r % 2 == 0 else modes[::-1])


def card_state() -> str:
    """The card's SM clock, power draw and limit, temperature and active
    throttle reasons, as nvidia-smi reads them now."""
    query = "clocks.sm,power.draw,power.limit,temperature.gpu,clocks_throttle_reasons.active"
    proc = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "unknown"


def folded_steps(x, t, ctx, calls: int, rounds: int) -> list:
    """The ``folded`` measurement: one record per run, modes rotating."""
    steps = {}
    for mode in FOLDED_MODES:
        core = LatentDiffusionCore.random_init(
            LatentCoreSpec.sd_v1(), seed=0, device="cuda", dtype=torch.bfloat16,
            folded_attn=None if mode == "default" else mode)
        step = functools.partial(core.apply_model_eager, x, t, ctx)
        steps[mode] = (step, graph_of(step)[0])
    runs = []
    for i, mode in enumerate(alternating(rounds, FOLDED_MODES)):
        step, graph = steps[mode]
        host, dev = eager_ms(step, calls)
        rep = graph_ms(graph, calls)
        card = card_state()
        runs.append({"mode": mode, "host_ms": host, "device_ms": dev, "graph_ms": rep,
                     "card": card})
        print(f"folded run {i} [{mode}]: eager host {host:.3f} ms/call, device span "
              f"{dev:.3f} ms/call; graph replay {rep:.3f} ms/call; card after: {card}",
              flush=True)
    return runs


def eager_ms(step, calls: int):
    """(host enqueue ms, device span ms) per call over ``calls`` calls."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        step()
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    return 1e3 * host / calls, start.elapsed_time(end) / calls


def graph_of(step):
    """(one call of ``step`` captured by ``runtime.graphs`` after a warm-up
    call, its static output).  ``step`` must launch eagerly (a model's
    ``*_eager`` entry point): a graphed call cannot be captured again."""
    graphs.warm_up(step)
    captured = graphs.capture(step)
    return captured, captured.output


def graph_ms(graph, calls: int) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def profile_kinds(step, calls: int):
    """{kind: (device ms per call, launches per call)} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()

    def device_us(row):
        us = getattr(row, "self_device_time_total", None)
        return row.self_cuda_time_total if us is None else us

    rows = [r for r in prof.key_averages() if device_us(r) > 0]
    kernel_rows = [r for r in rows if r.device_type == torch.autograd.DeviceType.CUDA]
    if not kernel_rows:   # kernels not tagged as device events: drop the aten ops
        kernel_rows = [r for r in rows if not r.key.startswith("aten::")]
    kinds = {}
    for row in kernel_rows:
        us = device_us(row)
        kind = kernel_kind(row.key)
        ms, n = kinds.get(kind, (0.0, 0.0))
        kinds[kind] = (ms + us / 1e3 / calls, n + row.count / calls)
    return dict(sorted(kinds.items(), key=lambda kv: -kv[1][0]))


def translate_s(pipe, images, src, dst, seed: int) -> float:
    """Seconds per request of one 2-request translate (encode + generate),
    its UNet calls graph replays."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = pipe.encode(images, src, gen)
    out = pipe.generate(z, dst, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not torch.isfinite(out[0]).all():
        raise RuntimeError("translate gave non-finite images")
    return secs / images.shape[0]


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("step_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.load_kernels()

    # one core per mode, the same weights: a chain replays the graphs its
    # core captured, under the mode that was in force at the capture
    cores = {mode: LatentDiffusionCore.random_init(LatentCoreSpec.sd_v1(), seed=0,
                                                   device="cuda", dtype=torch.bfloat16)
             for mode in MODES}
    pipes = {mode: StochasticTextPipeline(
        core, HashTokenizer(49408, 77), custom_steps=STEPS, eta=0.1,
        white_box_steps=STEPS + 1, skip_steps=[0],
        encoder_unconditional_guidance_scales=[1.0],
        decoder_unconditional_guidance_scales=[5.0], n_trials=1)
        for mode, core in cores.items()}
    core, pipe = cores["kernels"], pipes["kernels"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    src = ["a photo of a cat", "a painting of a house"]
    dst = ["a photo of a dog", "a painting of a castle"]
    ctx = pipe.get_condition(src + dst)
    x = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((4,), 981, dtype=torch.int64, device="cuda")
    small = torch.rand((2, 3, 8, 8), generator=gen, device="cuda")
    images = torch.nn.functional.interpolate(small, size=(512, 512), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)

    def step():
        return core.apply_model_eager(x, t, ctx)

    summary = {"device": torch.cuda.get_device_name(0), "card": card_state(),
               "eager": [], "graph": [], "translate": []}
    print(f"card: {summary['card']} (SM MHz, W drawn, W limit, C, throttle reasons)",
          flush=True)
    step_graphs = {}
    for mode in MODES:
        with attention(mode):
            eager_out = step()
            step_graphs[mode] = graph_of(step)
            step_graphs[mode][0].replay()
            torch.cuda.synchronize()
            same = torch.equal(step_graphs[mode][1], eager_out)
            print(f"graph [{mode}]: replay equals eager bitwise: {same}", flush=True)
            if not same:
                raise RuntimeError(f"graph replay differs from eager ({mode})")
            translate_s(pipes[mode], images, src, dst, seed=2)   # warm-up, captures

    for i, mode in enumerate(alternating(ROUNDS)):
        with attention(mode):
            host, dev = eager_ms(step, CALLS)
            rep = graph_ms(step_graphs[mode][0], CALLS)
            summary["eager"].append({"mode": mode, "host_ms": host, "device_ms": dev})
            summary["graph"].append({"mode": mode, "device_ms": rep})
            secs = translate_s(pipes[mode], images, src, dst, seed=3 + i)
            summary["translate"].append({"mode": mode, "s_per_request": secs})
            card = card_state()
            print(f"run {i} [{mode}]: eager host {host:.3f} ms/call, device span "
                  f"{dev:.3f} ms/call; graph replay {rep:.3f} ms/call; translate "
                  f"{secs:.4f} s/request; card after: {card}", flush=True)

    for key in ("eager", "graph", "translate"):
        for mode in MODES:
            vals = [r for r in summary[key] if r["mode"] == mode]
            field = "s_per_request" if key == "translate" else "device_ms"
            nums = [r[field] for r in vals]
            print(f"{key} [{mode}] {field}: median {statistics.median(nums):.4f}, "
                  f"runs {[round(n, 4) for n in nums]}", flush=True)

    kinds = profile_kinds(step, CALLS)
    summary["profile"] = {k: {"ms": ms, "launches": n} for k, (ms, n) in kinds.items()}
    total = sum(ms for ms, _ in kinds.values())
    print(f"profile [kernels]: {total:.3f} ms of device kernels and "
          f"{sum(n for _, n in kinds.values()):.0f} launches per call", flush=True)
    for kind, (ms, n) in kinds.items():
        print(f"  {ms:8.3f} ms  {n:6.0f} launches  {kind}", flush=True)

    summary["folded"] = folded_steps(x, t, ctx, CALLS, ROUNDS)
    for mode in FOLDED_MODES:
        nums = [r["graph_ms"] for r in summary["folded"] if r["mode"] == mode]
        print(f"folded [{mode}] graph_ms: median {statistics.median(nums):.4f}, "
              f"runs {[round(n, 4) for n in nums]}", flush=True)

    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
