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
  50 decode steps, eta 0.1, scales 1 / 5), seconds per request by the host
  clock around work that ends in a synchronize.
* ``profile``: ``torch.profiler`` over ``CALLS`` eager calls with the
  kernels; device-kernel time and launches per call, grouped by kind.

Prints one line per measurement and, last, a JSON summary of every run.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time

import torch

from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
from cyclediffusion_tpu_torch.text import HashTokenizer

MODES = ("kernels", "plain")
STEPS = 50
ROUNDS = 3     # alternating rounds, each runs both modes once
CALLS = 10     # UNet calls per eager, graph and profile measurement

# device-kernel name fragments -> kind, first match wins (convolutions
# before GEMMs: cuDNN's implicit-GEMM conv kernels carry "gemm" too)
KINDS = (
    ("flash_fwd", "flash kernels (K1, K2)"),
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


@contextlib.contextmanager
def attention(mode: str):
    """The dispatcher's flash entry points as they are ("kernels"), or
    replaced by their plain versions ("plain") inside the block."""
    saved = fa.flash_attention_packed, fa.flash_attention_bhtd
    if mode == "plain":
        fa.flash_attention_packed = fa.attention_packed_reference
        fa.flash_attention_bhtd = fa.attention_reference
    try:
        yield
    finally:
        fa.flash_attention_packed, fa.flash_attention_bhtd = saved


def alternating(rounds: int):
    """kernels, plain, plain, kernels, kernels, plain, ... (2 * rounds)."""
    for r in range(rounds):
        yield from (MODES if r % 2 == 0 else MODES[::-1])


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
    """(CUDA graph of one call of ``step``, its static output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    return graph, out


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


def translate_s(core, pipe, images, src, dst, seed: int) -> float:
    """Seconds per request of one 2-request translate (encode + generate)."""
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

    core = LatentDiffusionCore.random_init(LatentCoreSpec.sd_v1(), seed=0, device="cuda",
                                           dtype=torch.bfloat16)
    pipe = StochasticTextPipeline(
        core, HashTokenizer(49408, 77), custom_steps=STEPS, eta=0.1,
        white_box_steps=STEPS + 1, skip_steps=[0],
        encoder_unconditional_guidance_scales=[1.0],
        decoder_unconditional_guidance_scales=[5.0], n_trials=1)
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
        return core.apply_model(x, t, ctx)

    summary = {"device": torch.cuda.get_device_name(0), "eager": [], "graph": [],
               "translate": []}
    graphs = {}
    for mode in MODES:
        with attention(mode):
            eager_out = step()
            graphs[mode] = graph_of(step)
            graphs[mode][0].replay()
            torch.cuda.synchronize()
            same = torch.equal(graphs[mode][1], eager_out)
            print(f"graph [{mode}]: replay equals eager bitwise: {same}", flush=True)
            if not same:
                raise RuntimeError(f"graph replay differs from eager ({mode})")
            translate_s(core, pipe, images, src, dst, seed=2)   # warm-up

    for i, mode in enumerate(alternating(ROUNDS)):
        with attention(mode):
            host, dev = eager_ms(step, CALLS)
            rep = graph_ms(graphs[mode][0], CALLS)
            summary["eager"].append({"mode": mode, "host_ms": host, "device_ms": dev})
            summary["graph"].append({"mode": mode, "device_ms": rep})
            secs = translate_s(core, pipe, images, src, dst, seed=3 + i)
            summary["translate"].append({"mode": mode, "s_per_request": secs})
            print(f"run {i} [{mode}]: eager host {host:.3f} ms/call, device span "
                  f"{dev:.3f} ms/call; graph replay {rep:.3f} ms/call; translate "
                  f"{secs:.4f} s/request", flush=True)

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

    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
