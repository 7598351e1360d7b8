"""Where the AFHQ pixel UNet call's time goes on one NVIDIA GPU.

    python -m cyclediffusion_tpu_torch.tools.pixel_probe

The improved-DDPM ``afhq256`` UNet (93,563,910 params) with seeded random
weights, at batch 2 on 256 px, the call of ``chip_smoke.py`` phase 11.  It
runs in each setting below, in alternating rounds (forward, then backward
through the list) so that a drift of the card hits all alike:

* ``dtype``: fp32 (TF32 off), fp32 with TF32 convolutions (PyTorch's
  default for cuDNN), bf16;
* ``layout``: ``nhwc`` hands the UNet a contiguous NHWC tensor, as the
  pipeline does (the UNet's permute to NCHW is then a channels-last view,
  and the convolutions run channels-last); ``nchw`` hands it an NHWC view
  of a contiguous NCHW tensor (the permute gives contiguous NCHW);
* ``deterministic``: ``torch.backends.cudnn.deterministic`` off (PyTorch's
  default) or on (what ``chip_smoke.py``'s round trips set).

For each: ``eager`` host and device ms per call over ``CALLS`` back-to-back
calls (CUDA events), and ``graph`` ms per replay of one captured call; the
operation bound from ``torch.utils.flop_counter`` at the card's published
peak.  Then, for the pipeline's NHWC input in fp32 with TF32 off and on,
``torch.profiler``'s device time by kernel kind and the longest kernels by
name.  Each run's line ends with the card's clock and power (nvidia-smi).
Last, a JSON summary.
"""

from __future__ import annotations

import copy
import functools
import json

import torch

from cyclediffusion_tpu_torch.models.nn import fill_random_
from cyclediffusion_tpu_torch.pipelines import zoo
from cyclediffusion_tpu_torch.tools.step_probe import (
    card_state,
    eager_ms,
    graph_ms,
    graph_of,
    profile_kinds,
)

BATCH = 2
CALLS = 10
ROUNDS = 2
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
SETTINGS = [(dtype, layout, det) for dtype in ("fp32", "tf32", "bf16")
            for layout in ("nhwc", "nchw") for det in (False, True)]


def unet_flops(model, batch: int, resolution: int = 256) -> float:
    """Operations of one call of a pixel UNet (its convolutions' and matrix
    products'), counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        meta = type(model)(model.config)
    with FlopCounterMode(display=False) as counter:
        meta(torch.zeros((batch, resolution, resolution, 3), device="meta"),
             torch.zeros((batch,), dtype=torch.int64, device="meta"))
    return float(counter.get_total_flops())


def top_kernels(step, calls: int, n: int = 6) -> list:
    """[(device kernel name, ms per call, launches per call)], the ``n``
    longest by device time, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    rows = [(r.key, getattr(r, "self_device_time_total", 0) / 1e3 / calls, r.count / calls)
            for r in prof.key_averages()]
    return sorted(rows, key=lambda r: -r[1])[:n]


def _apply(setting):
    dtype, layout, det = setting
    torch.backends.cudnn.allow_tf32 = dtype == "tf32"
    torch.backends.cudnn.deterministic = det


def _step(models, x, t, setting):
    dtype, layout, _ = setting
    model = models["bf16" if dtype == "bf16" else "fp32"]
    xin = x.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    if layout == "nchw":
        xin = xin.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return functools.partial(model, xin, t)


@torch.no_grad()
def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("pixel_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    spec = zoo.PIXEL_ZOO["afhqdog256"]
    with torch.device("cuda"):
        model = zoo.build_pixel_model(spec)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval().requires_grad_(False)
    models = {"fp32": model, "bf16": copy.deepcopy(model).to(torch.bfloat16)}
    flops = unet_flops(model, BATCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((BATCH, 256, 256, 3), generator=gen, device="cuda")
    t = torch.full((BATCH,), 500, dtype=torch.int64, device="cuda")
    print(f"afhq256 UNet, batch {BATCH}: {flops / 1e9:.1f} GFLOP per call; "
          f"{torch.cuda.get_device_name(0)}; {card_state()}", flush=True)

    runs = []
    for r in range(ROUNDS):
        for setting in (SETTINGS if r % 2 == 0 else SETTINGS[::-1]):
            _apply(setting)
            step = _step(models, x, t, setting)
            graph, out = graph_of(step)
            graph.replay()
            torch.cuda.synchronize()
            same = bool(torch.equal(out, step()))
            host, dev = eager_ms(step, CALLS)
            rep = graph_ms(graph, CALLS)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            bound = 1e3 * flops / PEAK_FLOPS[setting[0]]
            run = {"dtype": setting[0], "layout": setting[1], "deterministic": setting[2],
                   "eager_host_ms": host, "eager_device_ms": dev, "graph_ms": rep,
                   "bound_ms": bound, "graph_equals_eager": same, "peak_gib": peak}
            runs.append(run)
            print(f"{setting[0]} {setting[1]} deterministic={setting[2]}: eager host "
                  f"{host:.3f} ms, device {dev:.3f} ms; graph {rep:.3f} ms (bound {bound:.3f} "
                  f"ms by operations; graph == eager: {same}); peak {peak:.2f} GiB; "
                  f"{card_state()}", flush=True)
            del graph, out, step
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    profiles = {}
    for setting in [("fp32", "nhwc", False), ("tf32", "nhwc", False)]:
        _apply(setting)
        kinds = profile_kinds(_step(models, x, t, setting), CALLS)
        profiles[" ".join(map(str, setting))] = kinds
        print(f"profile {setting}: " + "; ".join(
            f"{k} {ms:.3f} ms, {n:.0f} launches" for k, (ms, n) in kinds.items()), flush=True)
        for name, ms, n in top_kernels(_step(models, x, t, setting), CALLS):
            print(f"  {ms:.3f} ms, {n:.0f} launches: {name[:160]}", flush=True)
    _apply(("fp32", "nhwc", False))
    summary = {"flops": flops, "runs": runs, "profiles": profiles}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
