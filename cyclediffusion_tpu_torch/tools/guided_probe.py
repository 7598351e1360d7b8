"""CLIP-energy guided sampling at SD v1 512 px (tracked config 5, "SD 512
with CLIP-energy guidance"): the plain eps-replay chain against the guided
one, whose every step takes a gradient through the kl-f8 decoder and the
ViT-B/32 vision tower.

    python -m cyclediffusion_tpu_torch.tools.guided_probe [--steps 50] [--weight 0.05]
        [--reps 3] [--device cuda]

SD v1 and the scorer at their published widths with seeded random bf16
weights (the time does not depend on the weights); a 50-step replay at eta
0.1 of a seeded latent code, dual-batch classifier-free guidance at scale
5.0, batch 1, energy weight 0.05.  Runs on the card unless ``--device cpu``
is given; on the card it prints the card's name and its SM clock, power draw
and power limit (nvidia-smi) after the runs.  Reports
seconds per chain and ms per step of each chain (host clock around work that
ends in a synchronize, the median of ``--reps`` runs after one untimed run
of each, in alternating order: plain, guided, guided, plain, ...), their ratio and mean|dz0|, the
guidance's shift of the final latent.

Before the chains it profiles the energy's gradient at the first step's
pred_x0 (``energy_profile``): eager, the host's enqueue ms and the device
span per call, device ms and launches per call by kernel kind
(``torch.profiler``), its operations (``FlopCounterMode``: the decoder's
forward and input-only backward at 512 px, the ViT-B/32's forward and
backward) and the bytes of its weights, and the bound they set on the
card; graph-replayed (``samplers.guided.GraphedEnergy``), the capture's
seconds, the replay's device ms, the host ms per graphed call, and the
replay's gradient against the eager one beside the spread of three eager
gradients (the resize's backward adds with atomics).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import time
from typing import Callable

import torch

from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer
from cyclediffusion_tpu_torch.energy.clip_energy import clip_energy_fn
from cyclediffusion_tpu_torch.models.clip import CLIPConfig
from cyclediffusion_tpu_torch.ops.cfg import cfg_model_fn
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.ops.steps import pred_x0_from_eps
from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
from cyclediffusion_tpu_torch.samplers import ddim_decode, energy_guided_decode
from cyclediffusion_tpu_torch.samplers.guided import GraphedEnergy
from cyclediffusion_tpu_torch.text import HashTokenizer
from cyclediffusion_tpu_torch.tools.step_probe import (
    card_state,
    eager_ms,
    graph_ms,
    profile_kinds,
)

ETA = 0.1
CFG_SCALE = 5.0
PROMPT = "a photo of a dog"


@dataclasses.dataclass
class GuidedSetup:
    """One seeded guided-sampling problem: the core, the scorer, the CFG
    eps model and its contexts, the CLIP energy, and a latent code (x_T, the
    chain's eps)."""

    core: LatentDiffusionCore
    scorer: CLIPScorer
    sched: DDIMSchedule
    model_fn: Callable
    energy_fn: GraphedEnergy
    x_T: torch.Tensor
    eps: torch.Tensor
    cond: torch.Tensor
    uncond: torch.Tensor

    def plain(self) -> torch.Tensor:
        return ddim_decode(self.model_fn, self.sched, self.x_T, self.eps)

    def guided(self, weight: float) -> torch.Tensor:
        return energy_guided_decode(self.model_fn, self.sched, self.x_T, self.eps, None,
                                    self.energy_fn, weight)


def build(spec: LatentCoreSpec, clip_config: CLIPConfig, *, steps: int, device,
          dtype=torch.bfloat16, seed: int = 0) -> GuidedSetup:
    """Seeded core (``seed``) and scorer (``seed + 1``), the CFG eps model
    of ``PROMPT`` against the empty prompt at ``CFG_SCALE``, its CLIP
    energy, and a latent code at batch 1 (``seed + 2``)."""
    core = LatentDiffusionCore.random_init(spec, seed, device, dtype)
    scorer = CLIPScorer.random_init(seed + 1, clip_config, device, dtype)
    device = core.device
    tok = HashTokenizer(spec.cond_cfg.vocab_size, spec.context_length)
    cond = core.get_learned_conditioning(tok([PROMPT]))
    uncond = core.get_learned_conditioning(tok([""]))
    model_fn = cfg_model_fn(core.apply_model, uncond, cond, CFG_SCALE)
    text = scorer.embed_text(HashTokenizer(clip_config.vocab_size,
                                           clip_config.context_length)([PROMPT]))
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    shape = (1, spec.image_size, spec.image_size, spec.channels)
    x_T = torch.randn(shape, generator=gen, device=device)
    eps = torch.randn((steps,) + shape, generator=gen, device=device)
    return GuidedSetup(core, scorer, core.make_ddim_schedule(steps, ETA), model_fn,
                       clip_energy_fn(core, scorer, text), x_T, eps, cond, uncond)


# the H100 SXM's dense bf16 tensor-core peak and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def first_step_point(setup: GuidedSetup):
    """(x_T, pred_x0 of the chain's first step, its timestep)."""
    x, sched = setup.x_T, setup.sched
    t = torch.full((x.shape[0],), int(sched.timesteps[-1]), dtype=torch.int64,
                   device=x.device)
    p = pred_x0_from_eps(x, setup.model_fn(x, t), sched.alphas[-1],
                         sched.sqrt_one_minus_alphas[-1])
    return x, p, t


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max())


def energy_profile(setup: GuidedSetup, calls: int = 10) -> dict:
    """The energy's gradient at the first step's pred_x0 on the card, eager
    and graph-replayed (see the module's docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    x, p, t = first_step_point(setup)
    energy = setup.energy_fn
    eager = functools.partial(energy.grad_eager, x, p, t)
    first = eager()
    host, dev = eager_ms(eager, calls)
    kinds = profile_kinds(eager, calls)
    with FlopCounterMode(display=False) as counter:
        eager()
    flops = float(counter.get_total_flops())
    fs = setup.core.first_stage
    nbytes = sum(q.numel() * q.element_size()
                 for m in (fs.post_quant_conv, fs.decoder, setup.scorer.model.visual)
                 for q in m.parameters())
    nbytes += sum(v.numel() * v.element_size() for v in (x, p, t, first))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    spread = max(rel_gap(eager(), first) for _ in range(3))

    graphed = functools.partial(energy.grad, x, p, t)
    known = set(energy._graphed_grad.graphs)
    graphed()
    torch.cuda.synchronize()
    new = [c for k, c in energy._graphed_grad.graphs.items() if k not in known]
    captured = new[0] if new else next(iter(energy._graphed_grad.graphs.values()))
    gap = rel_gap(graphed(), first)
    ghost, gdev = eager_ms(graphed, calls)
    return {"eager_host_ms": host, "eager_device_ms": dev,
            "eager_kinds": {k: {"ms": ms, "launches": n} for k, (ms, n) in kinds.items()},
            "eager_launches": sum(n for _, n in kinds.values()),
            "gflop": flops / 1e9, "weight_and_io_mb": nbytes / 1e6,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "capture_s": captured.seconds, "replay_ms": graph_ms(captured.graph, calls),
            "graphed_host_ms": ghost, "graphed_device_ms": gdev,
            "graphed_vs_eager": gap, "eager_spread": spread}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(setup: GuidedSetup, weight: float, reps: int) -> dict:
    """Both chains once untimed (the kernels' build and cuDNN's first calls),
    then ``reps`` times, alternating -> seconds per chain (median), ms per
    step, the ratio and mean|dz0|."""
    device = setup.x_T.device
    fns = {"plain": setup.plain, "guided": lambda: setup.guided(weight)}
    times = {"plain": [], "guided": []}
    out = {name: fn() for name, fn in fns.items()}
    for r in range(reps):
        for name in (("plain", "guided") if r % 2 == 0 else ("guided", "plain")):
            _sync(device)
            t0 = time.perf_counter()
            out[name] = fns[name]()
            _sync(device)
            times[name].append(time.perf_counter() - t0)
    if not torch.isfinite(out["guided"]).all():
        raise RuntimeError("the guided chain produced non-finite values")
    steps = setup.sched.num_steps
    s = {name: statistics.median(ts) for name, ts in times.items()}
    return {"plain_s": s["plain"], "guided_s": s["guided"],
            "plain_ms_per_step": 1e3 * s["plain"] / steps,
            "guided_ms_per_step": 1e3 * s["guided"] / steps,
            "ratio": s["guided"] / s["plain"],
            "mean_abs_dz0": float((out["guided"] - out["plain"]).abs().mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--weight", type=float, default=0.05)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    where = "cpu"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("guided_probe: no CUDA device (pass --device cpu for the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    setup = build(LatentCoreSpec.sd_v1(), CLIPConfig.vit_b_32(), steps=args.steps,
                  device=device)
    if device.type == "cuda":
        prof = energy_profile(setup)
        print(f"guided_probe energy: {json.dumps(prof)}", flush=True)
    res = run(setup, args.weight, args.reps)
    if device.type == "cuda":
        where = (f"{torch.cuda.get_device_name(device)}; SM clock, power, limit, "
                 f"temperature, throttle: {card_state()}")
    print(f"guided_probe ({where}): plain {res['plain_s']:.3f} s/chain "
          f"({res['plain_ms_per_step']:.1f} ms/step), guided {res['guided_s']:.3f} s/chain "
          f"({res['guided_ms_per_step']:.1f} ms/step) = {res['ratio']:.2f}x plain; "
          f"mean|dz0| {res['mean_abs_dz0']:.4g} at weight {args.weight}", flush=True)
    return res


if __name__ == "__main__":
    main()
