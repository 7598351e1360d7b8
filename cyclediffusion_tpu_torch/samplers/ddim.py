"""Latent-family DDIM sampler: DPM-Encoder and eps-replay decoding, exact
and with encoder caching, the stochastic refine, plain sampling from noise,
deterministic (eta 0) inversion and the SDEdit-style stochastic encode and
decode (counterpart of ``cyclediffusion_tpu.samplers.ddim``).

Each ``lax.scan`` of the JAX module is a Python loop here, one loop per
chain kind shared by the exact and the cached variant (they differ only in
how a step's eps is computed).  The model call inside is what the JAX
program compiles and the host cannot keep up with: the pipelines' model
functions replay it as a CUDA graph on the card (``runtime.graphs``), and
the step arithmetic around it stays eager, each piece a ``sampler.*`` span
(``runtime.profiling``) and each step one ``sampler.steps``.  The per-step
coefficients are gathered on the host into time-major tables of 0-d fp32
tensors.  Randomness comes from an explicit ``torch.Generator``, and every
draw can be replaced by pre-drawn noise (the seam the parity tests use to
feed both implementations the same numbers).  Layout is NHWC; the latent
code's eps stack is time-major ``(n, B, H, W, C)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cyclediffusion_tpu_torch.ops import steps
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.runtime import profiling

# fn(x: (B,H,W,C) fp32, t: (B,) int64) -> eps (B,H,W,C) fp32
EpsModel = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# step i's eps: fn(i, x, t) -> eps
_StepFn = Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor]


class _StepTables(NamedTuple):
    """Time-major per-step coefficients for a chain of length L."""

    t: list                 # L Python ints: raw timesteps
    a_t: torch.Tensor       # (L,) fp32
    a_prev: torch.Tensor    # (L,)
    sigma: torch.Tensor     # (L,)
    s1ma: torch.Tensor      # (L,) sqrt(1 - a_t)
    index_is_zero: list     # L bools


def _chain_tables(sched: DDIMSchedule, refine_steps: int, length: int) -> _StepTables:
    """Tables for walking ``index = refine_steps-1-i`` for i in [0, length)."""
    idx = np.arange(refine_steps - 1, refine_steps - 1 - length, -1)
    gather = lambda tbl: tbl[torch.from_numpy(idx)]
    return _StepTables(
        t=[int(x) for x in sched.timesteps[torch.from_numpy(idx)]],
        a_t=gather(sched.alphas),
        a_prev=gather(sched.alphas_prev),
        sigma=gather(sched.sigmas),
        s1ma=gather(sched.sqrt_one_minus_alphas),
        index_is_zero=[bool(i == 0) for i in idx],
    )


def _randn(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _eps_with_fresh_tail(eps, refine_steps: int, x_T, generator):
    """Stored eps padded with fresh noise to ``refine_steps`` entries (the
    reference's fallback past the end of the stored list)."""
    n = 0 if eps is None else int(eps.shape[0])
    if n < refine_steps:
        fresh = _randn((refine_steps - n,) + tuple(x_T.shape), x_T, generator)
        return fresh if eps is None else torch.cat([eps, fresh], dim=0)
    return eps[:refine_steps]


def num_recovered_eps(sched_steps: int, white_box_steps: int, skip_steps: int) -> int:
    """Number of eps tensors the DPM-Encoder recovers (reference stop rule
    ``i < white_box_steps - skip_steps - 1`` over ``S - skip_steps`` steps;
    with ``white_box_steps = S + 1`` the full chain)."""
    refine_steps = sched_steps - skip_steps
    return max(0, min(refine_steps, white_box_steps - skip_steps - 1))


def _key_schedule(n: int, key_every: int, key_steps=None) -> list:
    """The fast mode's is-key-step mask (n bools): every ``key_every``-th
    step, or ``key_steps``; step 0 always fills the cache."""
    if key_steps is None:
        key_steps = np.arange(n) % max(1, int(key_every)) == 0
    key_steps = [bool(k) for k in np.asarray(key_steps, bool)]
    if len(key_steps) != n:
        raise ValueError(f"key_steps has {len(key_steps)} entries for a {n}-step chain")
    key_steps[0] = True
    return key_steps


def _exact_steps(model_fn: EpsModel) -> _StepFn:
    return lambda i, x, t: model_fn(x, t)


def _cached_steps(model_fn_key, model_fn_reuse, is_key: list) -> _StepFn:
    """Step i runs ``model_fn_key(x, t) -> (eps, cache)`` at a key step and
    ``model_fn_reuse(x, t, cache) -> eps`` on the last key step's cache
    otherwise.  Step 0 is a key step, so no cache is read before one is
    made.  The cache is held across the reuse calls that follow: a graphed
    key call returns a copy of its graph's cache, never the static buffer
    that its next replay overwrites."""
    cache = None

    def step(i, x, t):
        nonlocal cache
        if is_key[i]:
            e_t, cache = model_fn_key(x, t)
            return e_t
        return model_fn_reuse(x, t, cache)
    return step


def _t_vec(t: int, bsz: int, device) -> torch.Tensor:
    return torch.full((bsz,), t, dtype=torch.int64, device=device)


def _encode_chain(step: _StepFn, sched, x0, generator, white_box_steps, skip_steps,
                  temperature, xT_noise, posterior_noises):
    refine_steps = sched.num_steps - skip_steps
    n = num_recovered_eps(sched.num_steps, white_box_steps, skip_steps)
    if refine_steps < 1 or n < 1:
        raise ValueError(f"empty chain: refine_steps={refine_steps}, n={n}")

    if xT_noise is None:
        xT_noise = _randn(x0.shape, x0, generator)
    xT = steps.q_sample(x0, sched.alphas[refine_steps - 1], xT_noise)
    if posterior_noises is None:
        posterior_noises = _randn((n,) + tuple(x0.shape), x0, generator)

    tb = _chain_tables(sched, refine_steps, n)
    bsz = x0.shape[0]
    eps = torch.empty((n,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    xt = xT
    for i in range(n):
        profiling.count("sampler.steps")
        with (profiling.span("sampler.sample_xt_next") as s,
              s.device(xt, profiling.SAMPLE_EVERY)):
            xt_next = steps.sample_xt_next(
                x0, xt, tb.a_t[i], tb.a_prev[i], tb.sigma[i], posterior_noises[i],
                tb.index_is_zero[i])
        e_t = step(i, xt, _t_vec(tb.t[i], bsz, x0.device))
        with (profiling.span("sampler.compute_eps") as s,
              s.device(xt, profiling.SAMPLE_EVERY)):
            eps[i] = steps.compute_eps(
                xt, xt_next, e_t, tb.a_t[i], tb.a_prev[i], tb.sigma[i], tb.s1ma[i],
                temperature)
        xt = xt_next
    return xT, eps


def _decode_chain(step: _StepFn, sched, x_T, eps, generator, skip_steps, temperature):
    refine_steps = sched.num_steps - skip_steps
    if refine_steps < 1:
        raise ValueError(f"empty chain: refine_steps={refine_steps}")

    eps_full = _eps_with_fresh_tail(eps, refine_steps, x_T, generator)
    tb = _chain_tables(sched, refine_steps, refine_steps)
    bsz = x_T.shape[0]
    x = x_T
    for i in range(refine_steps):
        profiling.count("sampler.steps")
        e_t = step(i, x, _t_vec(tb.t[i], bsz, x.device))
        with (profiling.span("sampler.ddim_step") as s,
              s.device(x, profiling.SAMPLE_EVERY)):
            x, _ = steps.ddim_step(
                x, e_t, tb.a_t[i], tb.a_prev[i], tb.sigma[i], tb.s1ma[i],
                eps_full[i], temperature)
    return x


@torch.no_grad()
def dpm_encode(
    model_fn: EpsModel,
    sched: DDIMSchedule,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    white_box_steps: int,
    skip_steps: int = 0,
    temperature: float = 1.0,
    xT_noise: Optional[torch.Tensor] = None,
    posterior_noises: Optional[torch.Tensor] = None,
):
    """DPM-Encoder: recover the latent code ``z = (x_T, eps_1..eps_n)`` of x0.

    Returns ``(x_T, eps)`` with ``eps`` time-major ``(n, B, H, W, C)``.
    ``xT_noise`` (x0-shaped) and ``posterior_noises`` (eps-shaped) replace
    the draws from ``generator``.
    """
    return _encode_chain(_exact_steps(model_fn), sched, x0, generator, white_box_steps,
                         skip_steps, temperature, xT_noise, posterior_noises)


@torch.no_grad()
def dpm_encode_cached(
    model_fn_key,
    model_fn_reuse,
    sched: DDIMSchedule,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    white_box_steps: int,
    key_every: int,
    skip_steps: int = 0,
    temperature: float = 1.0,
    xT_noise: Optional[torch.Tensor] = None,
    posterior_noises: Optional[torch.Tensor] = None,
    key_steps=None,
):
    """:func:`dpm_encode` with encoder-feature caching, the fast mode's
    encode side.  The trajectory never reads the model's output, so x_T and
    every visited x_t are exact; only the eps recovered at non-key steps
    come from the decoder half on cached features.  Model functions and
    ``key_steps`` as in :func:`ddim_decode_cached`; the same draws as
    :func:`dpm_encode`."""
    n = num_recovered_eps(sched.num_steps, white_box_steps, skip_steps)
    step = _cached_steps(model_fn_key, model_fn_reuse,
                         _key_schedule(max(n, 1), key_every, key_steps))
    return _encode_chain(step, sched, x0, generator, white_box_steps, skip_steps,
                         temperature, xT_noise, posterior_noises)


@torch.no_grad()
def ddim_decode(
    model_fn: EpsModel,
    sched: DDIMSchedule,
    x_T: torch.Tensor,
    eps: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    skip_steps: int = 0,
    temperature: float = 1.0,
):
    """Replay a DDIM chain from ``x_T`` consuming stored eps per step
    (``eps`` time-major ``(n, B, H, W, C)``, or None for plain sampling);
    steps past ``n`` draw fresh noise from ``generator``.  Returns the final
    sample (x at index 0)."""
    return _decode_chain(_exact_steps(model_fn), sched, x_T, eps, generator, skip_steps,
                         temperature)


@torch.no_grad()
def ddim_decode_cached(
    model_fn_key,
    model_fn_reuse,
    sched: DDIMSchedule,
    x_T: torch.Tensor,
    eps: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    key_every: int,
    skip_steps: int = 0,
    temperature: float = 1.0,
    key_steps=None,
):
    """:func:`ddim_decode` with encoder-feature caching (Faster Diffusion,
    arXiv 2312.09608), the fast mode's decode side.

    At key steps ``model_fn_key(x, t) -> (eps, cache)`` runs the full UNet
    and keeps its encoder features; at the others ``model_fn_reuse(x, t,
    cache) -> eps`` runs the decoder half on them with the current
    timestep.  Key steps are every ``key_every``-th step (``key_every=1``:
    every step, the exact chain) unless ``key_steps`` (bools, one per step)
    says otherwise; step 0 is always one."""
    step = _cached_steps(model_fn_key, model_fn_reuse,
                         _key_schedule(max(sched.num_steps - skip_steps, 1), key_every,
                                       key_steps))
    return _decode_chain(step, sched, x_T, eps, generator, skip_steps, temperature)


@torch.no_grad()
def ddim_refine(
    model_fn: EpsModel,
    sched: DDIMSchedule,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    refine_steps: int,
    temperature: float = 1.0,
    q_noise: Optional[torch.Tensor] = None,
    chain_eps: Optional[torch.Tensor] = None,
):
    """Stochastic refinement: re-noise x0 to index ``refine_steps - 1``
    (``x_t ~ q(x_t | x0)`` at ``alphas[refine_steps - 1]``), then a plain
    DDIM decode over the last ``refine_steps`` indices at ``sched``'s eta.
    ``q_noise`` (x0-shaped) and ``chain_eps`` (time-major ``(refine_steps,
    B, H, W, C)``) replace the draws from ``generator``, in that order."""
    if not 0 < refine_steps < sched.num_steps:
        raise ValueError(f"refine_steps={refine_steps} must be in (0, {sched.num_steps})")
    if q_noise is None:
        q_noise = _randn(x0.shape, x0, generator)
    xt = steps.q_sample(x0, sched.alphas[refine_steps - 1], q_noise)
    return ddim_decode(model_fn, sched, xt, chain_eps, generator,
                       skip_steps=sched.num_steps - refine_steps, temperature=temperature)


@torch.no_grad()
def ddim_sample(
    model_fn: EpsModel,
    sched: DDIMSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 1.0,
    x_T: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
):
    """Plain DDIM generation from noise: x_T ~ N(0, I) of ``shape`` on the
    generator's device, then :func:`ddim_decode` with fresh noise at every
    step.  ``x_T`` and ``eps`` (the chain's noise, time-major ``(S,) +
    shape``) replace the draws, in that order."""
    if x_T is None:
        if generator is None:
            raise ValueError("ddim_sample draws x_T: pass x_T or a generator")
        x_T = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return ddim_decode(model_fn, sched, x_T, eps, generator, temperature=temperature)


@torch.no_grad()
def ddim_invert(model_fn: EpsModel, sched: DDIMSchedule, x0: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM inversion: walk the grid upward (index 0 to S-1)
    at eta 0, each step inverting the eta-0 step, ``x_next = sqrt(a_t)
    x0_hat + sqrt(1 - a_t) e_t`` with ``x0_hat`` predicted at ``a_prev``.
    Returns x_T."""
    bsz = x0.shape[0]
    x = x0
    for i in range(sched.num_steps):
        a_t, a_prev = sched.alphas[i], sched.alphas_prev[i]
        e_t = model_fn(x, _t_vec(int(sched.timesteps[i]), bsz, x0.device))
        x0_hat = (x - torch.sqrt(1.0 - a_prev) * e_t) / torch.sqrt(a_prev)
        x = torch.sqrt(a_t) * x0_hat + sched.sqrt_one_minus_alphas[i] * e_t
    return x


def stochastic_encode(sched: DDIMSchedule, x0: torch.Tensor, t_index: int,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SDEdit-style encode: x_t ~ q(x_t | x0) at DDIM index ``t_index``
    (no exact reconstruction); ``noise`` replaces the draw."""
    if noise is None:
        noise = _randn(x0.shape, x0, generator)
    return steps.q_sample(x0, sched.alphas[t_index], noise)


@torch.no_grad()
def stochastic_decode(model_fn: EpsModel, sched: DDIMSchedule, x_t: torch.Tensor,
                      t_start: int, generator: Optional[torch.Generator] = None, *,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode ``t_start`` steps down to index 0 with fresh noise: ``t_start``
    is a step COUNT, so the chain starts at index ``t_start - 1`` (the
    img2img recipe noises with :func:`stochastic_encode` at index ``t_enc``
    and decodes ``t_enc`` steps, as the reference does).  ``eps``
    (time-major, ``t_start`` entries) replaces the chain's draws."""
    return ddim_decode(model_fn, sched, x_t, eps, generator,
                       skip_steps=sched.num_steps - t_start)
