"""Pixel-space DDPM / eta-DDIM sampler: the DPM-Encoder and the eps replay
with its refine (counterpart of ``cyclediffusion_tpu.samplers.pixel``).

* :func:`pixel_encode` draws ``x_T ~ q(x_T | x0)`` at the raw timestep
  ``es_steps - 1`` (the reference's choice, which is ``seq[-1]`` only on
  the dense grid), then walks the posterior down the ``(seq, seq_next)``
  grid and recovers the eps of each of the first ``es_steps - 1`` steps.
* :func:`pixel_generate` replays the chain on the stored eps; its last step
  draws fresh noise.  Then ``refine_iterations`` times: re-noise to the raw
  timestep ``refine_steps - 1`` and denoise ``seq[:refine_steps]`` at
  eta = 1 with fresh noise, whatever the chain's eta.

The improved-DDPM UNets emit 2C channels; with ``learn_sigma=False`` (the
zoo's setting) the variance half is dropped and the fixed log-variance
table is used, with ``learn_sigma=True`` it sets the interpolated
log-variance of the DDPM steps.  Each ``lax.scan`` of the JAX module is a
Python loop of UNet calls; the per-step coefficients are 0-d fp32 CPU
tensors.  Draws come from one ``torch.Generator`` in this order: the
encode's x_T noise and posterior noises; the replay's last-step noise, then
per refine iteration its re-noise draw and its chain's draws.  Each can be
given instead (the ``*_noise(s)`` seams).  Layout NHWC; the eps stack is
time-major ``(es_steps - 1, B, H, W, C)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cyclediffusion_tpu_torch.ops import steps
from cyclediffusion_tpu_torch.ops.schedule import PixelSchedule

# fn(x: (B,H,W,C) fp32, t: (B,) int64) -> (B,H,W,C) or learn-sigma (B,H,W,2C) fp32
PixelModel = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class _PixelTables(NamedTuple):
    """Time-major coefficients for walking ``zip(reversed(seq),
    reversed(seq_next))``."""

    t: list                 # raw timesteps (ints)
    bt: torch.Tensor        # (L,) fp32
    at: torch.Tensor        # (L,)
    at_next: torch.Tensor   # (L,), alpha_bar(-1) = 1
    logvar: torch.Tensor    # (L,) the fixed log-variance at t
    t_is_zero: list         # bools


def _pixel_tables(ps: PixelSchedule, seq, seq_next) -> _PixelTables:
    t = torch.from_numpy(np.asarray(seq, np.int64)[::-1].copy())
    t_next = torch.from_numpy(np.asarray(seq_next, np.int64)[::-1].copy())
    return _PixelTables(t=[int(x) for x in t], bt=ps.betas[t], at=ps.alphas_cumprod[t],
                        at_next=ps.a_bar(t_next), logvar=ps.logvar[t],
                        t_is_zero=[int(x) == 0 for x in t])


def _randn(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _model_eps(model_fn: PixelModel, x, t: int, learn_sigma: bool):
    """-> (eps, the variance values or None)."""
    t_vec = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    et, var_values = steps.split_model_output(model_fn(x, t_vec), channels=x.shape[-1])
    if learn_sigma and var_values is None:
        raise ValueError("learn_sigma needs a model output of 2C channels")
    return et, var_values if learn_sigma else None


def _logvar(tb: _PixelTables, i: int, var_values, ndim: int):
    if var_values is not None:
        return steps.learned_logvar(var_values, tb.bt[i], tb.at[i], tb.at_next[i], ndim)
    return tb.logvar[i]


def _check_sample_type(sample_type: str, eta) -> None:
    if sample_type == "ddim":
        if eta is None or eta <= 0:
            raise ValueError("the eta-DDIM DPM-Encoder needs eta > 0 (it divides by c1)")
    elif sample_type != "ddpm":
        raise ValueError(f"sample_type {sample_type!r}: ddim or ddpm")


@torch.no_grad()
def pixel_encode(model_fn: PixelModel, ps: PixelSchedule, seq, seq_next, x0: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *, sample_type: str = "ddim",
                 eta: Optional[float] = None, learn_sigma: bool = False,
                 xT_timestep: Optional[int] = None, xT_noise=None, posterior_noises=None):
    """The pixel DPM-Encoder -> ``(x_T, eps)``, eps ``(es - 1, B, H, W, C)``
    with ``es = len(seq)``.  ``xT_timestep`` defaults to ``es - 1``."""
    _check_sample_type(sample_type, eta)
    n = len(seq) - 1
    if xT_timestep is None:
        xT_timestep = n
    if xT_noise is None:
        xT_noise = _randn(x0.shape, x0, generator)
    xT = steps.q_sample(x0, ps.alphas_cumprod[xT_timestep], xT_noise)
    if posterior_noises is None:
        posterior_noises = _randn((n,) + tuple(x0.shape), x0, generator)

    tb = _pixel_tables(ps, seq, seq_next)
    eps = torch.empty((n,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    xt = xT
    for i in range(n):
        if sample_type == "ddpm":
            xt_next = steps.pixel_sample_xt_next_ddpm(x0, xt, tb.bt[i], tb.at[i],
                                                      tb.at_next[i], posterior_noises[i])
        else:
            xt_next = steps.pixel_sample_xt_next_ddim(x0, xt, tb.at[i], tb.at_next[i], eta,
                                                      posterior_noises[i])
        et, var_values = _model_eps(model_fn, xt, tb.t[i], learn_sigma)
        if sample_type == "ddpm":
            eps[i] = steps.pixel_compute_eps_ddpm(
                xt, xt_next, et, tb.bt[i], tb.at[i], _logvar(tb, i, var_values, xt.ndim))
        else:
            eps[i] = steps.pixel_compute_eps_ddim(xt, xt_next, et, tb.at[i], tb.at_next[i],
                                                  eta)
        xt = xt_next
    return xT, eps


def _denoise_chain(model_fn: PixelModel, tb: _PixelTables, x, noise_at, *,
                   sample_type: str, eta, learn_sigma: bool):
    """Walk ``tb``, step i taking ``noise_at(i)`` as its noise."""
    for i, t in enumerate(tb.t):
        et, var_values = _model_eps(model_fn, x, t, learn_sigma)
        if sample_type == "ddpm":
            x = steps.pixel_ddpm_step(x, et, tb.bt[i], tb.at[i],
                                      _logvar(tb, i, var_values, x.ndim), noise_at(i),
                                      tb.t_is_zero[i])
        else:
            x, _ = steps.pixel_ddim_step(x, et, tb.at[i], tb.at_next[i], eta, noise_at(i))
    return x


@torch.no_grad()
def pixel_generate(model_fn: PixelModel, ps: PixelSchedule, seq, seq_next,
                   x_T: torch.Tensor, eps: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *, sample_type: str = "ddim",
                   eta: Optional[float] = None, learn_sigma: bool = False,
                   refine_steps: int = 0, refine_iterations: int = 1, final_noise=None,
                   refine_q_noises=None, refine_chain_noises=None) -> torch.Tensor:
    """Replay the chain on ``eps`` (time-major ``(es - 1, B, H, W, C)``),
    then refine.  Seams: ``final_noise`` the last replay step's draw,
    ``refine_q_noises`` ``(refine_iterations, B, H, W, C)`` the re-noise
    draws, ``refine_chain_noises`` ``(refine_iterations, refine_steps, B,
    H, W, C)`` the refine chains' draws."""
    if sample_type == "ddim" and eta is None:
        raise ValueError("eta-DDIM needs eta")
    n = len(seq) - 1
    if eps.shape[0] != n:
        raise ValueError(f"{eps.shape[0]} eps for a {len(seq)}-step grid, expected {n}")
    if refine_steps and not 0 < refine_steps < len(seq):
        raise ValueError(f"refine_steps={refine_steps} is not below the grid's {len(seq)}")
    if final_noise is None:
        final_noise = _randn(x_T.shape, x_T, generator)
    x = _denoise_chain(model_fn, _pixel_tables(ps, seq, seq_next), x_T,
                       lambda i: eps[i] if i < n else final_noise,
                       sample_type=sample_type, eta=eta, learn_sigma=learn_sigma)
    if refine_steps > 0:
        r_tables = _pixel_tables(ps, seq[:refine_steps], seq_next[:refine_steps])
        for r in range(refine_iterations):
            q_noise = (refine_q_noises[r] if refine_q_noises is not None
                       else _randn(x.shape, x, generator))
            xt = steps.q_sample(x, ps.alphas_cumprod[refine_steps - 1], q_noise)
            fresh = (refine_chain_noises[r] if refine_chain_noises is not None
                     else _randn((refine_steps,) + tuple(x.shape), x, generator))
            x = _denoise_chain(model_fn, r_tables, xt, lambda i: fresh[i],
                               sample_type=sample_type, eta=1.0, learn_sigma=learn_sigma)
    return x
