"""Per-step DDIM posterior / sampling / eps-recovery math (counterpart of
``cyclediffusion_tpu.ops.steps``, latent family).

Coefficients may be 0-d tensors (per-step scalars from the schedule tables,
kept on the CPU so they broadcast against device tensors as scalars) or
``(B,)`` tensors; :func:`bcast` aligns them with a ``(B, ...)`` tensor.  All
math is float32.
"""

from __future__ import annotations

import torch


def bcast(coef, ndim: int) -> torch.Tensor:
    """Reshape a scalar or (B,) coefficient to broadcast against an
    ndim-dimensional tensor."""
    coef = torch.as_tensor(coef)
    if coef.ndim == 0:
        return coef
    return coef.reshape(coef.shape + (1,) * (ndim - 1))


def q_sample(x0: torch.Tensor, a_bar, noise: torch.Tensor) -> torch.Tensor:
    """x_t ~ q(x_t | x_0) = sqrt(a_bar) x0 + sqrt(1 - a_bar) eps."""
    a = bcast(a_bar, x0.ndim)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def pred_x0_from_eps(x, e_t, a_t, sqrt_one_minus_at) -> torch.Tensor:
    """x0-hat = (x_t - sqrt(1-a_t) eps) / sqrt(a_t)."""
    a_t = bcast(a_t, x.ndim)
    s = bcast(sqrt_one_minus_at, x.ndim)
    return (x - s * e_t) / torch.sqrt(a_t)


def _dir_coef(a_prev_b, sigma_b):
    return torch.sqrt(torch.clamp(1.0 - a_prev_b - sigma_b ** 2, min=0.0))


def ddim_step(x, e_t, a_t, a_prev, sigma_t, sqrt_one_minus_at, noise,
              temperature: float = 1.0):
    """One reverse DDIM step: x_{t-1} = sqrt(a_prev) x0-hat + dir_xt + sigma
    * noise.  With ``noise`` a stored latent-code eps this is the replay step.
    Returns (x_prev, pred_x0)."""
    nd = x.ndim
    a_prev_b = bcast(a_prev, nd)
    sigma_b = bcast(sigma_t, nd)
    pred_x0 = pred_x0_from_eps(x, e_t, a_t, sqrt_one_minus_at)
    dir_xt = _dir_coef(a_prev_b, sigma_b) * e_t
    x_prev = torch.sqrt(a_prev_b) * pred_x0 + dir_xt + sigma_b * noise * temperature
    return x_prev, pred_x0


def compute_eps(xt, xt_next, e_t, a_t, a_prev, sigma_t, sqrt_one_minus_at,
                temperature: float = 1.0) -> torch.Tensor:
    """Recover the eps the DDIM sampler would need to step xt -> xt_next."""
    nd = xt.ndim
    a_prev_b = bcast(a_prev, nd)
    sigma_b = bcast(sigma_t, nd)
    pred_x0 = pred_x0_from_eps(xt, e_t, a_t, sqrt_one_minus_at)
    dir_xt = _dir_coef(a_prev_b, sigma_b) * e_t
    return (xt_next - torch.sqrt(a_prev_b) * pred_x0 - dir_xt) / sigma_b / temperature


def sample_xt_next(x0, xt, a_t, a_prev, sigma_t, noise,
                   index_is_zero: bool) -> torch.Tensor:
    """Sample x_{t-1} ~ q_eta(x_{t-1} | x_t, x_0) on the DDIM grid; at index
    0 the result is x0 exactly."""
    if index_is_zero:
        return x0
    nd = x0.ndim
    a_t_b = bcast(a_t, nd)
    a_prev_b = bcast(a_prev, nd)
    sigma_b = bcast(sigma_t, nd)
    e_t = (xt - torch.sqrt(a_t_b) * x0) / torch.sqrt(1.0 - a_t_b)
    dir_xt = _dir_coef(a_prev_b, sigma_b) * e_t
    return torch.sqrt(a_prev_b) * x0 + dir_xt + sigma_b * noise
