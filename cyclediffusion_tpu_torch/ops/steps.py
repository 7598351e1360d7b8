"""Per-step posterior / sampling / eps-recovery math of both diffusion
families (counterpart of ``cyclediffusion_tpu.ops.steps``): the latent DDIM
steps on index tables, and the pixel DDPM / eta-DDIM steps on
``(t, t_next)`` tables whose ``-1`` sentinel the caller has already turned
into alpha_bar_next = 1.

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


# ---- pixel family ------------------------------------------------------------ #

def split_model_output(et: torch.Tensor, channels: int):
    """A model output -> ``(eps, var_values)``: a 2C learn-sigma output is
    split in halves on the channel axis, the last (the UNets' public layout
    is NHWC); an output of ``channels`` channels is eps itself, with
    ``None``."""
    if et.shape[-1] == channels:
        return et, None
    eps, var = torch.chunk(et, 2, dim=-1)
    return eps, var


def learned_logvar(model_var_values, bt, at, at_next, ndim: int) -> torch.Tensor:
    """improved-DDPM's interpolated log-variance."""
    bt, at, at_next = (bcast(c, ndim) for c in (bt, at, at_next))
    posterior_variance = bt * (1.0 - at_next) / (1.0 - at)
    min_log = torch.log(torch.clamp(posterior_variance, min=1e-6))
    max_log = torch.log(bt)
    frac = (model_var_values + 1.0) / 2.0
    return frac * max_log + (1.0 - frac) * min_log


def _logvar_b(logvar, ndim: int):
    """A scalar or (B,) log-variance broadcast; a learned one is full-shape."""
    logvar = torch.as_tensor(logvar)
    return bcast(logvar, ndim) if logvar.ndim <= 1 else logvar


def _ddpm_mean(xt, et, bt_b, at_b):
    weight = bt_b / torch.sqrt(1.0 - at_b)
    return (xt - weight * et) / torch.sqrt(1.0 - bt_b)


def pixel_ddpm_step(xt, et, bt, at, logvar, noise, t_is_zero: bool) -> torch.Tensor:
    """Ancestral DDPM step: ``mean + exp(logvar / 2) * noise``, no noise at
    t = 0."""
    nd = xt.ndim
    mean = _ddpm_mean(xt, et, bcast(bt, nd), bcast(at, nd))
    if t_is_zero:
        return mean
    return mean + torch.exp(0.5 * _logvar_b(logvar, nd)) * noise


def _ddim_coefs(at_b, at_next_b, eta):
    """(c1, c2) of the eta-DDIM step, radicands clamped at 0."""
    c1 = eta * torch.sqrt(torch.clamp(
        (1.0 - at_b / at_next_b) * (1.0 - at_next_b) / (1.0 - at_b), min=0.0))
    c2 = torch.sqrt(torch.clamp((1.0 - at_next_b) - c1 ** 2, min=0.0))
    return c1, c2


def pixel_ddim_step(xt, et, at, at_next, eta, noise):
    """eta-DDIM step -> ``(xt_next, x0_t)``."""
    nd = xt.ndim
    at_b, at_next_b = bcast(at, nd), bcast(at_next, nd)
    x0_t = (xt - et * torch.sqrt(1.0 - at_b)) / torch.sqrt(at_b)
    c1, c2 = _ddim_coefs(at_b, at_next_b, eta)
    return torch.sqrt(at_next_b) * x0_t + c2 * et + c1 * noise, x0_t


def pixel_compute_eps_ddpm(xt, xt_next, et, bt, at, logvar) -> torch.Tensor:
    """The noise the DDPM step needs for xt -> xt_next: ``(xt_next - mean) /
    exp(logvar / 2)``."""
    nd = xt.ndim
    mean = _ddpm_mean(xt, et, bcast(bt, nd), bcast(at, nd))
    return (xt_next - mean) / torch.exp(0.5 * _logvar_b(logvar, nd))


def pixel_compute_eps_ddim(xt, xt_next, et, at, at_next, eta) -> torch.Tensor:
    """The noise the eta-DDIM step needs for xt -> xt_next: ``(xt_next -
    sqrt(at_next) x0_t - c2 et) / c1``."""
    nd = xt.ndim
    at_b, at_next_b = bcast(at, nd), bcast(at_next, nd)
    x0_t = (xt - et * torch.sqrt(1.0 - at_b)) / torch.sqrt(at_b)
    c1, c2 = _ddim_coefs(at_b, at_next_b, eta)
    return (xt_next - torch.sqrt(at_next_b) * x0_t - c2 * et) / c1


def pixel_sample_xt_next_ddpm(x0, xt, bt, at, at_next, noise) -> torch.Tensor:
    """The exact DDPM posterior draw q(x_{t_next} | x_t, x_0)."""
    nd = x0.ndim
    bt_b, at_b, at_next_b = bcast(bt, nd), bcast(at, nd), bcast(at_next, nd)
    w0 = torch.sqrt(at_next_b) * bt_b / (1.0 - at_b)
    wt = torch.sqrt(1.0 - bt_b) * (1.0 - at_next_b) / (1.0 - at_b)
    var = bt_b * (1.0 - at_next_b) / (1.0 - at_b)
    return w0 * x0 + wt * xt + torch.sqrt(var) * noise


def pixel_sample_xt_next_ddim(x0, xt, at, at_next, eta, noise) -> torch.Tensor:
    """The eta-DDIM posterior draw given (x0, xt)."""
    nd = x0.ndim
    at_b, at_next_b = bcast(at, nd), bcast(at_next, nd)
    et = (xt - torch.sqrt(at_b) * x0) / torch.sqrt(1.0 - at_b)
    c1 = eta * torch.sqrt((1.0 - at_b / at_next_b) * (1.0 - at_next_b) / (1.0 - at_b))
    c2 = torch.sqrt(torch.clamp((1.0 - at_next_b) - c1 ** 2, min=0.0))
    return torch.sqrt(at_next_b) * x0 + c2 * et + c1 * noise
