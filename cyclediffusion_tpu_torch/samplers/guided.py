"""Energy-guided eps-replay decoding (counterpart of
``cyclediffusion_tpu.samplers.guided``).

Each step differentiates a user energy with respect to the step's
**pred_x0** (where image-space energies live, e.g. a CLIP similarity taken
through the latent decoder) and shifts the model's eps by ``weight *
sqrt(a_t) / sqrt(1 - a_t) * dE/dpred_x0``, the shift that moves pred_x0 by
exactly ``-weight * dE/dpred_x0``.  Unlike the gradient through pred_x0 with
respect to x_t, it has no 1/sqrt(a_bar) amplification at the noisy steps.

The UNet runs under ``no_grad``: no autograd graph ever reaches it (its
attention kernels define no backward), and a core's ``apply_model`` replays
its CUDA graph there.  The energy's forward and backward run eagerly; its
autograd graph runs from a detached copy of pred_x0 and is freed when its
gradient is taken, before the next step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cyclediffusion_tpu_torch.ops import steps
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.samplers.ddim import (
    EpsModel,
    _chain_tables,
    _eps_with_fresh_tail,
    _t_vec,
)

# energy_fn(x_t, pred_x0, t) -> a scalar (summed over the batch)
EnergyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def energy_grad(energy_fn: EnergyFn, x: torch.Tensor, pred_x0: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """dE/dpred_x0 at ``pred_x0``, from a detached leaf, in grad mode
    whatever the caller's."""
    p = pred_x0.detach().requires_grad_(True)
    with torch.enable_grad():
        return torch.autograd.grad(energy_fn(x, p, t), p)[0]


@torch.no_grad()
def energy_guided_decode(
    model_fn: EpsModel,
    sched: DDIMSchedule,
    x_T: torch.Tensor,
    eps: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    energy_fn: EnergyFn,
    guidance_weight: float,
    *,
    skip_steps: int = 0,
    temperature: float = 1.0,
) -> torch.Tensor:
    """:func:`samplers.ddim_decode` with a per-step energy-gradient shift on
    the model's eps.  ``eps`` and ``generator`` as there."""
    refine_steps = sched.num_steps - skip_steps
    if refine_steps < 1:
        raise ValueError(f"empty chain: refine_steps={refine_steps}")
    eps_full = _eps_with_fresh_tail(eps, refine_steps, x_T, generator)
    tb = _chain_tables(sched, refine_steps, refine_steps)
    bsz = x_T.shape[0]
    x = x_T
    for i in range(refine_steps):
        t = _t_vec(tb.t[i], bsz, x.device)
        e_t = model_fn(x, t)
        pred_x0 = steps.pred_x0_from_eps(x, e_t, tb.a_t[i], tb.s1ma[i])
        grad = energy_grad(energy_fn, x, pred_x0, t)
        e_t = e_t + guidance_weight * (torch.sqrt(tb.a_t[i]) / tb.s1ma[i]) * grad
        x, _ = steps.ddim_step(x, e_t, tb.a_t[i], tb.a_prev[i], tb.sigma[i], tb.s1ma[i],
                               eps_full[i], temperature)
    return x
