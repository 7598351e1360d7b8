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
its CUDA graph there.  The energy's gradient is taken from a detached copy
of pred_x0, and its autograd graph is freed when the gradient is taken,
before the next step.  On a CUDA device its forward and backward replay one
CUDA graph (:class:`GraphedEnergy`, ``runtime.graphs.GraphedGrad``), as
JAX's ``jax.grad`` sits inside the chain's compiled scan; on the CPU the
gradient is :func:`energy_grad`.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Optional

import torch

from cyclediffusion_tpu_torch.ops import steps
from cyclediffusion_tpu_torch.ops.schedule import DDIMSchedule
from cyclediffusion_tpu_torch.runtime import graphs
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
    return graphs.input_grad(energy_fn, 1, x, pred_x0, t)


def _with_setting(fn: EnergyFn, x_t, pred_x0, t, setting):
    return fn(x_t, pred_x0, t)


class GraphedEnergy:
    """An energy with its gradient dE/dpred_x0 replayed as a CUDA graph on
    the card: :meth:`grad` captures the forward and backward at its first
    call per signature of ``(x_t, pred_x0, t)``; :meth:`grad_eager` is
    :func:`energy_grad`.  The graph lives on this object, so that what the
    energy closes over (its models, its target text feature) is fixed for
    the graph's life: a new prompt makes a new energy, and so a new graph,
    in a pool of its own that goes with it.  ``setting()``, where given,
    returns what else ``fn`` reads that may change between calls (a core's
    tiling of its first stage): it is part of the graph's signature, so
    another setting is another graph.  Calling it is calling ``fn``."""

    def __init__(self, fn: EnergyFn, setting: Optional[Callable[[], object]] = None):
        self.fn = fn
        self.setting = setting
        self._graphed_grad = graphs.GraphedGrad(functools.partial(_with_setting, fn), 1)

    def __call__(self, x_t, pred_x0, t):
        return self.fn(x_t, pred_x0, t)

    def grad(self, x_t, pred_x0, t) -> torch.Tensor:
        setting = None if self.setting is None else self.setting()
        return self._graphed_grad(x_t, pred_x0, t, setting)

    def grad_eager(self, x_t, pred_x0, t) -> torch.Tensor:
        return energy_grad(self.fn, x_t, pred_x0, t)


# a plain energy -> its GraphedEnergy, which holds it weakly: the entry goes
# when the energy does, and with it the graph and its pool
_GRAPHED: "weakref.WeakKeyDictionary[Callable, GraphedEnergy]" = weakref.WeakKeyDictionary()


def graphed_energy(energy_fn: EnergyFn) -> GraphedEnergy:
    """``energy_fn`` if it is a :class:`GraphedEnergy`, else the one kept for
    it, made at its first chain: a later chain with the same callable
    replays the graphs the first one captured.  The callable must take a
    weak reference (a function, a lambda, a ``functools.partial``)."""
    if isinstance(energy_fn, GraphedEnergy):
        return energy_fn
    energy = _GRAPHED.get(energy_fn)
    if energy is None:
        energy = _GRAPHED[energy_fn] = GraphedEnergy(weakref.proxy(energy_fn))
    return energy


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
    the model's eps.  ``eps`` and ``generator`` as there.  The gradient is
    ``energy_fn.grad`` of a :class:`GraphedEnergy` (its graph kept across
    chains); any other energy gets one (:func:`graphed_energy`), kept for
    its next chain."""
    energy = graphed_energy(energy_fn)
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
        grad = energy.grad(x, pred_x0, t)
        e_t = e_t + guidance_weight * (torch.sqrt(tb.a_t[i]) / tb.s1ma[i]) * grad
        x, _ = steps.ddim_step(x, e_t, tb.a_t[i], tb.a_prev[i], tb.sigma[i], tb.s1ma[i],
                               eps_full[i], temperature)
    return x
