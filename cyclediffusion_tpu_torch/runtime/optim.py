"""The training loop's optimisers, computed as optax computes them
(counterpart of the optax pieces that JAX ``Driver._build_optimizer`` chains:
``clip_by_global_norm`` then ``adamw`` or ``adafactor``, with a constant,
warmup, linear-decay or warmup-then-decay learning rate).

* :class:`AdamW` is ``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8, eps_root
  0; the update ``mu_hat / (sqrt(nu_hat) + eps) + wd * p`` is scaled by
  ``-lr``, so weight decay is ``lr * wd * p`` on the parameters before the
  step.  (``torch.optim.AdamW`` has this form but rounds its bias
  corrections in float64 and its moments by ``lerp``: it misses optax by
  more than the tests' 2e-6.)
* :class:`Adafactor` is ``optax.adafactor`` at its defaults (not
  ``torch.optim.Adafactor``'s): second moments factored over the two largest
  axes when the second largest is at least 128, decay ``1 - (t+1)^-0.8``,
  eps 1e-30 on the squared gradient, each update clipped to block RMS 1,
  scaled by the learning rate and by the parameter's RMS (at least 1e-3),
  no momentum.
* :func:`clip_by_global_norm_` scales by ``max_norm / norm`` only when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
  norm, so it differs).
* Schedules are evaluated at the step count *before* its increment, as
  optax's ``scale_by_schedule`` does; values are float32, as on the device.

The optimisers read ``p.grad``, as ``torch.optim`` optimisers do.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]

_F32 = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(_F32(value))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init`` to ``end`` over ``transition_steps``
    steps, then held."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = _F32(1) - _F32(c) / _F32(transition_steps)
        return float((_F32(init_value) - _F32(end_value)) * frac + _F32(end_value))
    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule, at the
    count less the boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out
    return schedule


def build_schedule(lr: float, warmup_steps: int = 0, max_steps: int = 0,
                   scheduler_type: str = "constant") -> Schedule:
    """The JAX driver's learning rate: ``linear`` with ``max_steps`` decays to
    0 after an optional linear warmup from 0; otherwise a warmup alone, or
    constant."""
    if scheduler_type == "linear" and max_steps > 0:
        if warmup_steps > 0:
            return join_schedules(
                [linear_schedule(0.0, lr, warmup_steps),
                 linear_schedule(lr, 0.0, max(max_steps - warmup_steps, 1))],
                [warmup_steps])
        # no warmup: full lr from the first step (a one-step warmup would
        # zero the first update)
        return linear_schedule(lr, 0.0, max_steps)
    if warmup_steps > 0:
        return linear_schedule(0.0, lr, warmup_steps)
    return constant_schedule(lr)


@torch.no_grad()
def clip_by_global_norm_(tensors: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale every tensor in place by ``max_norm / norm`` when their global
    norm is at least ``max_norm`` -> the norm (a 0-d tensor; no host sync)."""
    tensors = list(tensors)
    norm = torch.sqrt(sum(torch.sum(t * t) for t in tensors))
    keep = norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, (t / norm) * max_norm))
    return norm


def _f32_pow(base: float, exponent: float) -> float:
    return float(_F32(base) ** _F32(exponent))


# optax.adamw's defaults
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` at its defaults (see the module docstring), one
    multi-tensor op per stage; ``schedule`` maps the step count before its
    increment to the learning rate."""

    def __init__(self, params, schedule: Schedule, weight_decay: float = 1e-4):
        super().__init__(params, {})
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(_F32(1) - _F32(_f32_pow(B1, self.count)))
        bc2 = float(_F32(1) - _F32(_f32_pow(B2, self.count)))
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            gs = [p.grad for p in ps]
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            # mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mus, B1)
            torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - B1))
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(g2, 1 - B2)
            torch._foreach_mul_(nus, B2)
            torch._foreach_add_(nus, g2)
            del g2          # at most two parameter-sized temporaries at a time
            # p <- p - lr (mu_hat / (sqrt(nu_hat) + eps) + wd p)
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            u = torch._foreach_div(mus, bc1)
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(ps, u)


# optax.adafactor's defaults
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
ADAFACTOR_EPS = 1e-30
MIN_SCALE = 1e-3


def factored_dims(shape) -> Optional[tuple]:
    """optax's ``_factored_dims``: (second largest axis, largest axis), or
    None when there are fewer than two axes or the second largest is below
    ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` at optax's defaults (see the module docstring)."""

    def __init__(self, params, schedule: Schedule):
        super().__init__(params, {})
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.schedule(self.count)
        decay = float(_F32(1) - _F32(_f32_pow(self.count + 1, -DECAY_RATE)))
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                dims = factored_dims(tuple(p.shape))
                gsq = g * g + ADAFACTOR_EPS
                if dims is not None:
                    d1, d0 = dims
                    if not state:
                        state["v_row"] = torch.zeros_like(gsq.mean(d0))
                        state["v_col"] = torch.zeros_like(gsq.mean(d1))
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.copy_(decay * v_row + (1.0 - decay) * gsq.mean(d0))
                    v_col.copy_(decay * v_col + (1.0 - decay) * gsq.mean(d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
                    u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                else:
                    if not state:
                        state["v"] = torch.zeros_like(p)
                    v = state["v"]
                    v.copy_(decay * v + (1.0 - decay) * gsq)
                    u = g * v ** -0.5
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / CLIPPING_THRESHOLD, min=1.0)
                u = u * lr * torch.clamp(torch.sqrt(torch.mean(p * p)), min=MIN_SCALE)
                p.add_(-u)
        self.count += 1


def build_optimizer(params: List[torch.Tensor], name: str, schedule: Schedule,
                    weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """``"adafactor"`` or, for any other name, AdamW (the JAX driver's
    choice)."""
    if name == "adafactor":
        return Adafactor(params, schedule)
    return AdamW(params, schedule, weight_decay=weight_decay)
