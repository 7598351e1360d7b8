"""Gumbel-max and top-down Gumbel sampling (counterpart of
``cyclediffusion_tpu.ops.gumbel``; the reference's ``utils/dist_utils.py``,
unused by its current code path but part of its utility surface).

Each sampler draws its uniforms from an explicit ``torch.Generator`` on the
logits' device and hands them to a ``*_from_uniform`` function, which holds
the arithmetic; tests give both packages the same uniforms there.
"""

from __future__ import annotations

from typing import Optional

import torch


def _uniform(shape, generator: Optional[torch.Generator], device, eps: float):
    """U[eps, 1) draws, as ``jax.random.uniform(key, shape, minval=eps)``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return torch.clamp(eps + u * (1.0 - eps), min=eps)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Uniform draws in (0, 1) -> standard Gumbel draws, -log(-log u)."""
    return -torch.log(-torch.log(u))


def sample_gumbel(shape, generator: Optional[torch.Generator] = None, device="cpu",
                  eps: float = 1e-20) -> torch.Tensor:
    return gumbel_from_uniform(_uniform(shape, generator, device, eps))


def gumbel_max_from_uniform(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """argmax(logits + Gumbel(u)) over the last axis -> int64 indices."""
    return torch.argmax(logits + gumbel_from_uniform(u), dim=-1)


def gumbel_max_sample(logits: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A categorical sample via argmax(logits + Gumbel noise) -> indices."""
    return gumbel_max_from_uniform(logits, _uniform(logits.shape, generator,
                                                    logits.device, 1e-20))


def gumbel_with_maximum_from_uniform(logits: torch.Tensor, argmax_index: torch.Tensor,
                                     u_max: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Top-down Gumbels whose argmax is ``argmax_index``: the maximum
    ``T = Gumbel(u_max) + logsumexp(logits)`` at the target, every other
    position ``g = Gumbel(u) + logits`` truncated below T as
    ``-log(exp(-g) + exp(-T))`` in the stable form ``min(g, T) -
    log1p(exp(-|g - T|))``, finite for any g (a free Gumbel may exceed
    the drawn maximum; forms that assume g <= T give NaN there).
    ``u_max`` has the logits' shape with a last axis of 1."""
    n = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    g_max = gumbel_from_uniform(u_max) + lse
    g = gumbel_from_uniform(u) + logits
    truncated = torch.minimum(g, g_max) - torch.log1p(torch.exp(-torch.abs(g - g_max)))
    onehot = torch.nn.functional.one_hot(argmax_index.long(), n).bool()
    return torch.where(onehot, g_max.expand_as(logits), truncated)


def gumbel_with_maximum(logits: torch.Tensor, argmax_index: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`gumbel_with_maximum_from_uniform` on fresh uniforms: the
    maximum's first, then the other positions'."""
    u_max = _uniform(logits.shape[:-1] + (1,), generator, logits.device, 1e-20)
    u = _uniform(logits.shape, generator, logits.device, 1e-20)
    return gumbel_with_maximum_from_uniform(logits, argmax_index, u_max, u)
