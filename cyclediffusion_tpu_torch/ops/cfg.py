"""Classifier-free guidance as one dual-batch model call (counterpart of
``cyclediffusion_tpu.ops.cfg``).

scale == 1 -> conditional only, scale == 0 -> unconditional only, otherwise
one model call on the concatenated ``[uncond; cond]`` batch followed by the
guidance combine.  A Python-number scale takes the 0/1 shortcuts; a tensor
scale (per-candidate sweeps) always runs the dual batch, whose combine is
exact for 0 and 1 too.  :func:`cfg_model_fn_pair` is the same for the
encoder-caching fast mode.  The dual batch and the combine are
``sampler.cfg_dual`` and ``sampler.cfg_combine`` spans
(``runtime.profiling``).

A conditioning is one tensor (SD v1's and LDM's text context) or a dict of
tensors whose rows are the batch's (SDXL's ``{"context", "vector"}``):
:func:`cat_rows` and :func:`repeat_rows` handle it leaf by leaf, and on a
plain tensor are the one ``torch.cat`` or ``repeat`` they stand for.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from cyclediffusion_tpu_torch.runtime import profiling

# model_fn(x, t, cond) -> eps
ModelFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def map_rows(fn: Callable, *conds):
    """``fn`` over the matching tensors of conditionings of one structure."""
    first = conds[0]
    if isinstance(first, dict):
        return {k: map_rows(fn, *(c[k] for c in conds)) for k in first}
    return fn(*conds)


def cat_rows(a, b):
    """The rows of conditioning ``a`` then those of ``b``."""
    return map_rows(lambda u, v: torch.cat([u, v], dim=0), a, b)


def repeat_rows(cond, k: int):
    """The whole batch of a conditioning ``k`` times over."""
    return map_rows(lambda u: u.repeat(k, *(1,) * (u.dim() - 1)), cond)


def _is_static(scale) -> bool:
    return isinstance(scale, (int, float))


def dual_batch_inputs(x, t):
    """Duplicate (x, t) into the [uncond; cond] dual batch."""
    with (profiling.span("sampler.cfg_dual") as s,
          s.device(x, profiling.SAMPLE_EVERY)):
        return torch.cat([x, x], dim=0), torch.cat([t, t], dim=0)


def make_cfg_combine(uncond, cond, scale):
    """-> (c_in, combine): the [uncond; cond] context batch and the guidance
    combine ``e_uc + scale * (e_c - e_uc)`` over a dual-batch output."""
    c_in = cat_rows(uncond, cond)

    def combine(out):
        with (profiling.span("sampler.cfg_combine") as s,
              s.device(out, profiling.SAMPLE_EVERY)):
            e_uncond, e_cond = torch.chunk(out, 2, dim=0)
            return e_uncond + scale * (e_cond - e_uncond)

    return c_in, combine


def cfg_model_fn(model_fn: ModelFn, uncond, cond, scale) -> Callable:
    """Wrap ``model_fn`` into a guidance-scaled eps predictor ``fn(x, t)``."""
    if uncond is None or (_is_static(scale) and scale == 1.0):
        def fn(x, t):
            return model_fn(x, t, cond)
    elif _is_static(scale) and scale == 0.0:
        def fn(x, t):
            return model_fn(x, t, uncond)
    else:
        c_in, combine = make_cfg_combine(uncond, cond, scale)

        def fn(x, t):
            x_in, t_in = dual_batch_inputs(x, t)
            return combine(model_fn(x_in, t_in, c_in))
    return fn


def cfg_model_fn_pair(model_fn, uncond, cond, scale):
    """CFG wrappers for the encoder-caching fast mode.

    ``model_fn(x, t, cond, encoder_cache) -> (eps, cache)`` (the UNet called
    with ``return_cache=True``).  Returns ``(key_fn, reuse_fn)`` for the
    cached samplers: ``key_fn(x, t) -> (eps, cache)`` runs the full net,
    ``reuse_fn(x, t, cache) -> eps`` the decoder half on the cached
    features.  With guidance the cache holds the dual ``[uncond; cond]``
    batch, so each branch reuses its own features; the 0/1 shortcuts and
    ``uncond is None`` run single-batch, as :func:`cfg_model_fn` does."""
    if uncond is None or (_is_static(scale) and scale == 1.0):
        single = cond
    elif _is_static(scale) and scale == 0.0:
        single = uncond
    else:
        c_in, combine = make_cfg_combine(uncond, cond, scale)

        def key_fn(x, t):
            x_in, t_in = dual_batch_inputs(x, t)
            out, cache = model_fn(x_in, t_in, c_in, None)
            return combine(out), cache

        def reuse_fn(x, t, cache):
            x_in, t_in = dual_batch_inputs(x, t)
            return combine(model_fn(x_in, t_in, c_in, cache)[0])
        return key_fn, reuse_fn

    def key_fn(x, t):
        return model_fn(x, t, single, None)

    def reuse_fn(x, t, cache):
        return model_fn(x, t, single, cache)[0]
    return key_fn, reuse_fn
