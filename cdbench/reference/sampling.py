"""The DDIM schedule, the DPM-Encoder, the eps replay and classifier-free
guidance, written from CycleDiffusion's and CompVis's ``DDIMSampler``
equations, and the hashed tokenizer the cells' prompts go through.

The eps model is a model family's ``eps`` bound to its configuration and
parts, ``eps(x, t, cond)``, and a conditioning is whatever the family's
``condition`` gives: a tensor, or a dict, list or tuple of them, each
leaf's rows the batch's.  The sampler only stacks and repeats its rows.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


class Schedule:
    """Linear betas over ``T`` DDPM steps, sub-sampled onto ``steps`` uniform
    DDIM steps (timesteps ``range(0, T, T // steps) + 1``); float32 tables."""

    def __init__(self, linear_start: float, linear_end: float, timesteps: int, steps: int,
                 eta: float):
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                            dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        ts = np.arange(0, timesteps, timesteps // steps)[:steps] + 1
        a = ac[ts]
        a_prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
        sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
        self.steps = steps
        self.t = ts.astype(np.int64)
        self.a, self.a_prev, self.sigma = (torch.tensor(v, dtype=torch.float32)
                                           for v in (a, a_prev, sigma))


def _coefs(s: Schedule, index: int):
    a, ap, sg = s.a[index], s.a_prev[index], s.sigma[index]
    return a, ap, sg, torch.sqrt(torch.clamp(1.0 - ap - sg ** 2, min=0.0))


def q_sample(x0, a, noise):
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def posterior_step(s: Schedule, index: int, x0, xt, noise):
    """x_{t-1} ~ q(x_{t-1} | x_t, x_0) on the DDIM grid; x0 itself at index 0."""
    if index == 0:
        return x0
    a, ap, sg, dcoef = _coefs(s, index)
    e = (xt - torch.sqrt(a) * x0) / torch.sqrt(1.0 - a)
    return torch.sqrt(ap) * x0 + dcoef * e + sg * noise


def _mean(s: Schedule, index: int, x, e):
    a, ap, sg, dcoef = _coefs(s, index)
    pred_x0 = (x - torch.sqrt(1.0 - a) * e) / torch.sqrt(a)
    return torch.sqrt(ap) * pred_x0 + dcoef * e, sg


def recover_eps(s: Schedule, index: int, xt, xt_next, e):
    mean, sg = _mean(s, index, xt, e)
    return (xt_next - mean) / sg


def replay_step(s: Schedule, index: int, x, e, noise):
    mean, sg = _mean(s, index, x, e)
    return mean + sg * noise


def leaves(cond) -> list:
    """[(path, tensor)] of a conditioning's tensors, a dict's keys in sorted
    order."""
    if torch.is_tensor(cond):
        return [((), cond)]
    if isinstance(cond, dict):
        items = [(k, cond[k]) for k in sorted(cond)]
    elif isinstance(cond, (list, tuple)):
        items = list(enumerate(cond))
    else:
        raise TypeError(f"not a conditioning: {type(cond).__name__}")
    return [((k,) + path, t) for k, sub in items for path, t in leaves(sub)]


def map_leaves(fn, *conds):
    """``fn`` over the matching tensors of conditionings of one structure."""
    first = conds[0]
    if torch.is_tensor(first):
        return fn(*conds)
    if isinstance(first, dict):
        return {k: map_leaves(fn, *(c[k] for c in conds)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(map_leaves(fn, *subs) for subs in zip(*conds))
    raise TypeError(f"not a conditioning: {type(first).__name__}")


def cat_rows(a, b):
    """The rows of ``a`` then those of ``b``, leaf by leaf."""
    return map_leaves(lambda u, v: torch.cat([u, v]), a, b)


def repeat_rows(cond, k: int):
    """The whole batch ``k`` times over, leaf by leaf."""
    return map_leaves(lambda u: u.repeat(k, *(1,) * (u.dim() - 1)), cond)


def guided_eps(eps_model, x, t: int, uncond, cond, scale):
    """e_u + scale (e_c - e_u) from one call of ``eps_model`` on the
    [uncond; cond] batch; ``scale`` a number or a (B,) tensor."""
    b = x.shape[0]
    tt = torch.full((2 * b,), t, dtype=torch.int64, device=x.device)
    out = eps_model(torch.cat([x, x]), tt, cat_rows(uncond, cond))
    e_u, e_c = out.chunk(2)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)
    return e_u + scale * (e_c - e_u)


def dpm_encode(s: Schedule, eps_model, x0, uncond, cond, scale, skip: int, xT_noise,
               post_noises):
    """-> (x_T, eps (n, B, h, w, c)) over the chain's ``steps - skip`` steps."""
    refine = s.steps - skip
    xt = q_sample(x0, s.a[refine - 1], xT_noise)
    x_T, eps = xt, []
    for i in range(refine):
        index = refine - 1 - i
        nxt = posterior_step(s, index, x0, xt, post_noises[i])
        e = guided_eps(eps_model, xt, int(s.t[index]), uncond, cond, scale)
        eps.append(recover_eps(s, index, xt, nxt, e))
        xt = nxt
    return x_T, torch.stack(eps)


def hash_tokens(texts, vocab_size: int, context_length: int) -> np.ndarray:
    """Each lower-cased, whitespace-split word -> ``crc32 % (V - 3) + 1``,
    between the start (V - 2) and end (V - 1) ids, zero-padded."""
    out = np.zeros((len(texts), context_length), dtype=np.int64)
    for i, text in enumerate(texts):
        words = " ".join(text.split()).strip().lower().split()
        ids = ([vocab_size - 2]
               + [zlib.crc32(w.encode()) % (vocab_size - 3) + 1 for w in words][:context_length - 2]
               + [vocab_size - 1])
        out[i, :len(ids)] = ids
    return out
