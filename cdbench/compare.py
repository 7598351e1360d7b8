"""The comparison that decides ``correct``: each number against its limit."""

from __future__ import annotations

import math

import torch


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest ||a_i - b_i|| / ||b_i|| over the leading index i, in
    float64; inf where ``a`` is not finite or the shapes differ."""
    if tuple(a.shape) != tuple(b.shape):
        return math.inf
    a = a.detach().to(torch.float64).reshape(a.shape[0], -1)
    b = b.detach().to(torch.float64).reshape(b.shape[0], -1).to(a.device)
    if not torch.isfinite(a).all():
        return math.inf
    num = torch.linalg.vector_norm(a - b, dim=1)
    den = torch.linalg.vector_norm(b, dim=1).clamp(min=1e-30)
    return float((num / den).max())


def judge(readings: dict, limits: dict) -> tuple:
    """-> (correct, [(name, value, limit)]): every limited number at or
    under its limit, and every number finite."""
    rows = [(name, float(readings[name]), float(limits[name])) for name in sorted(limits)]
    return all(math.isfinite(v) and v <= lim for _, v, lim in rows), rows
