"""Tiled (fold/unfold) first-stage inference for large images (counterpart of
``cyclediffusion_tpu.ops.fold``).

The reference's ``split_input_params`` path: overlapping ``ks`` patches at
``stride``, each run through the first stage (decoded, upsampled by the
first stage's factor, or encoded, downsampled by it), weighted by their
clipped distance to the patch border (optionally tie-broken over the patch
grid), overlap-added and normalised by the folded weights.  All patches ride
the batch axis of one first-stage call (or ``micro_batch`` patches per call,
the ragged tail padded to that size); the blend runs in fp32 and rounds once
to the first stage's dtype.  The weights depend only on the geometry and are
computed on the host with numpy.

Layout is NHWC at the interface; :func:`unfold_nhwc` and :func:`fold_nhwc`
use ``F.unfold`` / ``F.fold`` (torch's ``nn.Unfold`` / ``nn.Fold``, the
reference's own operators, row-major patch order) inside.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SplitInputParams:
    """The reference's ``split_input_params`` dict."""

    ks: Tuple[int, int] = (128, 128)
    stride: Tuple[int, int] = (64, 64)
    # the first stage's spatial factor; None: from the model's ch_mult
    vqf: Optional[int] = None
    # patches per first-stage call (None: all B*L in one)
    micro_batch: Optional[int] = None
    patch_distributed_vq: bool = True
    tie_braker: bool = False          # sic: the reference's key
    clip_max_weight: float = 0.5
    clip_min_weight: float = 0.01
    clip_max_tie_weight: float = 0.5
    clip_min_tie_weight: float = 0.01


def _clip_geometry(hw, ks, stride):
    """ks and stride cut to the input's extent."""
    h, w = hw
    return (min(ks[0], h), min(ks[1], w)), (min(stride[0], h), min(stride[1], w))


def _grid(hw, ks, stride) -> Tuple[int, int]:
    """The patch grid's extents (Ly, Lx)."""
    return (hw[0] - ks[0]) // stride[0] + 1, (hw[1] - ks[1]) // stride[1] + 1


def delta_border(h: int, w: int) -> np.ndarray:
    """Normalised least distance to the border, 0 at the edge, 0.5 at the
    centre: (h, w) float64.  A size-1 axis counts as all edge (the
    reference divides 0 by 0 there)."""
    y = np.arange(h, dtype=np.float64)[:, None] / max(h - 1, 1)
    x = np.arange(w, dtype=np.float64)[None, :] / max(w - 1, 1)
    arr = np.stack(np.broadcast_arrays(y, x), axis=-1)
    return np.minimum(arr.min(axis=-1), (1.0 - arr).min(axis=-1))


def patch_weighting(ks, Ly: int, Lx: int, p: SplitInputParams) -> np.ndarray:
    """Per-pixel patch weights, optionally tie-broken over the grid:
    (Ly*Lx, ks0, ks1) float32."""
    w = np.clip(delta_border(*ks), p.clip_min_weight, p.clip_max_weight)
    w = np.broadcast_to(w[None], (Ly * Lx,) + tuple(ks)).copy()
    if p.tie_braker:
        lw = np.clip(delta_border(Ly, Lx), p.clip_min_tie_weight, p.clip_max_tie_weight)
        w = w * lw.reshape(Ly * Lx, 1, 1)
    return w.astype(np.float32)


def unfold_nhwc(x: torch.Tensor, ks, stride) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ly*Lx, ks0, ks1, C), row-major patch order."""
    b, _, _, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), tuple(ks), stride=tuple(stride))  # (B, C*k*k, L)
    return cols.reshape(b, c, ks[0], ks[1], -1).permute(0, 4, 2, 3, 1)


def fold_nhwc(patches: torch.Tensor, out_hw, stride) -> torch.Tensor:
    """(B, L, ks0, ks1, C) -> (B, H, W, C) by overlap-add."""
    b, n, k0, k1, c = patches.shape
    Ly, Lx = _grid(out_hw, (k0, k1), stride)
    if n != Ly * Lx:
        raise ValueError(f"{n} patches for a {Ly}x{Lx} grid")
    cols = patches.permute(0, 4, 2, 3, 1).reshape(b, c * k0 * k1, n)
    out = F.fold(cols, tuple(out_hw), (k0, k1), stride=tuple(stride))
    return out.permute(0, 2, 3, 1)


def fold_normalization(out_hw, ks, stride, weighting: np.ndarray) -> np.ndarray:
    """The folded weights, each pixel's normaliser: (H, W) float32."""
    Ly, Lx = _grid(out_hw, ks, stride)
    out = np.zeros(tuple(out_hw), np.float32)
    for i in range(Ly * Lx):
        iy, ix = divmod(i, Lx)
        out[iy * stride[0]: iy * stride[0] + ks[0],
            ix * stride[1]: ix * stride[1] + ks[1]] += weighting[i]
    return out


def split_first_stage_apply(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    p: SplitInputParams,
    *,
    scale: int,
    upsample: bool,
) -> torch.Tensor:
    """Tiled apply of a per-patch first stage ``fn`` with overlap blending.

    ``fn`` maps (N, ks0, ks1, C) -> (N, ks0*f, ks1*f, C') with f = ``scale``
    if ``upsample`` (decode) else 1/``scale`` (encode).  The patch grid must
    cover the input exactly (an uncovered strip would have a zero
    normaliser), and an encode's ks and stride must be multiples of
    ``scale``.  Differentiable in ``x``."""
    b = x.shape[0]
    hw = tuple(x.shape[1:3])
    ks, stride = _clip_geometry(hw, p.ks, p.stride)
    Ly, Lx = _grid(hw, ks, stride)
    for axis in (0, 1):
        if ks[axis] + ((Ly, Lx)[axis] - 1) * stride[axis] != hw[axis]:
            raise ValueError(f"the patch grid (ks {ks}, stride {stride}) does not cover "
                             f"the input's {hw}")
    if upsample:
        oks = (ks[0] * scale, ks[1] * scale)
        ostride = (stride[0] * scale, stride[1] * scale)
        out_hw = (hw[0] * scale, hw[1] * scale)
    else:
        if any(k % scale or s % scale for k, s in zip(ks, stride)):
            raise ValueError(f"ks {ks} and stride {stride} must be multiples of {scale}")
        oks = (ks[0] // scale, ks[1] // scale)
        ostride = (stride[0] // scale, stride[1] // scale)
        out_hw = (hw[0] // scale, hw[1] // scale)

    patches = unfold_nhwc(x, ks, stride)
    # contiguous NHWC, as an untiled caller hands ``fn`` its input (a conv
    # may round otherwise in another memory layout)
    flat = patches.reshape((b * Ly * Lx,) + tuple(patches.shape[2:])).contiguous()
    mb = p.micro_batch
    n = flat.shape[0]
    if mb is None or mb >= n:
        out = fn(flat)
    else:
        pad = (-n) % mb
        if pad:
            flat = torch.cat([flat, flat[:pad]], dim=0)
        out = torch.cat([fn(flat[i:i + mb]) for i in range(0, n + pad, mb)], dim=0)[:n]
    out = out.reshape((b, Ly * Lx) + tuple(out.shape[1:]))

    w = patch_weighting(oks, Ly, Lx, p)
    norm = fold_normalization(out_hw, oks, ostride, w)
    out_dtype = out.dtype
    w_t = torch.from_numpy(w).to(out.device)[None, :, :, :, None]
    folded = fold_nhwc(out.float() * w_t, out_hw, ostride)
    return (folded / torch.from_numpy(norm).to(out.device)[None, :, :, None]).to(out_dtype)
