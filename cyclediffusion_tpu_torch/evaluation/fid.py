"""FID and KID over a pluggable feature extractor (counterpart of
``cyclediffusion_tpu.evaluation.fid``).

The statistics are numpy and scipy: the Frechet distance of the features'
Gaussian moments (with pytorch-fid's diagonal jitter when ``sqrtm`` is not
finite), and KID as clean-fid's polynomial-kernel MMD over 100 subsets of at
most 1,000, drawn with ``RandomState(0)``.  The features come from, in this
order:

* the pytorch-fid InceptionV3 (pool3, 2,048) in ``CYCLEDIFFUSION_INCEPTION_CKPT``:
  a state dict, BN-folded into ``models.inception`` and run on the
  caller's device, after clean-fid's resize to 299x299; if that file is not
  such a state dict, it is loaded as a torchscript archive
  (``torch.jit.load``) with its own resize and scaling;
* the shared CLIP image tower (``runtime.context``), if one is installed;
* 64 patch moments of the image, a smoke metric for tests.

The extractor's ``.kind`` names the one it used (``"inception"``,
``"clip"`` or ``"moment"``), and the evaluators tag the metric keys with it,
so a number that is not clean-fid's is never read as one.
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
import warnings
from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F

from cyclediffusion_tpu_torch.runtime import graphs

logger = logging.getLogger(__name__)

INCEPTION_CKPT_ENV = "CYCLEDIFFUSION_INCEPTION_CKPT"
BATCH = 32

# (the converted Inception module, whether it is native, its graphed
# features or None), keyed by (checkpoint path, device)
_INCEPTION_CACHE: dict = {}


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between two Gaussians.  ``sqrtm`` is called without ``disp``
    (newer SciPy has dropped it); its value is the same."""
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        eps = 1e-6
        logger.warning("fid sqrtm produced non-finite values; retrying with eps=%g", eps)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def compute_fid_from_features(feat1: np.ndarray, feat2: np.ndarray) -> float:
    mu1, mu2 = feat1.mean(0), feat2.mean(0)
    return frechet_distance(mu1, np.cov(feat1, rowvar=False), mu2, np.cov(feat2, rowvar=False))


def compute_kid_from_features(feat1: np.ndarray, feat2: np.ndarray, num_subsets: int = 100,
                              max_subset_size: int = 1000, seed: int = 0) -> float:
    """Polynomial-kernel MMD^2 (clean-fid's defaults)."""
    n = feat1.shape[1]
    m = min(min(feat1.shape[0], feat2.shape[0]), max_subset_size)
    rng = np.random.RandomState(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = feat2[rng.choice(feat2.shape[0], m, replace=False)]
        y = feat1[rng.choice(feat1.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


# ---- feature extractors ------------------------------------------------------ #

def _moment_features(images: np.ndarray) -> np.ndarray:
    """(B, H, W, C) [0, 1] -> (B, 64) means and stds over a 4x4 patch grid."""
    b, h, w, c = images.shape
    gh = gw = 4
    ph, pw = h // gh, w // gw
    x = images[:, : ph * gh, : pw * gw].reshape(b, gh, ph, gw, pw, c)
    feats = np.concatenate([x.mean(axis=(2, 4)).reshape(b, -1),
                            x.std(axis=(2, 4)).reshape(b, -1)], axis=1)
    return feats.astype(np.float64)[:, :64]


def _clip_features(images: np.ndarray) -> Optional[np.ndarray]:
    from cyclediffusion_tpu_torch.runtime.context import get_directional_clip

    dclip = get_directional_clip(required=False)
    if dclip is None:
        return None
    return np.concatenate([dclip.scorer.embed_image(images[i:i + BATCH]).cpu().numpy()
                           for i in range(0, images.shape[0], BATCH)]).astype(np.float64)


def resize_299_bicubic(images: torch.Tensor) -> torch.Tensor:
    """clean-fid's resize: Pillow's bicubic to 299x299 on float images
    (mode ``F``, one channel at a time; a = -0.5, the filter widened on a
    downscale, edge weights renormalised), with no rounding between its
    horizontal and vertical passes.  (B, H, W, C) [0, 1] in and out."""
    if images.shape[1:3] == (299, 299):
        return images
    x = images.permute(0, 3, 1, 2) * 255.0
    b, c, h, w = x.shape
    x = x.reshape(b * c, 1, h, w)
    x = F.interpolate(x, size=(h, 299), mode="bicubic", align_corners=False, antialias=True)
    x = F.interpolate(x, size=(299, 299), mode="bicubic", align_corners=False, antialias=True)
    return (x.reshape(b, c, 299, 299) / 255.0).permute(0, 2, 3, 1)


def _load_inception(path: str, device):
    """-> ``(module, native)``: the BN-folded module from a pytorch-fid
    state dict, or else the file as a torchscript archive."""
    from cyclediffusion_tpu_torch.convert.inception_import import convert_inception
    from cyclediffusion_tpu_torch.models.inception import InceptionV3Features

    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model = InceptionV3Features()
        model.load_state_dict(convert_inception(sd), strict=True)
    except (RuntimeError, KeyError, AttributeError, TypeError, pickle.UnpicklingError) as e:
        warnings.warn(f"native Inception conversion failed ({type(e).__name__}: {e}); "
                      f"trying torch.jit.load({path!r}) as a torchscript archive")
        return torch.jit.load(path, map_location=device).eval(), False
    return model.to(device).eval().requires_grad_(False), True


def padded_batches(n: int, size: int = BATCH):
    """(start, stop, pad) of each batch of ``n`` images, ``size`` at a time,
    as JAX pads them "to avoid a second compile": where there is more than
    one batch, a short last batch is padded to ``size`` by repeating its
    last image ``pad`` times, and those rows' features are dropped."""
    out = []
    for i in range(0, n, size):
        stop = min(i + size, n)
        out.append((i, stop, size - (stop - i) if stop - i < size and n > size else 0))
    return out


def batched_features(fn: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                     size: int = BATCH) -> torch.Tensor:
    """``fn`` over ``images`` in :func:`padded_batches`, the padded rows'
    features dropped -> (N, ...) on ``images``' device: one batch shape for
    every call where there is more than one batch."""
    out = []
    for i, stop, pad in padded_batches(images.shape[0], size):
        batch = images[i:stop]
        if pad:
            batch = torch.cat([batch, batch[-1:].expand((pad,) + batch.shape[1:])])
        feats = fn(batch)
        out.append(feats[:-pad] if pad else feats)
    return torch.cat(out)


def _native_features(model, images01: torch.Tensor) -> torch.Tensor:
    from cyclediffusion_tpu_torch.models.inception import inception_pool3_features

    return inception_pool3_features(model, resize_299_bicubic(images01))


@torch.no_grad()
def _inception_features(images: np.ndarray, device) -> Optional[np.ndarray]:
    """pool3 features of the asset's Inception, or None without the asset.
    A state dict's module replays a CUDA graph of the resize and the tower
    on the card (JAX's jitted ``inception_pool3_features``), over
    :func:`padded_batches`, so one graph serves every batch.  A torchscript
    archive runs its own graph eagerly and unpadded, as JAX's does: what it
    launches is its own."""
    path = os.environ.get(INCEPTION_CKPT_ENV)
    if not path or not os.path.exists(path):
        return None
    key = (path, str(torch.device(device)))
    if key not in _INCEPTION_CACHE:
        _INCEPTION_CACHE.clear()
        model, native = _load_inception(path, device)
        graphed = (graphs.GraphedCall(functools.partial(_native_features, model), name="fid")
                   if native else None)
        _INCEPTION_CACHE[key] = (model, native, graphed)
    model, native, graphed = _INCEPTION_CACHE[key]
    batches = torch.as_tensor(images, dtype=torch.float32, device=device)
    if native:
        feats = batched_features(graphed, batches)
    else:
        feats = torch.cat([model(batches[i:i + BATCH].permute(0, 3, 1, 2) * 255.0).float()
                           for i in range(0, batches.shape[0], BATCH)])
    return feats.cpu().numpy().astype(np.float64)


def get_feature_extractor(device="cuda") -> Callable[[np.ndarray], np.ndarray]:
    """The best extractor there is; its ``.kind`` names the one the last
    call used."""

    def extract(images: np.ndarray) -> np.ndarray:
        feats = _inception_features(images, device)
        if feats is not None:
            extract.kind = "inception"
            return feats
        feats = _clip_features(images)
        if feats is not None:
            extract.kind = "clip"
            logger.warning("FID/KID computed over CLIP features (no inception asset) — "
                           "values are NOT comparable to clean-fid numbers.")
            return feats
        extract.kind = "moment"
        logger.warning("FID/KID computed over raw patch moments (no feature assets) — "
                       "smoke-test fidelity only.")
        return _moment_features(images)

    extract.kind = None
    return extract


def compute_fid_kid(gen_images: np.ndarray, ref_images: np.ndarray, device="cuda"):
    """(Bg, H, W, C), (Br, H, W, C) in [0, 1] -> (fid, kid, feature kind)."""
    extract = get_feature_extractor(device)
    f_gen = extract(gen_images)
    f_ref = extract(ref_images)
    return (compute_fid_from_features(f_gen, f_ref),
            compute_kid_from_features(f_gen, f_ref), extract.kind)
