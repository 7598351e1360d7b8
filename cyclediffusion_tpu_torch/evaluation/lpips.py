"""LPIPS (Learned Perceptual Image Patch Similarity, Zhang et al. 2018,
VGG16 backbone), the counterpart of ``cyclediffusion_tpu.evaluation.lpips``.

The fidelity bound of ``BASELINE.md`` ("<1e-2 LPIPS drift") is stated in
this metric.  :class:`LPIPS` holds the tower and the heads:

* :class:`VGG16Features`: the 13 convolutions of torchvision's
  ``vgg16().features`` (``conv.0`` ... ``conv.12``, NCHW), ReLU after each,
  a 2x2 max-pool before each of stages 2-5, and the five taps (relu1_2,
  relu2_2, relu3_3, relu4_3, relu5_3) at the ends of the stages;
* ``lins.0`` ... ``lins.4``: the non-negative 1x1 heads, one weight per
  channel of each tap.

:func:`lpips_distance` takes NHWC RGB images in [-1, 1], as the JAX
function does, and follows ``lpips.LPIPS.forward``: the scaling layer's
shift and scale, a unit norm over each tap's channels (eps 1e-10), the
squared difference, the heads, the spatial mean, the sum over taps.

Weights are a user asset: ``CYCLEDIFFUSION_LPIPS`` names a state dict of
the ``lpips`` package's ``LPIPS(net='vgg')``, converted by
``convert/lpips_import.py``.  Without it, :func:`random_lpips_params`
gives a seeded random-feature metric, a valid drift detector whose
absolute scale is not the published LPIPS scale.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cyclediffusion_tpu_torch.models.nn import resolve_device

# conv widths per tap stage (torchvision VGG16 features, max-pool between)
VGG16_STAGES: Tuple[Tuple[int, ...], ...] = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)
TAP_WIDTHS = tuple(s[-1] for s in VGG16_STAGES)

# lpips/lpips.py ScalingLayer constants (shift / scale of [-1, 1] inputs)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16's conv tower -> the five LPIPS tap activations (NCHW)."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for widths in VGG16_STAGES:
            for w in widths:
                convs.append(nn.Conv2d(cin, w, 3, padding=1))
                cin = w
        self.conv = nn.ModuleList(convs)

    def forward(self, x) -> List[torch.Tensor]:
        taps, i = [], 0
        for stage, widths in enumerate(VGG16_STAGES):
            if stage > 0:
                x = F.max_pool2d(x, 2, 2)
            for _ in widths:
                x = F.relu(self.conv[i](x))
                i += 1
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """The VGG16 tower and the five 1x1 heads (``lins.i``, shape (C,))."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.lins = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c in TAP_WIDTHS])
        self.requires_grad_(False)


def scaling_layer(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB (NHWC) -> VGG input space (lpips' ScalingLayer)."""
    shift = torch.tensor(_SHIFT, dtype=img.dtype, device=img.device)
    scale = torch.tensor(_SCALE, dtype=img.dtype, device=img.device)
    return (img - shift) / scale


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips.normalize_tensor: unit L2 norm over the channel axis (NCHW)."""
    norm = torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True))
    return feat / (norm + eps)


def lpips_distance(model: LPIPS, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS(img0, img1) for NHWC RGB images in [-1, 1] -> (B,), computed on
    the model's device."""
    h, w = img0.shape[1:3]
    if h < 16 or w < 16:
        raise ValueError(
            f"LPIPS needs inputs >= 16x16 (four 2x2 max-pools); got {h}x{w}")
    device = model.lins[0].device
    x0 = scaling_layer(torch.as_tensor(img0, device=device)).permute(0, 3, 1, 2)
    x1 = scaling_layer(torch.as_tensor(img1, device=device)).permute(0, 3, 1, 2)
    n = x0.shape[0]
    taps = model.vgg(torch.cat([x0, x1]))      # one pass over both images
    total = 0.0
    for tap, feat in enumerate(taps):
        diff = (_unit_normalize(feat[:n]) - _unit_normalize(feat[n:])) ** 2
        head = model.lins[tap].to(diff.dtype)
        # the 1x1 head is a channel-weighted sum; then the spatial mean
        total = total + torch.sum(diff * head[None, :, None, None], dim=1).mean(dim=(1, 2))
    return total


def _lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's default kernel init: a normal truncated to two standard
    deviations, of variance 1 / fan_in, drawn by the inverse CDF."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(p.shape, generator=generator, device=p.device, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    p.copy_((z * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)).to(p.dtype))


@torch.no_grad()
def random_lpips_params(generator: Optional[torch.Generator] = None,
                        device="cuda") -> LPIPS:
    """A seeded random-feature LPIPS (assetless drift metric), the JAX
    function's distributions: Flax's default conv init (truncated LeCun
    normal kernels, zero biases) and heads |N(0, 1)| / C.  ``generator``
    defaults to seed 0 on ``device``."""
    device = resolve_device(device)
    model = LPIPS().to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    for conv in model.vgg.conv:
        _lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        conv.bias.zero_()
    for head, c in zip(model.lins, TAP_WIDTHS):
        head.copy_(torch.randn(c, generator=generator, device=device).abs() / c)
    return model


def load_lpips_params(path: Optional[str] = None, device="cuda") -> Optional[LPIPS]:
    """LPIPS weights from the user asset, or None if there is none.
    ``path`` defaults to ``$CYCLEDIFFUSION_LPIPS`` (a torch-saved state dict
    of ``lpips.LPIPS(net='vgg')``, read with ``weights_only=True``)."""
    path = path or os.environ.get("CYCLEDIFFUSION_LPIPS")
    if not path or not os.path.exists(path):
        return None
    from cyclediffusion_tpu_torch.convert.lpips_import import convert_lpips

    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = LPIPS().to(resolve_device(device))
    model.load_state_dict(convert_lpips(sd), strict=True)
    return model
