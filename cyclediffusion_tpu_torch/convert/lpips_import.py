"""The ``lpips`` package's VGG16 LPIPS weights -> the port's
``evaluation.lpips.LPIPS`` (counterpart of
``cyclediffusion_tpu.convert.lpips_import``).

Source layout (``lpips.LPIPS(net='vgg')`` state dict):

* ``net.slice{1..5}.{idx}.weight / bias``: torchvision ``vgg16().features``
  convolutions, sliced at the five LPIPS taps, at their fixed torchvision
  indices (0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28);
* ``lin{0..4}.model.1.weight``: the non-negative 1x1 heads, (1, C, 1, 1).

Target: ``vgg.conv.{0..12}.weight / bias`` (OIHW, as torchvision's) and
``lins.{0..4}`` (C,).  Other keys (the scaling layer's buffers) are not
weights and are dropped.
"""

from __future__ import annotations

from typing import Dict

import torch

# torchvision vgg16().features indices of each conv, grouped by LPIPS slice
_SLICE_CONV_IDX = (
    (0, 2),
    (5, 7),
    (10, 12, 14),
    (17, 19, 21),
    (24, 26, 28),
)


def convert_lpips(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ``lpips`` VGG state dict (tensors or numpy arrays) -> the port's
    LPIPS state dict, fp32.  Raises ``KeyError`` naming a missing key and
    ``ValueError`` on a head of the wrong shape."""
    out, n = {}, 0
    for s, idxs in enumerate(_SLICE_CONV_IDX, start=1):
        for idx in idxs:
            for leaf in ("weight", "bias"):
                out[f"vgg.conv.{n}.{leaf}"] = torch.as_tensor(
                    sd[f"net.slice{s}.{idx}.{leaf}"]).float()
            n += 1
    for i in range(5):
        w = torch.as_tensor(sd[f"lin{i}.model.1.weight"]).float()
        if w.ndim != 4 or w.shape[0] != 1 or tuple(w.shape[2:]) != (1, 1):
            raise ValueError(f"lin{i}.model.1.weight: shape {tuple(w.shape)}, "
                             "expected (1, C, 1, 1)")
        out[f"lins.{i}"] = w[0, :, 0, 0]
    return out
