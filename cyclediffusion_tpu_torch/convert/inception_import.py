"""pytorch-fid InceptionV3 weights -> the port's BN-folded
``InceptionV3Features`` (counterpart of
``cyclediffusion_tpu.convert.inception_import``).

Source: the ``pt_inception-2015-12-05-*.pth`` state dict of pytorch-fid /
clean-fid (torchvision names: ``Mixed_5b.branch1x1.conv.weight``,
``....bn.{weight,bias,running_mean,running_var}``).  Each BatchNorm (eps
1e-3) is folded into its bias-free conv: ``w' = w * s`` and ``b' = beta -
mean * s`` with ``s = gamma / sqrt(var + eps)``, in fp32.  The ``fc`` head
and ``num_batches_tracked`` are not weights of pool3 and are dropped.
"""

from __future__ import annotations

from typing import Dict

import torch

_BN_EPS = 1e-3


def convert_inception(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A pytorch-fid state dict -> the port's state dict (``X.conv.weight``
    and ``X.conv.bias`` per folded layer)."""
    out = {}
    for key in sd:
        if not key.endswith(".conv.weight"):
            continue
        mod = key[: -len(".conv.weight")]
        w = torch.as_tensor(sd[key]).float()
        gamma, beta, mean, var = (torch.as_tensor(sd[f"{mod}.bn.{leaf}"]).float()
                                  for leaf in ("weight", "bias", "running_mean",
                                               "running_var"))
        scale = gamma / torch.sqrt(var + _BN_EPS)
        out[f"{mod}.conv.weight"] = w * scale[:, None, None, None]
        out[f"{mod}.conv.bias"] = beta - mean * scale
    return out
