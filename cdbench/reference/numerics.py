"""Linear and convolution layers whose inputs a control can round.

The reference runs its layers in float32.  The control of a cell is the
same reference one precision below the configuration's: its weights and
the inputs of every linear and convolution rounded to float8 (e4m3, one
scale per tensor), the rest computed in bfloat16.  :func:`to_fp8_control`
turns a reference model into that control in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0     # the largest finite float8_e4m3fn


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor, back in
    ``x``'s dtype.  The rounding passes the gradient straight through (a
    cast to float8 has none), as float8 training does."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


class Linear(nn.Linear):
    quant = None

    def forward(self, x):
        return F.linear(x if self.quant is None else self.quant(x), self.weight, self.bias)


class Conv2d(nn.Conv2d):
    quant = None

    def forward(self, x):
        return self._conv_forward(x if self.quant is None else self.quant(x),
                                  self.weight, self.bias)


@torch.no_grad()
def to_fp8_control(model: nn.Module) -> nn.Module:
    """``model`` in bfloat16 with float8-rounded weights and layer inputs."""
    model.to(torch.bfloat16)
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.weight.copy_(fake_fp8(m.weight))
            m.quant = fake_fp8
        elif hasattr(m, "in_proj_weight"):       # CLIP's fused q/k/v projection
            m.in_proj_weight.copy_(fake_fp8(m.in_proj_weight))
            m.quant = fake_fp8
    return model


def set_reference_precision() -> None:
    """float32 products stay float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
