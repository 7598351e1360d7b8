"""Flash attention for the SD UNet's long self-attention (counterpart of
``cyclediffusion_tpu.ops.flash_attention``).

Two kernels, written in CUDA C++ for Hopper in ``csrc/flash_attention.cu``
(see the note at the top of that file for what bounds them and how they are
built), replace the two Pallas kernels on the SD-v1 translate path:

* :func:`flash_attention_packed` (K2) — token-major q ``(B, Tq, H*D)``, k/v
  ``(B, Tk, H*D)``; replaces ``flash_attention_packed`` / ``_packed_kernel``.
* :func:`flash_attention_bhtd` (K1) — head-major q ``(B, H, Tq, D)``, k/v
  ``(B, H, Tk, D)``; replaces ``flash_attention_bhtd`` / ``_flash_kernel``.

Each wrapper takes its plain PyTorch version (:func:`attention_reference`,
:func:`attention_packed_reference`) for tensors on the CPU, and only there:
for a CUDA tensor it launches its kernel or raises.  Each launch adds one to
the wrapper's entry in :data:`launch_counts`.

:func:`multi_head_attention_fused` dispatches by shape with the JAX
package's thresholds: Tq >= 2048 with Tk >= 512 to K2, 1024 <= Tq < 2048
with Tk >= 512 to K1, everything shorter (the <=256-token levels, the
77-token cross-attention) to plain attention.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cyclediffusion_tpu_torch.ops import cuda_build

# the SD-v1 levels' head dims (40, 80) and the ragged test shape's (64)
SUPPORTED_HEAD_DIMS = (40, 64, 80)
_DTYPES = (torch.float32, torch.bfloat16)
# the shortest query axis that goes to a kernel (K1; K2 from twice this),
# as in the JAX dispatcher
MIN_FLASH_TOKENS = 1024

# kernel launches per wrapper since the last reset (plain-version calls on
# CPU tensors are not launches and do not count)
launch_counts = {"flash_attention_packed": 0, "flash_attention_bhtd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@functools.cache
def _kernels():
    """(build info, loaded library) — nvcc runs on the first call only."""
    info = cuda_build.build_library("flash_attention", ["flash_attention.cu"])
    lib = ctypes.CDLL(str(info.path))
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.cd_flash_attention_packed.argtypes = (
        [vp] * 4 + [ci] * 5 + [cf, ci, vp])
    lib.cd_flash_attention_packed.restype = ci
    lib.cd_flash_attention_bhtd.argtypes = (
        [vp] * 4 + [ci] * 5 + [cl] * 9 + [cf, ci, vp])
    lib.cd_flash_attention_bhtd.restype = ci
    return info, lib


def load_kernels() -> cuda_build.BuildInfo:
    """Build (if needed) and load the kernels; returns the build record."""
    return _kernels()[0]


def attention_reference(q, k, v, sm_scale: float):
    """Plain attention, head-major (B,H,Tq,D) x (B,H,Tk,D): fp32 logits and
    softmax, weights cast to ``v.dtype`` before P.V.  The plain version of
    K1 and the oracle for both kernels."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _heads(x, num_heads: int):
    b, t, width = x.shape
    return x.reshape(b, t, num_heads, width // num_heads).transpose(1, 2)


def _tokens(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def attention_packed_reference(q, k, v, num_heads: int, sm_scale: float):
    """:func:`attention_reference` in K2's token-major layout (its plain
    version)."""
    return _tokens(attention_reference(_heads(q, num_heads), _heads(k, num_heads),
                                       _heads(v, num_heads), sm_scale))


def _check_kernel_inputs(name: str, q, k, v, head_dim: int,
                         batch_heads: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {q.device}; the kernel needs CUDA")
    if not (k.device == v.device == q.device):
        raise ValueError(f"{name}: q/k/v on different devices")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernel takes float32 or bfloat16, all the same")
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {head_dim} not in {SUPPORTED_HEAD_DIMS}")
    if batch_heads > 65535:
        raise ValueError(f"{name}: batch*heads exceeds the grid's 65535 limit")


def _kernel_ready(x, contiguous: bool):
    """``x`` as the kernels read it: the head dim contiguous and, for the
    bf16 kernel's 16-byte chunks, a 16-byte aligned base and row strides in
    multiples of 8 elements; otherwise (or when ``contiguous``) a fresh
    contiguous copy, which always qualifies (head dims are multiples of 8)."""
    ok = x.stride(-1) == 1 and (x.is_contiguous() or not contiguous)
    if x.dtype == torch.bfloat16:
        ok = ok and x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:-1])
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def flash_attention_packed(q, k, v, num_heads: int, sm_scale: float):
    """Token-major flash attention: q (B,Tq,H*D), k/v (B,Tk,H*D) -> same."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, hd) or v.shape != k.shape or hd % num_heads:
        raise ValueError(f"flash_attention_packed: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, heads={num_heads}")
    if tq == 0 or tk == 0:
        raise ValueError("flash_attention_packed: empty query or key axis")
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, sm_scale)
    d = hd // num_heads
    _check_kernel_inputs("flash_attention_packed", q, k, v, d, b * num_heads)
    q, k, v = (_kernel_ready(x, contiguous=True) for x in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _kernels()[1].cd_flash_attention_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, tq, tk, num_heads, d, float(sm_scale),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error("flash_attention_packed", rc)
    launch_counts["flash_attention_packed"] += 1
    return out


def flash_attention_bhtd(q, k, v, sm_scale: float):
    """Head-major flash attention: q (B,H,Tq,D), k/v (B,H,Tk,D) ->
    (B,H,Tq,D) contiguous.  Inputs may be strided views (the token-major
    tensors seen through a head transpose) as long as D is contiguous."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_bhtd: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tq == 0 or tk == 0:
        raise ValueError("flash_attention_bhtd: empty query or key axis")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale)
    _check_kernel_inputs("flash_attention_bhtd", q, k, v, d, b * h)
    q, k, v = (_kernel_ready(x, contiguous=False) for x in (q, k, v))
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernels()[1].cd_flash_attention_bhtd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, tq, tk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error("flash_attention_bhtd", rc)
    launch_counts["flash_attention_bhtd"] += 1
    return out


def attention_route(tq: int, tk: int) -> str:
    """The dispatcher's choice for a (Tq, Tk) pair: "packed" (K2), "bhtd"
    (K1) or "plain" — the JAX package's thresholds."""
    if tq >= 2 * MIN_FLASH_TOKENS and tk >= 512:
        return "packed"
    if tq >= MIN_FLASH_TOKENS and tk >= 512:
        return "bhtd"
    return "plain"


def multi_head_attention_fused(q, k, v, num_heads: int):
    """(B,T,H*D) multi-head attention, dispatched by shape."""
    b, tq, width = q.shape
    d = width // num_heads
    sm_scale = 1.0 / math.sqrt(d)
    route = attention_route(tq, k.shape[1])
    if route == "packed":
        return flash_attention_packed(q, k, v, num_heads, sm_scale)
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    if route == "bhtd":
        out = flash_attention_bhtd(qh, kh, vh, sm_scale)
    else:
        out = attention_reference(qh, kh, vh, sm_scale)
    return _tokens(out)
