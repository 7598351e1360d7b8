"""Flash attention for the SD UNet's long self-attention (counterpart of
``cyclediffusion_tpu.ops.flash_attention``).

Four kernels, written in CUDA C++ for Hopper (see the notes at the top of
``csrc/flash_attention.cu`` and ``csrc/folded_attention.cu`` for what bounds
them and how they are built), replace the four Pallas kernels:

* :func:`flash_attention_packed` (K2) — token-major q ``(B, Tq, H*D)``, k/v
  ``(B, Tk, H*D)``; replaces ``flash_attention_packed`` / ``_packed_kernel``.
* :func:`flash_attention_bhtd` (K1) — head-major q ``(B, H, Tq, D)``, k/v
  ``(B, H, Tk, D)``; replaces ``flash_attention_bhtd`` / ``_flash_kernel``.
* :func:`qout_self_attention_block` (K3) — q projection, attention and
  output projection with bias, k/v given; replaces
  ``qout_self_attention_block`` / ``_qout_kernel``.
* :func:`fused_self_attention_block` (K4) — the same with the k/v
  projections too; replaces ``fused_self_attention_block`` /
  ``_folded_kernel``.

In bf16, K3 and K4 are composed of two hand-written kernels, three launches
behind one call: the projection kernel (:func:`linear` runs it alone), K2's
attention kernel, and the projection kernel again for the output.

Each wrapper takes its plain PyTorch version (:func:`attention_reference`,
:func:`attention_packed_reference`, :func:`qout_self_attention_reference`,
:func:`fused_self_attention_reference`, :func:`linear_reference`) for tensors
on the CPU, and only there: for a CUDA tensor it launches its kernel or
raises.  Each call of K1-K4 that launches adds one to the wrapper's entry in
:data:`launch_counts` (:func:`linear`, a part of K3/K4, counts none); a
call captured into a CUDA graph launches nothing, and each replay of the
graph adds what its capture counted (``runtime.graphs``).
None of them has a backward: in grad mode each refuses an input that
requires a gradient, on the CPU too.

:func:`multi_head_attention_fused` dispatches by shape with the JAX
package's thresholds: Tq >= 2048 with Tk >= 512 to K2, 1024 <= Tq < 2048
with Tk >= 512 to K1, everything shorter (the <=256-token levels, the
77-token cross-attention) to plain attention.  K3/K4 are chosen by the
transformer's ``CrossAttention`` (``folded_attn``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import math
from typing import List

import torch

from cyclediffusion_tpu_torch.ops import cuda_build

# K1/K2: the SD-v1 levels' head dims (40, 80), the FFHQ/CelebA LDM's (32)
# and the ragged test shape's (64); K3/K4 (the SD UNet's folded modes) keep
# the three they are checked at on the card
SUPPORTED_HEAD_DIMS = (32, 40, 64, 80)
FOLDED_HEAD_DIMS = (40, 64, 80)
_DTYPES = (torch.float32, torch.bfloat16)
# the widest C or H*D the folded kernels' bf16 path takes (the projection
# kernel's X tile and W ring in shared memory: kLinMaxK in hopper_linear.cuh)
LINEAR_MAX_K = 448
# the shortest query axis that goes to a kernel (K1; K2 from twice this),
# as in the JAX dispatcher
MIN_FLASH_TOKENS = 1024

# kernel launches per wrapper since the last reset (plain-version calls on
# CPU tensors are not launches and do not count; runtime.graphs takes a
# capture's counts back out and adds them at each replay)
launch_counts = {"flash_attention_packed": 0, "flash_attention_bhtd": 0,
                 "qout_self_attention_block": 0, "fused_self_attention_block": 0}

_VP, _CI, _CF, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# the CUDA libraries: name -> (sources under csrc/, headers hashed and .cu
# built; the C entry points' argument types, each returning a CUDA error code)
_LIBRARIES = {
    "flash_attention": (("flash_attention.cu", "attention_common.cuh",
                         "hopper_attention.cuh"), {
        "cd_flash_attention_packed": [_VP] * 4 + [_CI] * 5 + [_CF, _CI, _VP],
        "cd_flash_attention_bhtd": [_VP] * 4 + [_CI] * 5 + [_CL] * 9 + [_CF, _CI, _VP],
    }),
    "folded_attention": (("folded_attention.cu", "attention_common.cuh",
                          "hopper_attention.cuh", "hopper_linear.cuh"), {
        "cd_qout_self_attention": [_VP] * 8 + [_CI] * 6 + [_CL] * 4 + [_CF, _CI, _VP],
        "cd_fused_self_attention": [_VP] * 8 + [_CI] * 5 + [_CF, _CI, _VP],
        "cd_linear": [_VP] * 4 + [_CI] * 3 + [_VP],
    }),
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@functools.cache
def _library(name: str):
    """(build info, loaded library) — nvcc runs on the first call only."""
    sources, signatures = _LIBRARIES[name]
    info = cuda_build.build_library(name, sources)
    lib = ctypes.CDLL(str(info.path))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _CI
    return info, lib


def load_kernels() -> List[cuda_build.BuildInfo]:
    """Build (if needed) and load every kernel library, one nvcc process per
    library, all started together; returns the build records."""
    with concurrent.futures.ThreadPoolExecutor(len(_LIBRARIES)) as pool:
        futures = [pool.submit(_library, name) for name in _LIBRARIES]
        return [f.result()[0] for f in futures]


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
    bf16 kernels' 16-byte chunks and TMA's tensor maps, a 16-byte aligned
    base and strides in multiples of 8 elements, nonzero unless the dim
    has size 1; otherwise (or when ``contiguous``) a fresh contiguous copy,
    which always qualifies (head dims are multiples of 8)."""
    ok = x.stride(-1) == 1 and (x.is_contiguous() or not contiguous)
    if x.dtype == torch.bfloat16:
        ok = ok and x.data_ptr() % 16 == 0 and all(
            st % 8 == 0 and (st > 0 or n == 1) for n, st in zip(x.shape[:-1], x.stride()[:-1]))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _refuse_gradient(name: str, *tensors) -> None:
    """The kernels define no backward, as the TPU kernels define no VJP: in
    grad mode an input that requires a gradient is refused, on every device
    (the plain version on the CPU would differentiate where the card could
    not)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that need no gradient")


def flash_attention_packed(q, k, v, num_heads: int, sm_scale: float):
    """Token-major flash attention: q (B,Tq,H*D), k/v (B,Tk,H*D) -> same."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, hd) or v.shape != k.shape or hd % num_heads:
        raise ValueError(f"flash_attention_packed: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, heads={num_heads}")
    if tq == 0 or tk == 0:
        raise ValueError("flash_attention_packed: empty query or key axis")
    _refuse_gradient("flash_attention_packed", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, sm_scale)
    d = hd // num_heads
    _check_kernel_inputs("flash_attention_packed", q, k, v, d, b * num_heads)
    q, k, v = (_kernel_ready(x, contiguous=True) for x in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _library("flash_attention")[1].cd_flash_attention_packed(
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
    _refuse_gradient("flash_attention_bhtd", q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale)
    _check_kernel_inputs("flash_attention_bhtd", q, k, v, d, b * h)
    q, k, v = (_kernel_ready(x, contiguous=False) for x in (q, k, v))
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library("flash_attention")[1].cd_flash_attention_bhtd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, tq, tk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error("flash_attention_bhtd", rc)
    launch_counts["flash_attention_bhtd"] += 1
    return out


def _folded_attention(q, k, v, num_heads: int, sm_scale: float):
    """Token-major attention at the folded kernels' rounding points: fp32
    logits, p = exp(s - max) rounded to the input dtype, l the fp32 sum of
    that rounded p, P.V accumulated in fp32, the normalised result rounded
    once to the input dtype."""
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * sm_scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, vh.float()) / p.sum(dim=-1, keepdim=True)
    return _tokens(o.to(v.dtype))


def linear_reference(x, w, b=None):
    """x W^T (+ b), accumulated in fp32, b added in fp32, rounded once to x's
    dtype: the plain version of the projection kernel and the folded
    kernels' projections."""
    out = torch.nn.functional.linear(x.float(), w.float())
    return (out if b is None else out + b.float()).to(x.dtype)


def qout_self_attention_reference(x, wq, k, v, wo, bo, num_heads: int):
    """The plain version of K3 (same arguments as
    :func:`qout_self_attention_block`)."""
    d = wq.shape[0] // num_heads
    q = linear_reference(x, wq)
    return linear_reference(_folded_attention(q, k, v, num_heads, d ** -0.5), wo, bo)


def fused_self_attention_reference(x, wq, wk, wv, wo, bo, num_heads: int):
    """The plain version of K4: k and v projected from x, rounded once, then
    :func:`qout_self_attention_reference`."""
    return qout_self_attention_reference(x, wq, linear_reference(x, wk),
                                         linear_reference(x, wv), wo, bo, num_heads)


def _check_folded(name: str, x, weights, kv, num_heads: int) -> int:
    """Shape checks of K3/K4 on any device; returns the head dim."""
    b, _, c = x.shape
    wq, wo, bo = weights[0], weights[-2], weights[-1]
    hd = wq.shape[0]
    ok = (num_heads > 0 and hd % num_heads == 0 and bo.shape == (c,)
          and wo.shape == (c, hd) and all(w.shape == (hd, c) for w in weights[:-2])
          and all(t.ndim == 3 and t.shape[0] == b and t.shape[2] == hd for t in kv)
          and (not kv or kv[0].shape == kv[1].shape))
    if not ok:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, weights "
                         f"{[tuple(w.shape) for w in weights]}, k/v "
                         f"{[tuple(t.shape) for t in kv]}, heads={num_heads}")
    if x.shape[1] == 0 or any(t.shape[1] == 0 for t in kv):
        raise ValueError(f"{name}: empty query or key axis")
    return hd // num_heads


def _check_folded_limits(name: str, dtype, b: int, t: int, c: int, hd: int, d: int,
                         num_heads: int) -> None:
    """The shapes the folded kernels take, by dtype: bf16 runs the
    projection kernel (C and H*D <= LINEAR_MAX_K) and the attention kernel
    (B*H blocks on the grid's y axis); fp32 its [k | v] kernel (B*T / 64
    blocks on the y axis)."""
    if d not in FOLDED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {FOLDED_HEAD_DIMS}")
    if c % 64 or hd % 64:
        raise ValueError(f"{name}: widths C={c}, H*D={hd}; the kernel takes "
                         "multiples of 64")
    if dtype == torch.bfloat16:
        if max(c, hd) > LINEAR_MAX_K:
            raise ValueError(f"{name}: widths C={c}, H*D={hd}; the bf16 kernels take "
                             f"at most {LINEAR_MAX_K}")
        if b * num_heads > 65535:
            raise ValueError(f"{name}: batch*heads exceeds the grid's 65535 limit")
    elif b * t > 65535 * 64:
        raise ValueError(f"{name}: batch*tokens exceeds the grid's limit")


def _check_folded_kernel_inputs(name: str, tensors, d: int, c: int, hd: int,
                                num_heads: int) -> None:
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device}; the kernel needs CUDA")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}; the kernel "
                         "takes float32 or bfloat16, all the same (weights cast first)")
    _check_folded_limits(name, x.dtype, x.shape[0], x.shape[1], c, hd, d, num_heads)


def qout_self_attention_block(x, wq, k, v, wo, bo, num_heads: int):
    """K3: ``(softmax((x Wq^T) k^T / sqrt(d)) v) Wo^T + bo`` with k and v given.

    x (B, Tq, C); ``nn.Linear`` weights as they are, never transposed per
    call: wq (H*D, C), wo (C, H*D), bo (C,); k/v (B, Tk, H*D), token-major,
    possibly strided views with a contiguous last dim.  All in x's dtype.
    Returns (B, Tq, C)."""
    d = _check_folded("qout_self_attention_block", x, (wq, wo, bo), (k, v), num_heads)
    _refuse_gradient("qout_self_attention_block", x, wq, k, v, wo, bo)
    if x.device.type == "cpu":
        return qout_self_attention_reference(x, wq, k, v, wo, bo, num_heads)
    b, tq, c = x.shape
    tk, hd = k.shape[1], wq.shape[0]
    _check_folded_kernel_inputs("qout_self_attention_block", (x, wq, k, v, wo, bo),
                                d, c, hd, num_heads)
    x, wq, wo, bo = (_kernel_ready(t, contiguous=True) for t in (x, wq, wo, bo))
    k, v = (_kernel_ready(t, contiguous=False) for t in (k, v))
    out = torch.empty((b, tq, c), dtype=x.dtype, device=x.device)
    # bf16: q, then the attention over it; fp32 needs none
    ws = (torch.empty((b, tq, hd), dtype=x.dtype, device=x.device)
          if x.dtype == torch.bfloat16 else None)
    with torch.cuda.device(x.device):
        rc = _library("folded_attention")[1].cd_qout_self_attention(
            x.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
            b, tq, tk, c, num_heads, d,
            k.stride(0), k.stride(1), v.stride(0), v.stride(1), d ** -0.5,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error("qout_self_attention_block", rc)
    launch_counts["qout_self_attention_block"] += 1
    return out


def fused_self_attention_block(x, wq, wk, wv, wo, bo, num_heads: int):
    """K4: :func:`qout_self_attention_block` with k = x Wk^T and v = x Wv^T
    computed by the kernel (wk, wv (H*D, C)).  Several launches behind one
    call (bf16: the [q | k | v] projection into a workspace, the attention,
    the output projection; fp32: the [k | v] projection, then K3's kernel);
    the call counts as one launch of K4."""
    d = _check_folded("fused_self_attention_block", x, (wq, wk, wv, wo, bo), (),
                      num_heads)
    _refuse_gradient("fused_self_attention_block", x, wq, wk, wv, wo, bo)
    if x.device.type == "cpu":
        return fused_self_attention_reference(x, wq, wk, wv, wo, bo, num_heads)
    b, t, c = x.shape
    hd = wq.shape[0]
    _check_folded_kernel_inputs("fused_self_attention_block", (x, wq, wk, wv, wo, bo),
                                d, c, hd, num_heads)
    x, wq, wk, wv, wo, bo = (_kernel_ready(w, contiguous=True)
                             for w in (x, wq, wk, wv, wo, bo))
    # bf16: [q | k | v], the attention over q; fp32: [k | v]
    width = (3 if x.dtype == torch.bfloat16 else 2) * hd
    ws = torch.empty((b, t, width), dtype=x.dtype, device=x.device)
    out = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library("folded_attention")[1].cd_fused_self_attention(
            x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), ws.data_ptr(), out.data_ptr(), b, t, c, num_heads, d,
            d ** -0.5, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error("fused_self_attention_block", rc)
    launch_counts["fused_self_attention_block"] += 1
    return out


def linear(x, w, b=None):
    """The folded kernels' projection kernel alone: ``x W^T (+ b)`` with x
    (..., K), an ``nn.Linear`` weight w (N, K) and b (N,) -> (..., N),
    accumulated in fp32 and rounded once (:func:`linear_reference` on the
    CPU).  On the card bf16 only, K a multiple of 64 up to LINEAR_MAX_K, N a
    multiple of 64.  Not on any path by itself (K3/K4 launch the kernel from
    C), so it counts no launches; ``chip_smoke.py`` times it."""
    n, k = w.shape
    if x.shape[-1] != k or (b is not None and tuple(b.shape) != (n,)):
        raise ValueError(f"linear: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {None if b is None else tuple(b.shape)}")
    _refuse_gradient("linear", x, w, b)
    if x.device.type == "cpu":
        return linear_reference(x, w, b)
    tensors = (x, w) if b is None else (x, w, b)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"linear: tensors on {[str(t.device) for t in tensors]}; "
                         "the kernel needs them all on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"linear: dtypes {[t.dtype for t in tensors]}; the kernel "
                         "takes bfloat16")
    if k % 64 or k > LINEAR_MAX_K or n % 64 or x.numel() == 0:
        raise ValueError(f"linear: K={k}, N={n}, {x.numel() // k} rows; the kernel takes "
                         f"K and N multiples of 64, K up to {LINEAR_MAX_K}, at least one "
                         "row")
    x2 = _kernel_ready(x.reshape(-1, k), contiguous=True)
    w = _kernel_ready(w, contiguous=True)
    b = None if b is None else b.contiguous()
    out = torch.empty((x2.shape[0], n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library("folded_attention")[1].cd_linear(
            x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), x2.shape[0], n, k,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error("linear", rc)
    return out.reshape(*x.shape[:-1], n)


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
