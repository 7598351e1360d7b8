"""GroupNorm, with an optional SiLU epilogue, on channels-last activations.

:func:`group_norm` normalises ``x`` of shape ``(N, C, *S)`` over each of
``num_groups`` groups of channels and all of ``S``, with fp32 statistics,
applies the per-channel affine and rounds once to ``x``'s dtype; with
``silu`` it returns ``silu`` of that rounded value.  With ``shift`` (N, C)
it normalises ``x + shift[:, :, None, None]``, the sum formed in fp32 and
never rounded or stored (a ResBlock's timestep embedding, folded in).  It reads ``x`` as the
``(N, prod(S), C)`` array that a channels-last tensor holds in memory (a
view there, a copy for any other layout) and returns an ``(N, C, *S)`` view
of channels-last memory, so the convolutions around it keep that layout.

On CUDA tensors it launches the hand-written kernels of
``csrc/group_norm.cu`` (see the note at its top: they replace no Pallas
kernel, bytes bound them) or raises: bfloat16, float16 or float32, any C
with C % G == 0 up to 512 vectors of 16 bytes (of 32 in float32; up to 512
channels where C is not a whole number of vectors), and at most 65535
samples.  An input whose memory does not start on a 16-byte boundary is
copied to one that does.  The launch's shape (vector width, pixel rows a
block, chunks a sample) follows from the input alone: its dtype, N, HW, C
and the card's SM count.  Its gradient is a kernel too
(:class:`_GroupNormFunction`); the weights' gradients are computed only
when autograd asks.  Every buffer is allocated here with ``torch.empty``,
so the calls capture into CUDA graphs.  On CPU tensors, and only there (and
on the meta device, whose tensors carry shapes alone), it is
:func:`group_norm_reference`, differentiated by autograd.

Each call that launches adds one to ``ops.launches.counts`` (``group_norm``
for a forward, ``group_norm_backward`` for a gradient; a forward with a
shift adds one to ``group_norm_shift`` too); a call captured into a CUDA
graph launches nothing, and each replay of the graph adds what its capture
counted (``runtime.graphs``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from cyclediffusion_tpu_torch.ops import cuda_build, launches

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# threads a block: (C / vector width) x pixel rows, at most kMaxThreads of
# the source, and as many rows as fill ROW_THREADS (one row where C / vector
# width alone exceeds it)
MAX_THREADS = 512
ROW_THREADS = 256
# blocks a launch aims at, per SM: one wave at half occupancy, so each
# block's pixels outweigh its reduction (blocks of 512 threads, or 8 blocks
# an SM, measured slower on the H100: PERF.md)
BLOCKS_PER_SM = 4
# pixels each row of threads walks at least, so a chunk outweighs its prologue
MIN_PIXELS_PER_ROW = 4
# the element counts of a chunk stay exact in fp32 (the kernels merge the
# chunks' counts in double)
MAX_CHUNK_ELEMENTS = 1 << 24

_VP, _CI, _CF, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "cd_group_norm_forward": [_VP] * 8 + [_CI, _CL, _CI, _CI, _CI, _CL, _CI, _CI, _CF, _CI,
                                          _CI, _VP],
    "cd_group_norm_backward": [_VP] * 12 + [_CI, _CL, _CI, _CI, _CI, _CL, _CI, _CI, _CI,
                                            _CI, _VP],
}


@functools.cache
def _library():
    """(build info, loaded library) — nvcc runs on the first call only."""
    info = cuda_build.build_library("group_norm", ("group_norm.cu",))
    lib = ctypes.CDLL(str(info.path))
    for fn_name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _CI
    return info, lib


def load_kernels() -> cuda_build.BuildInfo:
    """Build (if needed) and load the library; returns its build record."""
    return _library()[0]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def group_norm_reference(x, weight, bias, num_groups: int, eps: float, silu: bool = False,
                         shift=None):
    """The plain version: ``F.group_norm`` in fp32 (fp32 statistics, biased
    variance, ``y = x a + b`` with ``a = rstd * weight`` and
    ``b = bias - mean * a`` per channel) on the channels-last copy of ``x``
    (plus ``shift``, the sum in fp32 and not rounded), the weights and the
    shift first cast to ``x``'s dtype, one rounding to that dtype, then SiLU
    on the rounded value.  The result is a channels-last view, as the
    kernel's."""
    xf = x.float()
    if shift is not None:
        xf = xf + shift.to(x.dtype).float().view(*shift.shape, *[1] * (x.ndim - 2))
    xf = _channels_last(xf)
    y = F.group_norm(xf, num_groups, weight.to(x.dtype).float(), bias.to(x.dtype).float(),
                     eps)
    y = _channels_last(y).to(x.dtype)
    return F.silu(y) if silu else y


def _channels_last(t):
    """``t`` (N, C, *S) as a view of channels-last memory (a copy unless it
    is one already)."""
    return t.movedim(1, -1).contiguous().movedim(-1, 1)


def _check(x, weight, bias, num_groups: int, shift=None) -> None:
    """Shape checks on any device."""
    if x.ndim < 3:
        raise ValueError(f"group_norm: input {tuple(x.shape)}; it takes (N, C, *S)")
    c = x.shape[1]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"group_norm: {c} channels in {num_groups} groups")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"group_norm: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)} for {c} channels")
    if x.numel() == 0:
        raise ValueError(f"group_norm: empty input {tuple(x.shape)}")
    if shift is not None and tuple(shift.shape) != tuple(x.shape[:2]):
        raise ValueError(f"group_norm: shift {tuple(shift.shape)} for input "
                         f"{tuple(x.shape)}; it takes (N, C)")


def _token_major(t):
    """``t`` (N, C, *S) as the contiguous (N, prod(S), C) array of its
    channels-last memory, starting on a 16-byte boundary: a view where ``t``
    is channels-last and so aligned, a copy otherwise."""
    n, c = t.shape[:2]
    t3 = t.movedim(1, -1).contiguous().view(n, -1, c)
    return t3 if t3.data_ptr() % 16 == 0 else t3.clone()


def _geometry(x3, num_groups: int, *others) -> Tuple[int, int, int, int]:
    """(vector width, pixel rows a block, chunks a sample, pixels a chunk)
    of the launch over ``x3`` (N, HW, C) contiguous, 16-byte vectors where
    C and the bases of ``x3`` and ``others`` allow; raises on a shape the
    kernels do not take."""
    n, hw, c = x3.shape
    vec = 16 // x3.element_size()
    if c % vec or any(t.data_ptr() % 16 for t in (x3, *others)):
        vec = 1
    elif (c // vec > MAX_THREADS and x3.dtype == torch.float32 and c % (2 * vec) == 0
          and not any(t.data_ptr() % 32 for t in (x3, *others))):
        vec *= 2                                      # two 16-byte vectors a thread
    cv = c // vec
    if cv > MAX_THREADS:
        raise ValueError(f"group_norm: {c} channels of {x3.dtype}; the kernel takes at most "
                         f"{MAX_THREADS} vectors of 16 bytes")
    if n > 65535:
        raise ValueError(f"group_norm: {n} samples exceed the grid's 65535")
    rows = max(1, ROW_THREADS // cv)
    target = BLOCKS_PER_SM * _sm_count(x3.device.index)
    chunks = max(1, min(-(-target // n), hw // (rows * MIN_PIXELS_PER_ROW)))
    per_chunk = min(-(-hw // chunks), (MAX_CHUNK_ELEMENTS - 1) // (c // num_groups))
    return vec, rows, -(-hw // per_chunk), per_chunk


def _check_kernel_inputs(x, weight, bias, shift) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: tensors on {x.device}; the kernel needs CUDA")
    if any(t.device != x.device for t in (weight, bias, shift) if t is not None):
        raise ValueError("group_norm: x, weight, bias and shift on different devices")
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm: dtype {x.dtype}; the kernel takes "
                         f"{list(_DTYPES)}")


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(x3, weight, bias, shift, num_groups: int, eps: float, silu: bool):
    """(y, mean, rstd) of the (N, HW, C) input (plus ``shift`` (N, C) or
    None), y in its layout."""
    n, hw, c = x3.shape
    vec, rows, chunks, per_chunk = _geometry(x3, num_groups)
    y = torch.empty_like(x3)
    part = torch.empty((n, num_groups, chunks, 3), dtype=torch.float32, device=x3.device)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x3.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x3.device):
        rc = _library()[1].cd_group_norm_forward(
            x3.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(shift), y.data_ptr(),
            part.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, hw, c, num_groups, chunks,
            per_chunk, rows, vec, float(eps), int(silu), _DTYPES[x3.dtype],
            torch.cuda.current_stream(x3.device).cuda_stream)
    _raise_on_error("group_norm", rc)
    launches.counts["group_norm"] += 1
    launches.counts["group_norm_shift"] += shift is not None
    return y, mean, rstd


def _backward(x3, dy3, weight, bias, shift, mean, rstd, num_groups: int, silu: bool,
              weight_grads: bool):
    """(dx, dweight, dbias) of the (N, HW, C) arrays; dx is also the
    gradient of ``x3 + shift``; the weights' gradients (fp32) are None
    unless ``weight_grads``."""
    n, hw, c = x3.shape
    vec, rows, chunks, per_chunk = _geometry(x3, num_groups, dy3)
    dx = torch.empty_like(x3)
    part = torch.empty((2, n, chunks, c), dtype=torch.float32, device=x3.device)
    sums = torch.empty((2, n, c), dtype=torch.float32, device=x3.device)
    dw = torch.empty(c, dtype=torch.float32, device=x3.device) if weight_grads else None
    db = torch.empty_like(dw) if weight_grads else None
    with torch.cuda.device(x3.device):
        rc = _library()[1].cd_group_norm_backward(
            x3.data_ptr(), dy3.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(shift),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
            sums.data_ptr(), _ptr(dw), _ptr(db), n, hw, c, num_groups, chunks, per_chunk,
            rows, vec, int(silu), _DTYPES[x3.dtype],
            torch.cuda.current_stream(x3.device).cuda_stream)
    _raise_on_error("group_norm_backward", rc)
    launches.counts["group_norm_backward"] += 1
    return dx, dw, db


class _GroupNormFunction(torch.autograd.Function):
    """The kernels' forward and backward (weights and shift already in x's
    dtype; shift contiguous, or None)."""

    @staticmethod
    def forward(ctx, x, weight, bias, shift, num_groups: int, eps: float, silu: bool):
        x3 = _token_major(x)
        y3, mean, rstd = _forward(x3, weight, bias, shift, num_groups, eps, silu)
        ctx.save_for_backward(x3, weight, bias, shift, mean, rstd)
        ctx.num_groups, ctx.silu, ctx.shape = num_groups, silu, x.shape
        return y3.view(x.shape[0], *x.shape[2:], x.shape[1]).movedim(-1, 1)

    @staticmethod
    def backward(ctx, dy):
        x3, weight, bias, shift, mean, rstd = ctx.saved_tensors
        weight_grads = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx3, dw, db = _backward(x3, _token_major(dy), weight, bias, shift, mean, rstd,
                                ctx.num_groups, ctx.silu, weight_grads)
        shape = ctx.shape
        dx = (dx3.view(shape[0], *shape[2:], shape[1]).movedim(-1, 1)
              if ctx.needs_input_grad[0] else None)
        # the shift's gradient: dx (that of x + shift) over the pixels
        dshift = dx3.float().sum(1).to(shift.dtype) if ctx.needs_input_grad[3] else None
        if not weight_grads:
            return dx, None, None, dshift, None, None, None
        return dx, dw.to(weight.dtype), db.to(bias.dtype), dshift, None, None, None


def group_norm(x, weight, bias, num_groups: int, eps: float, silu: bool = False,
               shift=None):
    """GroupNorm of ``x`` (N, C, *S), plus ``shift`` (N, C) per sample and
    channel when given, over ``num_groups`` groups with per-channel
    ``weight`` and ``bias`` (weights and shift cast to ``x``'s dtype), then
    SiLU when ``silu``; a channels-last view of ``x``'s shape and dtype."""
    _check(x, weight, bias, num_groups, shift)
    if x.device.type in ("cpu", "meta"):
        return group_norm_reference(x, weight, bias, num_groups, eps, silu, shift)
    _check_kernel_inputs(x, weight, bias, shift)
    weight, bias = (t.to(x.dtype).contiguous() for t in (weight, bias))
    if shift is not None:
        shift = shift.to(x.dtype).contiguous()
    return _GroupNormFunction.apply(x, weight, bias, shift, num_groups, float(eps),
                                    bool(silu))

