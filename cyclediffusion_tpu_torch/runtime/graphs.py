"""The eps model's call replayed as a CUDA graph: the port's counterpart of
the JAX package's compiled chains (each chain one ``jax.lax.scan`` in
``cyclediffusion_tpu.samplers.ddim``, jitted once per skip by
``pipelines.latent_text``, or with the whole encode and generate by the
other pipelines).

The chains stay Python loops here; what the host cannot keep up with is the
model call inside them (an SD v1 UNet call is 1,352 launches), so that call
is what is captured.  :class:`GraphedCall` wraps ``fn(*args)``:

* On CPU tensors it is the plain call (the caller asking for the CPU, as
  the tests do).
* On CUDA tensors the first call of each signature (:func:`signature`: the
  nesting of the arguments, each tensor's shape, dtype and device, each
  other argument's value, ``None`` included, and the backend flags that
  pick convolution and GEMM kernels) runs eagerly on a side stream (the
  warm-up: it builds the CUDA kernels, loads their libraries and lets the
  libraries pick their algorithms before any capture) and returns that
  result; then the call is captured once into a ``torch.cuda.CUDAGraph``.
  Every later call of the signature copies its tensor arguments into the
  graph's static inputs and replays it.  A capture that fails raises.
* Every tensor argument is an input of the graph (a copy in the
  argument's own memory layout, so a channels-last activation stays one),
  copied at each replay, so nothing that changes between calls (the
  latent, the timesteps, a text context, a fast-mode cache) is read by
  address from the call that was captured: JAX's rule that parameters are
  traced arguments, not closures.  Model weights are read by address: they must be updated in
  place (``load_state_dict`` does), never replaced.
* Results are copies of the graph's static outputs, made as the replay's
  last step, so a result outlives the next replay of the same graph (the
  fast mode's cache is kept across the reuse calls that follow its key
  call, and callers hold an eps across calls).
* Graphs of one model share one :class:`GraphPool` (replays are sequential
  on the current stream, and each result is copied out before the next
  replay, so one pool sized by the largest capture serves them all).
* Frozen dataclasses (a tiled first stage's ``SplitInputParams``) are part
  of the signature field by field, as JAX reads ``split_input_params`` at
  trace time: another setting is another graph.

The kernel wrappers count their launches in Python (``ops.launches``), so
a replay would count nothing: a capture records what it added to
``launches.counts`` (and takes it back, since capturing launches nothing),
and each replay adds it once.

Each call records a ``graph.<name>`` span (``runtime.profiling``) over its
copy-in, replay and copy-out (or its warm-up and capture) on the host, and
with ``time_device`` over the replay alone on the device, with the first
tensor's leading dimension as its rows, and counts
``graph.captures.<name>`` at a capture and ``graph.replays.<name>`` at a
replay; ``name`` is given at construction (``unet``, ``first_stage.decode``,
...).

Gradients: a replay cannot be differentiated.  In grad mode an input that
requires a gradient is refused (on every device, as the kernels refuse
one), and the call runs under ``torch.no_grad()``.  A function that takes
its own input-only gradient inside, as ``jax.grad`` sits inside the JAX
package's compiled guided step, is :class:`GraphedGrad`: the forward and
the backward are captured together (the autograd engine runs a backward on
its forward's stream, which is the capture stream), and the autograd graph
built during the capture is freed when the gradient is taken, at the
capture's end.  Its warm-up runs the backward too, twice.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from cyclediffusion_tpu_torch.ops import launches as kernel_launches
from cyclediffusion_tpu_torch.runtime import profiling


def backend_flags() -> tuple:
    """The global flags that choose a convolution's or GEMM's kernel (and
    so its rounding) at capture time."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)


def _structure(obj, leaves: list):
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_structure(o, leaves) for o in obj))
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return (torch.Tensor, tuple(obj.shape), obj.dtype, obj.device)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return (type(obj), obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if not type(obj).__dataclass_params__.frozen:
            raise TypeError(f"a graphed call takes frozen dataclasses only, not "
                            f"{type(obj).__name__}")
        return (dataclasses.dataclass, type(obj),
                tuple((f.name, _structure(getattr(obj, f.name), leaves))
                      for f in dataclasses.fields(obj)))
    raise TypeError(f"a graphed call takes tensors, tuples, lists, frozen dataclasses, "
                    f"None and Python scalars, not {type(obj).__name__}")


def signature(args) -> tuple:
    """(key, tensor leaves) of an argument tuple: the key is the nesting,
    each tensor's (shape, dtype, device), each other leaf's value, and
    :func:`backend_flags`; the leaves are the tensors in order."""
    leaves: List[torch.Tensor] = []
    return (_structure(tuple(args), leaves), backend_flags()), leaves


def rebuild(key: tuple, leaves) -> Any:
    """The arguments of ``key`` (from :func:`signature`) with ``leaves`` in
    place of its tensors: ``rebuild(*signature(args))`` gives ``args``."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind is torch.Tensor:
            return next(it)
        if kind in (tuple, list):
            return kind(build(n) for n in node[1])
        if kind is dataclasses.dataclass:
            return node[1](**{name: build(n) for name, n in node[2]})
        return node[1]
    return build(key[0])


def map_tensors(fn: Callable, obj):
    """``obj`` with ``fn`` applied to each tensor of its tuples and lists."""
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, o) for o in obj)
    return fn(obj) if isinstance(obj, torch.Tensor) else obj


def count_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The launches counted between two snapshots of ``launches.counts``."""
    return {name: after[name] - before[name] for name in after}


def add_counts(counts: Dict[str, int], delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` into ``counts`` in place."""
    for name, n in delta.items():
        counts[name] += times * n


class GraphPool:
    """The memory pool one model's graphs share, made at the first capture."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


@dataclasses.dataclass
class Captured:
    """One captured call: its graph, static inputs (the tensor leaves of the
    arguments, in order) and outputs, the kernel launches a replay makes, the
    seconds the capture took, the replays so far, and the host seconds of
    the warm-up before it (set by :class:`GraphedCall`)."""

    graph: Any
    inputs: List[torch.Tensor]
    output: Any
    launches: Dict[str, int]
    seconds: float
    replays: int = 0
    warm_up_seconds: float = 0.0

    def replay(self) -> None:
        """Replay on the current stream; counts its kernels' launches."""
        self.graph.replay()
        add_counts(kernel_launches.counts, self.launches)
        self.replays += 1


# one side stream per device for every warm-up and capture: the memory one
# warm-up frees stays cached for the next one's (a fresh stream each time
# would leave it to the streams before)
_SIDE_STREAMS: dict = {}


def _side_stream():
    """The current device's side stream for warm-ups and captures."""
    device = torch.cuda.current_device()
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream()
    return _SIDE_STREAMS[device]


def warm_up(fn: Callable, args=(), calls: int = 1):
    """``fn(*args)`` ``calls`` times on the side stream, which the current
    stream then waits for -> the last result.  Run before :func:`capture`:
    whatever a first call does once (an ``nvcc`` build, a library load, a
    cuDNN or cuBLAS algorithm choice, a workspace, the autograd engine's
    device thread) must not happen inside a capture."""
    current, side = torch.cuda.current_stream(), _side_stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(calls):
            out = fn(*args)
    current.wait_stream(side)
    # the result was allocated on the side stream and is read on this one
    map_tensors(lambda t: t.record_stream(current), out)
    return out


def capture(fn: Callable, args=(), pool: Optional[GraphPool] = None) -> Captured:
    """``fn(*args)`` captured into a CUDA graph whose static inputs are
    fresh copies of ``args``' tensors in their memory layouts (a closure's
    tensors are read by address).  The launches it counted are taken back
    out of ``launches.counts`` and kept as a replay's.  The capture runs on
    the side stream, as ``torch.cuda.graph`` runs one, but neither waits for
    the device nor empties the allocator's cache first: a chain's first call
    of each program is set-up that the next eager work should not pay for."""
    t0 = time.perf_counter()
    key, leaves = signature(args)
    inputs = [t.detach().clone() for t in leaves]
    before = dict(kernel_launches.counts)
    graph = torch.cuda.CUDAGraph()
    current, side = torch.cuda.current_stream(), _side_stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        graph.capture_begin(*(() if pool is None else (pool.handle(),)))
        try:
            output = fn(*rebuild(key, inputs))
        finally:
            graph.capture_end()
    current.wait_stream(side)
    launches = count_delta(before, kernel_launches.counts)
    kernel_launches.counts.update(before)
    return Captured(graph, inputs, output, launches, time.perf_counter() - t0)


class GraphedCall:
    """``fn(*args)``, replayed as one CUDA graph per signature on CUDA
    tensors (see the module's docstring); ``plain`` is ``fn`` itself,
    ``name`` names its span and counters, and ``time_device`` times each
    replay on the device while spans record."""

    warm_up_calls = 1

    def __init__(self, fn: Callable, pool: Optional[GraphPool] = None, *, name: str,
                 time_device: bool = False):
        self.plain = fn
        self.time_device = time_device
        self.pool = GraphPool() if pool is None else pool
        self.graphs: Dict[tuple, Captured] = {}
        self._span = f"graph.{name}"
        self._captures = f"graph.captures.{name}"
        self._replays = f"graph.replays.{name}"

    def __call__(self, *args):
        key, leaves = signature(args)
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            raise RuntimeError("a graphed call has no backward; call it under "
                               "torch.no_grad() or on inputs that need no gradient")
        devices = {t.device for t in leaves}
        if len(devices) != 1:
            raise ValueError(f"a graphed call takes its tensors on one device, not "
                             f"{sorted(map(str, devices))}")
        device = devices.pop()
        first = leaves[0] if leaves else None
        rows = first.shape[0] if first is not None and first.dim() else 0
        with torch.no_grad(), profiling.span(self._span, rows) as span:
            if device.type == "cpu":
                return self.plain(*args)
            if device.type != "cuda":
                raise ValueError(f"a graphed call runs on CUDA or the CPU, not {device}")
            with torch.cuda.device(device):
                graph = self.graphs.get(key)
                if graph is None:
                    profiling.count(self._captures)
                    t0 = time.perf_counter()
                    out = warm_up(self.plain, args, self.warm_up_calls)
                    warm_s = time.perf_counter() - t0
                    graph = self.graphs[key] = capture(self.plain, args, self.pool)
                    graph.warm_up_seconds = warm_s
                    return out
                for static, t in zip(graph.inputs, leaves):
                    static.copy_(t)
                with span.device(first if self.time_device else None):
                    graph.replay()
                profiling.count(self._replays)
                return map_tensors(torch.clone, graph.output)

    @property
    def capture_seconds(self) -> float:
        """Seconds spent capturing, over every signature so far (the
        warm-ups are not in it: each graph's ``warm_up_seconds``)."""
        return sum(g.seconds for g in self.graphs.values())


def input_grad(fn: Callable, wrt: int, *args) -> torch.Tensor:
    """d fn(*args) / d args[wrt] of a scalar ``fn``, from a detached leaf, in
    grad mode whatever the caller's (no gradient reaches the other
    arguments or any weight)."""
    p = args[wrt].detach().requires_grad_(True)
    with torch.enable_grad():
        value = fn(*args[:wrt], p, *args[wrt + 1:])
        return torch.autograd.grad(value, p)[0]


class GraphedGrad(GraphedCall):
    """:func:`input_grad` of ``fn`` with respect to argument ``wrt``, forward
    and backward replayed as one CUDA graph per signature on CUDA tensors
    (the counterpart of ``jax.grad`` inside a compiled step).  Every tensor
    argument is an input, copied at each replay; tensors that ``fn`` closes
    over are read by address (fixed for the life of ``fn``).  The result is
    a copy of the gradient.  The warm-up runs forward and backward twice,
    so that the backward's first-call work (cuDNN's and cuBLAS's backward
    algorithms, the autograd engine's device thread) is done before the
    capture.  On CPU tensors it is :func:`input_grad` itself."""

    warm_up_calls = 2

    def __init__(self, fn: Callable, wrt: int, pool: Optional[GraphPool] = None, *,
                 name: str):
        super().__init__(functools.partial(input_grad, fn, wrt), pool, name=name)
