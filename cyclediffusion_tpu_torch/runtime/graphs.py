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
* Every tensor argument is an input of the graph, copied at each replay,
  so nothing that changes between calls (the latent, the timesteps, a text
  context, a fast-mode cache) is read by address from the call that was
  captured: JAX's rule that parameters are traced arguments, not
  closures.  Model weights are read by address: they must be updated in
  place (``load_state_dict`` does), never replaced.
* Results are copies of the graph's static outputs, made as the replay's
  last step, so a result outlives the next replay of the same graph (the
  fast mode's cache is kept across the reuse calls that follow its key
  call, and callers hold an eps across calls).
* Graphs of one model share one :class:`GraphPool` (replays are sequential
  on the current stream).

The kernel wrappers of ``ops.flash_attention`` count their launches in
Python, so a replay would count nothing: a capture records what it added
to ``launch_counts`` (and takes it back, since capturing launches
nothing), and each replay adds it once.

Gradients: a replay cannot be differentiated.  In grad mode an input that
requires a gradient is refused (on every device, as the kernels refuse
one), and the call runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from cyclediffusion_tpu_torch.ops import flash_attention as fa


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
    raise TypeError(f"a graphed call takes tensors, tuples, lists, None and Python "
                    f"scalars, not {type(obj).__name__}")


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
        return node[1]
    return build(key[0])


def map_tensors(fn: Callable, obj):
    """``obj`` with ``fn`` applied to each tensor of its tuples and lists."""
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, o) for o in obj)
    return fn(obj) if isinstance(obj, torch.Tensor) else obj


def count_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The launches counted between two snapshots of ``launch_counts``."""
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
    seconds the capture took, and the replays so far."""

    graph: Any
    inputs: List[torch.Tensor]
    output: Any
    launches: Dict[str, int]
    seconds: float
    replays: int = 0

    def replay(self) -> None:
        """Replay on the current stream; counts its kernels' launches."""
        self.graph.replay()
        add_counts(fa.launch_counts, self.launches)
        self.replays += 1


def warm_up(fn: Callable, args=()):
    """``fn(*args)`` on a side stream, which the current stream then waits
    for -> its result.  Run before :func:`capture`: whatever a first call
    does once (an ``nvcc`` build, a library load, a cuDNN or cuBLAS
    algorithm choice, a workspace) must not happen inside a capture."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn(*args)
    current.wait_stream(side)
    # the result was allocated on the side stream and is read on this one
    map_tensors(lambda t: t.record_stream(current), out)
    return out


def capture(fn: Callable, args=(), pool: Optional[GraphPool] = None) -> Captured:
    """``fn(*args)`` captured into a CUDA graph whose static inputs are
    fresh contiguous copies of ``args``' tensors (a closure's tensors are
    read by address).  The launches it counted are taken back out of
    ``launch_counts`` and kept as a replay's."""
    t0 = time.perf_counter()
    key, leaves = signature(args)
    inputs = [t.detach().clone(memory_format=torch.contiguous_format) for t in leaves]
    before = dict(fa.launch_counts)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=None if pool is None else pool.handle()):
        output = fn(*rebuild(key, inputs))
    launches = count_delta(before, fa.launch_counts)
    fa.launch_counts.update(before)
    return Captured(graph, inputs, output, launches, time.perf_counter() - t0)


class GraphedCall:
    """``fn(*args)``, replayed as one CUDA graph per signature on CUDA
    tensors (see the module's docstring); ``plain`` is ``fn`` itself."""

    def __init__(self, fn: Callable, pool: Optional[GraphPool] = None):
        self.plain = fn
        self.pool = GraphPool() if pool is None else pool
        self.graphs: Dict[tuple, Captured] = {}

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
        with torch.no_grad():
            if device.type == "cpu":
                return self.plain(*args)
            if device.type != "cuda":
                raise ValueError(f"a graphed call runs on CUDA or the CPU, not {device}")
            with torch.cuda.device(device):
                graph = self.graphs.get(key)
                if graph is None:
                    out = warm_up(self.plain, args)
                    self.graphs[key] = capture(self.plain, args, self.pool)
                    return out
                for static, t in zip(graph.inputs, leaves):
                    static.copy_(t)
                graph.replay()
                return map_tensors(torch.clone, graph.output)

    @property
    def capture_seconds(self) -> float:
        """Seconds spent capturing, over every signature so far (the
        warm-ups, each one call, are not in it)."""
        return sum(g.seconds for g in self.graphs.values())
