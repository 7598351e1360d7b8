"""The port's spans and counters, and a Chrome trace of a block.

Usage::

    with span("graph.text", rows=x.shape[0]) as s:   # times the block on the host
        ...
        with s.device(x):                             # and this part on the device
            ...
    with span("sampler.ddim_step") as s, s.device(x, every=SAMPLE_EVERY):
        ...                                           # the device: 1 call in 8
    count("sampler.steps")                            # adds 1

    with recording():                                  # records without a profiler
        ...
    recorded().spans, recorded().counts                # what was recorded
    reset()

    with trace_if_enabled():             # CYCLEDIFFUSION_TRACE_DIR=/tmp/trace
        ...

Recording is on while a ``torch.profiler`` session records (the benchmark's
traced slice, for one) and inside :func:`recording`; otherwise a span is one
check of two flags and returns a shared object that does nothing (no
timestamp, no CUDA event, no profiler range, no allocation), and
:func:`count` returns at once.

A span keeps, for its name under its parent (the innermost span open when
it began, ``None`` for an outermost one): its calls, rows, host
nanoseconds, the host nanoseconds spent in ``sync.*`` spans inside it (a
``sync.*`` span's own time counts as its own), and, for the part of the
block inside the span's :meth:`device` with a CUDA tensor, a CUDA event
pair on the current stream for each call it times (every call, or one in
``every`` of the name's calls), whose milliseconds
:attr:`SpanRecord.device_ms` reads after the caller has synchronised; its
``timed`` calls say how many.  Each pair costs two CUDA API calls, which a
profiler intercepts: a span that is called at every step of a chain times
a sample of its calls.
Where the device's queue may be empty when the span begins, that part
holds the device's work alone (a graph's replay, not the copies issued
before it): an event recorded on an empty queue starts the clock while
the host is still issuing.  Host stamps are on the profiler's clock (the
Unix epoch clock of its recorded events), so a span lies inside the
profiler ranges around it.  One thread records; spans nest as a stack.

Under :func:`trace_if_enabled` each span also opens a
``torch.profiler.record_function`` range of its name, so the operator's
trace shows what the program was doing in each of the device's idle gaps.
Under any other profiler it opens none: a range also appears on the
device's timeline, where a trace reader would take it for device work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_DIR_ENV = "CYCLEDIFFUSION_TRACE_DIR"
# a span whose name starts so blocks the host on the device
SYNC_PREFIX = "sync."
# the share of a per-step span's calls timed on the device: one in SAMPLE_EVERY
SAMPLE_EVERY = 8

# host stamps: the clock torch.profiler's events are converted to
_now = time.time_ns

_recording = False       # inside recording()
_ranges = False          # inside trace_if_enabled(): spans open profiler ranges
_stack: List["_Span"] = []
_spans: Dict[Tuple[str, Optional[str]], "SpanRecord"] = {}
_counts: Dict[str, int] = {}
_device_calls: Dict[str, int] = {}   # device parts asked for, by span name


class SpanRecord:
    """The calls of one span name under one parent."""

    __slots__ = ("name", "parent", "calls", "rows", "host_ns", "sync_ns", "timed",
                 "_device_ms", "_pending")

    def __init__(self, name: str, parent: Optional[str]):
        self.name, self.parent = name, parent
        self.calls = self.rows = self.host_ns = self.sync_ns = self.timed = 0
        self._device_ms = 0.0
        self._pending: list = []

    @property
    def device_ms(self) -> float:
        """The device milliseconds of the ``timed`` calls, between each call's
        CUDA event pair (waits for the events still pending)."""
        for start, end in self._pending:
            end.synchronize()
            self._device_ms += start.elapsed_time(end)
        self._pending.clear()
        return self._device_ms


class Recorded(NamedTuple):
    spans: Dict[Tuple[str, Optional[str]], SpanRecord]   # by (name, parent)
    counts: Dict[str, int]


class _Off:
    """The span of a block that is not recorded, and its device part."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def device(self, on, every: int = 1):
        return self


_OFF = _Off()


class _Device:
    """A span's device part: a CUDA event pair around the block."""

    __slots__ = ("span", "start")

    def __init__(self, span: "_Span"):
        self.span = span

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.span._events.append((self.start, end))
        return None


class _Span:
    __slots__ = ("name", "rows", "parent", "sync_ns", "start_ns", "end_ns",
                 "_events", "_range")

    def __init__(self, name: str, rows: int):
        self.name, self.rows = name, rows

    def device(self, on, every: int = 1):
        """A context manager timing its block on the device, between a CUDA
        event pair on the current stream, where ``on`` is a CUDA tensor, no
        capture is under way and this is the last of each ``every`` device
        parts of the span's name since :func:`reset` (not the first: a
        chain's first step may follow a drained queue, where the pair
        would time the host's issuing); otherwise it does nothing."""
        n = _device_calls.get(self.name, 0)
        _device_calls[self.name] = n + 1
        if (n % every != every - 1 or on is None or not on.is_cuda
                or torch.cuda.is_current_stream_capturing()):
            return _OFF
        return _Device(self)

    def __enter__(self):
        self.parent = _stack[-1].name if _stack else None
        self.sync_ns = 0
        self._range = None
        self._events = []
        if _ranges:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        _stack.append(self)
        self.start_ns = _now()
        return self

    def __exit__(self, *exc):
        self.end_ns = _now()
        _stack.pop()
        host = self.end_ns - self.start_ns
        if self.name.startswith(SYNC_PREFIX):
            self.sync_ns = host
            for outer in _stack:
                outer.sync_ns += host
        key = (self.name, self.parent)
        rec = _spans.get(key)
        if rec is None:
            rec = _spans[key] = SpanRecord(self.name, self.parent)
        rec.calls += 1
        rec.rows += self.rows
        rec.host_ns += host
        rec.sync_ns += self.sync_ns
        if self._events:
            rec._pending.extend(self._events)
            rec.timed += 1
        if self._range is not None:
            self._range.__exit__(*exc)
        return None


def span(name: str, rows: int = 0):
    """A context manager recording the block under ``name`` (see the
    module's docstring); ``rows`` is added to its rows.  The object it
    gives times a part of the block on the device: ``.device(tensor)``."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, rows)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    _counts[name] = _counts.get(name, 0) + n


def recorded() -> Recorded:
    """What was recorded since the last :func:`reset`."""
    return Recorded(dict(_spans), dict(_counts))


def reset() -> None:
    """Forget what was recorded."""
    _spans.clear()
    _counts.clear()
    _device_calls.clear()


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, profiler or not."""
    global _recording
    before = _recording
    _recording = True
    try:
        yield
    finally:
        _recording = before


@contextlib.contextmanager
def trace_if_enabled():
    """A ``torch.profiler`` trace of the block when ``CYCLEDIFFUSION_TRACE_DIR``
    is set: host activity with the program's spans as ranges, and the card's
    kernels when CUDA is available, written as a Chrome trace
    (``trace.json``) into that directory."""
    global _ranges
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    before = _ranges
    _ranges = True
    try:
        with recording(), profile(activities=activities) as prof:
            yield
    finally:
        _ranges = before
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
