"""Profiling and phase counters (counterpart of
``cyclediffusion_tpu.runtime.profiling``).

Usage::

    with trace_if_enabled():             # CYCLEDIFFUSION_TRACE_DIR=/tmp/trace
        ...

    counters = PhaseCounters()
    with counters.phase("encode", units=n_chains):
        ...
    counters.summary()   # {'encode_s': ..., 'encode_units_per_s': ...}
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

TRACE_DIR_ENV = "CYCLEDIFFUSION_TRACE_DIR"


@contextlib.contextmanager
def trace_if_enabled():
    """A ``torch.profiler`` trace of the block when ``CYCLEDIFFUSION_TRACE_DIR``
    is set: host activity, and the card's kernels when CUDA is available,
    written as a Chrome trace (``trace.json``) into that directory."""
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class PhaseCounters:
    """Accumulating wall-time + unit counters per named phase."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.units: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, units: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.units[name] += units

    def summary(self) -> Dict[str, float]:
        out = {}
        for name, secs in self.seconds.items():
            out[f"{name}_s"] = round(secs, 4)
            if self.units[name] and secs > 0:
                out[f"{name}_units_per_s"] = round(self.units[name] / secs, 3)
        return out
