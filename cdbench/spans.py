"""Spans and counters recorded from the benchmark's side of the program's
entry points.

:meth:`Recorder.wrap` replaces a bound entry point on its owner with a
wrapper that, while ``timing`` is on, counts the rows (the leading
dimension of the first argument, or what ``rows`` says) and brackets the call with CUDA
events and a profiler range named after the layer.  While ``keep`` holds a
list, each call's arguments and result are appended to it under the
layer's name: the states and outputs the correctness check compares.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, List, Optional

import torch


class Recorder:
    def __init__(self, device):
        self.device = torch.device(device)
        self.timing = False
        self.keep: Optional[List] = None
        self.rows: Dict[str, int] = collections.Counter()
        self.events: Dict[str, list] = collections.defaultdict(list)
        self.layers: List[str] = []

    def wrap(self, owner, attr: str, layer: str, rows: Optional[Callable] = None) -> None:
        fn = getattr(owner, attr)
        self.layers.append(layer)

        def wrapper(*args, **kwargs):
            timed = self.timing and self.device.type == "cuda"
            with (torch.profiler.record_function(layer) if self.timing
                  else contextlib.nullcontext()):
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                out = fn(*args, **kwargs)
                if timed:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.events[layer].append((start, end))
            if self.timing:
                self.rows[layer] += int(rows(args, out) if rows else args[0].shape[0])
            if self.keep is not None:
                self.keep.append((layer, args, out))
            return out

        setattr(owner, attr, wrapper)

    def device_ms(self, layer: str) -> float:
        """Summed event time of a layer's calls (after a synchronize)."""
        return sum(s.elapsed_time(e) for s, e in self.events.get(layer, ()))
