"""The traced slice of a run: ``torch.profiler`` over a few whole requests,
reduced in memory (no trace file) to the device's busy time, the kernels'
time by name and the longest idle gaps, each named by the innermost range
the harness had open on the host at the time.  The slice's length is the
device's own: from the start of its first operation to the end of its
last, so that the profiler's start and stop on the host are not in it."""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class TraceSummary:
    busy_s: float                       # union of device activity
    window_s: float                     # first device operation's start to last's end
    kernel_s: Dict[str, float]          # device seconds by kernel name
    gaps: List[Tuple[str, float]]       # longest idle gaps, by host range
    events: int

    def top_ops(self, n: int = 10, name_chars: int = 300) -> List[list]:
        """The ``n`` kernels that took most time, their names without the
        namespaces that say nothing, cut to ``name_chars``."""
        def short(name):
            for noise in ("(anonymous namespace)::", "at::native::", "void "):
                name = name.replace(noise, "")
            return name[:name_chars]
        return [[short(k), v]
                for k, v in sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]]

    def seconds_matching(self, patterns) -> float:
        return sum(v for k, v in self.kernel_s.items() if any(p in k for p in patterns))


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns) of every recorded event."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type()
        is_device = dev != torch.autograd.DeviceType.CPU
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        out.append((e.name(), is_device, int(start), int(start) + int(dur)))
    return out


def summarize(prof, host_ranges=()) -> TraceSummary:
    """``host_ranges``: the names of the harness's own host ranges, used to
    say what the host did during each idle gap."""
    events = _raw_events(prof)
    # a host range also appears on the device's timeline (a GPU user
    # annotation): only kernels, copies and sets count there
    dev = sorted((s, e, n) for n, d, s, e in events if d and e > s and n not in host_ranges)
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, name in dev:
        kernel_s[name] += (e - s) / 1e9
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    ranges = [(s, e, n) for n, d, s, e in events if not d and n in host_ranges]
    gap_rows = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (gs + ge) // 2
        inside = [(e - s, n) for s, e, n in ranges if s <= mid <= e]
        gap_rows.append((min(inside)[1] if inside else "host outside the harness's ranges",
                         (ge - gs) / 1e9))
    span = max(e for _, e, _ in dev) - dev[0][0] if dev else 0
    return TraceSummary(busy / 1e9, span / 1e9, dict(kernel_s), gap_rows, len(dev))
