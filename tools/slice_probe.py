"""A benchmark cell's run (``cdbench/run.py``) with the program's spans and
counters on or forced off, and, in a traced run, where the host's time
inside the harness's ``pipeline`` ranges of the traced slice went.

    python3 tools/slice_probe.py --spans <0|1> -- --workload <cell> --seed <n> --seconds <s> --trace 1

``--spans 0`` makes every ``profiling.span`` the shared object that does
nothing and every ``profiling.count`` a no-op, even while the profiler
records, so that two traced runs of one seed, ``--spans 1`` and
``--spans 0``, show what the program's spans do to the traced slice
(``device_idle_share``, ``step_mfu``).  In a traced run one line on
standard error, ``slice_host {...}``, gives per request of the slice: the
host milliseconds inside the ``pipeline`` ranges, those inside CUDA
runtime and driver calls there by call name (a launch that waits for room
in a full launch queue is long), and, with ``--spans 1``, the program's
host milliseconds inside its outermost spans less their ``sync.*`` spans
(``enqueue_ms``).  Run's own output follows unchanged.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def slice_host(prof, requests: int) -> dict:
    """Host ms a request inside the ``pipeline`` ranges, and in the CUDA
    runtime and driver calls that lie inside them, by name."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.device_type() == cpu]
    ranges = sorted((s, e) for n, s, e in events if n == "pipeline")
    calls = {}
    for name, s, e in events:
        if not name.startswith("cu") or e <= s:
            continue
        if any(rs <= s and e <= re for rs, re in ranges):
            ns, n = calls.get(name, (0, 0))
            calls[name] = (ns + e - s, n + 1)
    top = sorted(calls.items(), key=lambda kv: -kv[1][0])[:12]
    return {"pipeline_ms": sum(e - s for s, e in ranges) / 1e6 / requests,
            "runtime_ms": sum(ns for ns, _ in calls.values()) / 1e6 / requests,
            "by_call": {name: [ns / 1e6 / requests, n / requests] for name, (ns, n) in top}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv[:split])
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from cdbench import harness, run, trace
    from cyclediffusion_tpu_torch.runtime import profiling

    if not args.spans:
        profiling.span = lambda name, rows=0: profiling._OFF
        profiling.count = lambda name, n=1: None
    summarize = trace.summarize

    def summarize_and_report(prof, host_ranges=()):
        out = slice_host(prof, harness.TRACE_REQUESTS)
        if args.spans:
            outer = [r for r in profiling.recorded().spans.values() if r.parent is None]
            out["enqueue_ms"] = (sum(r.host_ns - r.sync_ns for r in outer) / 1e6
                                 / harness.TRACE_REQUESTS)
        print("slice_host " + json.dumps(out), file=sys.stderr)
        return summarize(prof, host_ranges)

    trace.summarize = summarize_and_report
    return run.main(argv[split + 1:])


if __name__ == "__main__":
    sys.exit(main())
