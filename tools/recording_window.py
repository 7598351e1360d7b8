"""One benchmark cell's window with the program's own spans and counters
recording over every request.

    python3 tools/recording_window.py --workload <cell> --seed <n> --seconds <s> --record <0|1>

It runs the cell as ``run.py --trace 0`` does (set-up, warm-up, the
closed-loop window), with ``cyclediffusion_tpu_torch.runtime.profiling``
recording over every request of the window when ``--record 1``, and
without the comparison with the reference.  Its last line on standard
output: ``images_per_min``, the window, and per request its seconds and,
with ``--record 1``, the host milliseconds inside the program's outermost
spans less their ``sync.*`` spans (``enqueue_ms``), those of the ``sync.*``
spans (``sync_ms``), their calls (``syncs``) and the host milliseconds of
each span name (``host_ms``); and over the window each
span name's calls, host and device milliseconds.  ``--record 0`` and
``--record 1`` in turns, each in a process of its own, give what recording
costs ``images_per_min``.  It reaches into ``cdbench.harness`` (its check
and its driver registry are replaced for the run), so it may need
mending when the harness changes.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    return p.parse_args(argv)


def _totals(profiling) -> dict:
    """Host ns issuing work, host ns in syncs, sync calls, and host ns by
    span name, so far."""
    spans = profiling.recorded().spans.values()
    outer = [r for r in spans if r.parent is None]
    by_name = {}
    for r in spans:
        by_name[r.name] = by_name.get(r.name, 0) + r.host_ns
    return {"enqueue": sum(r.host_ns - r.sync_ns for r in outer),
            "sync": sum(r.host_ns for r in spans if r.name.startswith("sync.")),
            "syncs": sum(r.calls for r in spans if r.name.startswith("sync.")),
            "by_name": by_name}


def recorded_driver(registry_cls, profiling, per_request: list):
    """``Registry.driver`` whose ``Program.run`` records every request after
    the first (set-up's warm-up), and keeps each one's host totals."""
    load = registry_cls.driver

    def driver(self, name):
        module = load(self, name)
        base = module.Program

        class Program(base):
            calls = 0

            def run(self, req):
                Program.calls += 1
                if Program.calls == 1:
                    return base.run(self, req)
                before = _totals(profiling)
                with profiling.recording():
                    out = base.run(self, req)
                after = _totals(profiling)
                per_request.append({
                    "enqueue_ms": (after["enqueue"] - before["enqueue"]) / 1e6,
                    "sync_ms": (after["sync"] - before["sync"]) / 1e6,
                    "syncs": after["syncs"] - before["syncs"],
                    "host_ms": {name: (ns - before["by_name"].get(name, 0)) / 1e6
                                for name, ns in after["by_name"].items()}})
                return out

        module.Program = Program
        return module
    return driver


def window(args, root=ROOT, device="cuda") -> dict:
    from cdbench import compare, harness
    from cdbench.registry import Registry
    from cyclediffusion_tpu_torch.runtime import profiling

    # the window alone: no comparison with the reference
    harness.check_requests = lambda seed, completed: []
    harness.reference_parts = lambda *a, **k: {}
    compare.judge = lambda readings, limits: (True, [])
    per_request = []
    if args.record:
        Registry.driver = recorded_driver(Registry, profiling, per_request)
    out = harness.run_cell(root, args.workload, args.seed, args.seconds, False, T0, device)
    side = out["side"]
    requests = [{"s": s} for s in side["request_s"]]
    for row, rec in zip(requests, per_request):
        row.update(rec)
    spans = {}
    for r in profiling.recorded().spans.values():
        calls, host_ms, device_ms = spans.get(r.name, (0, 0.0, 0.0))
        spans[r.name] = (calls + r.calls, host_ms + r.host_ns / 1e6, device_ms + r.device_ms)
    return {"workload": args.workload, "seed": args.seed, "record": args.record,
            "images_per_min": side["images_per_min"], "window_s": side["window_s"],
            "setup_s": side["setup_s"], "requests": requests,
            "spans": {name: {"calls": c, "host_ms": h, "device_ms": d}
                      for name, (c, h, d) in sorted(spans.items())}}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no result: needs a CUDA device", file=sys.stderr)
        return 2
    result = window(args)
    result["card"] = card()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
