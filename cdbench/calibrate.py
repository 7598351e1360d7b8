"""Readings from which a cell's limits are set: the program's gaps to the
float32 reference on many seeds, and the control's (the reference in
float8, ``reference.numerics.to_fp8_control``) on some of them, at the
cell's own sizes.

    python3 cdbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 [--seconds 1] [--out readings.jsonl]

Each program seed is one short run of the harness (set-up, a window of
``--seconds``, the comparison); each control seed compares the control's
outputs of the same request with the reference's.  One JSON line per
reading, then the largest program reading and the smallest control
reading of each number.
"""

import time

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from cdbench import harness
    from cdbench.reference.numerics import set_reference_precision
    from cdbench.registry import Registry

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, mix = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    driver = reg.driver(mix["driver"])
    sink = open(args.out, "a") if args.out else None
    prog, ctrl = {}, {}

    def emit(row):
        print(json.dumps(row), flush=True)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, t0)
        r = out["side"]["readings"]
        for k, v in r.items():
            prog[k] = max(prog.get(k, 0.0), v)
        emit({"kind": "program", "workload": args.workload, "seed": seed, "readings": r,
              "correct": out["line"]["correct"], "images_per_min": out["side"]["images_per_min"],
              "setup_s": out["side"]["setup_s"], "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    set_reference_precision()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        idx = harness.check_requests(seed, 1)[0]
        req = driver.make_request(cfg, mix, seed, idx, "cuda")
        names = getattr(driver, "PARTS", harness.PARTS)
        control = harness.reference_parts(cfg, seed, "cuda", names, control=True)
        got = driver.reference_outputs(cfg, mix, control, req)
        del control
        gc.collect()
        torch.cuda.empty_cache()
        parts = harness.reference_parts(cfg, seed, "cuda", names)
        r = driver.readings(cfg, mix, parts, req, got)
        del parts
        for k, v in r.items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v)
        emit({"kind": "control", "workload": args.workload, "seed": seed, "readings": r,
              "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    emit({"kind": "summary", "workload": args.workload, "program_max": prog,
          "control_min": ctrl, "device": torch.cuda.get_device_name()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
