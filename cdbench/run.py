"""Run one cell of the benchmark once and print its result line.

    python3 cdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m cdbench.run ...``) from the root of a checkout.  Exits
non-zero with no result when no CUDA device is present, when fewer cards
are present than the cell asks for, or when a JAX module or the JAX
package was loaded.  The last lines on standard error are each compared
number beside its limit; the last line on standard output is the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "cdbench" / ".cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # kernel caches at fixed paths inside the checkout; no library may pull in JAX
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from cdbench import harness
    from cdbench.registry import Registry

    chips = Registry(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), T0)
    except harness.GuardError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    side = out["side"]
    print(f"run: images_per_min {side['images_per_min']:.4f} window_s {side['window_s']:.3f} "
          f"setup_s {side['setup_s']:.3f} check_s {side['check_s']:.3f} readings {json.dumps(side['readings'])}",
          file=sys.stderr)
    print("run: request_s " + " ".join(f"{t:.4f}" for t in side["request_s"]),
          file=sys.stderr)
    for name, value, limit in out["rows"]:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(f"check failed_requests: {out['line']['failed']} limit 0", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
