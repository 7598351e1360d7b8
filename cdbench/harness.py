"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

Closed loop: one client sends the cell's next request when the last one
has completed, for ``seconds`` seconds; each request's completion is a
``torch.cuda.synchronize()``.  ``images_per_min`` is the images of every
completed request times 60 over the seconds from the window's start to the
last completion.  With ``trace`` the CUDA events of the wrapped entry
points are on for the whole window, and ``torch.profiler`` records the
request after the window's first (``TRACE_REQUESTS``); the per-layer
readers reduce both.
"""

from __future__ import annotations

import gc
import time
import types

import torch

from cdbench import compare, guard, trace as tracing
from cdbench.reference.numerics import set_reference_precision
from cdbench.registry import Registry, family
from cdbench.spans import Recorder
from cdbench.weights import DTYPES, derive_seed, draw_state_dict

GIB = 2 ** 30
# the harness's own host ranges (besides the wrapped layers'), by which the
# traced slice names its idle gaps
HOST_RANGES = ("pipeline", "make_request", "synchronize")
# the comparison takes CHECK_REQUESTS requests drawn from the seed among the
# window's first CHECK_AMONG_FIRST, whose outputs the window keeps
CHECK_REQUESTS, CHECK_AMONG_FIRST = 1, 2
# the profiler's slice: this many whole requests, from the window's second
TRACE_REQUESTS = 1


class GuardError(RuntimeError):
    pass


def check_guard() -> None:
    found = guard.loaded_banned()
    if found:
        raise GuardError(f"banned modules loaded in the benchmark's process: {found}")


def check_requests(seed: int, completed: int) -> list:
    """The request indices compared, drawn from the seed among the first
    ``CHECK_AMONG_FIRST`` (or all completed ones, if fewer)."""
    import random

    pool = list(range(min(CHECK_AMONG_FIRST, completed)))
    rng = random.Random(derive_seed(seed, "check"))
    return sorted(rng.sample(pool, min(CHECK_REQUESTS, len(pool))))


def part_names(cfg: dict, driver=None) -> tuple:
    """The parts a cell draws and compares: its model family's ``PARTS``,
    then those its driver adds (``EXTRA_PARTS``: the scorer)."""
    return tuple(family(cfg, "reference").PARTS) + tuple(getattr(driver, "EXTRA_PARTS", ()))


def reference_parts(cfg: dict, seed: int, device, parts=None, control: bool = False) -> dict:
    """The reference's modules ``parts`` (by default the family's) with
    the run's weights, float32 (or the float8 control)."""
    from cdbench.reference.numerics import to_fp8_control

    names = parts or part_names(cfg)
    sd = draw_state_dict(cfg, seed, device, DTYPES[cfg["dtype"]], names)
    parts = family(cfg, "reference").build_parts(cfg["arch"], device, names)
    for prefix, module in parts.values():
        module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                if k.startswith(prefix)}, strict=True)
        if control:
            to_fp8_control(module)
    return parts


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda") -> dict:
    reg = Registry(root)
    cell = reg.workload(workload)
    cfg, mix = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(workload)
    driver = reg.driver(mix["driver"])
    device = torch.device(device)
    dtype = DTYPES[cfg["dtype"]]
    on_card = device.type == "cuda"

    # ---- set-up ---------------------------------------------------------- #
    recorder = Recorder(device)
    parts = part_names(cfg, driver)
    sd = draw_state_dict(cfg, seed, device, dtype, parts)
    program = driver.Program(cfg, mix, seed, sd, device, dtype, recorder)
    del sd
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        # the benchmark's own copy of the weights is gone: the peak from
        # here on is the program's
        torch.cuda.reset_peak_memory_stats()
    program.run(driver.make_request(cfg, mix, seed, -1, device))
    if trace:
        # the profiler's own start-up (CUPTI) before the window, not in the slice
        with torch.profiler.profile(activities=profiler_activities(on_card)):
            torch.ones(8, device=device).sum().item()
    if on_card:
        torch.cuda.synchronize()
    check_guard()
    setup_s = time.perf_counter() - t0

    # ---- the window ------------------------------------------------------ #
    recorder.timing = trace
    kept, finite, request_s = {}, [], []
    slice_rows = {}
    prof = None
    i, completed_images = 0, 0
    start = time.perf_counter()
    end = start
    trace_first, trace_n = 1, TRACE_REQUESTS
    while (end - start < seconds
           or (trace and i < trace_first + trace_n)):
        if trace and i == trace_first:
            prof = torch.profiler.profile(activities=profiler_activities(on_card))
            prof.__enter__()
            slice_rows = dict(recorder.rows)
        with torch.profiler.record_function("make_request"):
            req = driver.make_request(cfg, mix, seed, i, device)
        recorder.keep = [] if i < CHECK_AMONG_FIRST else None
        with torch.profiler.record_function("pipeline"):
            out = program.run(req)
        finite.append(torch.isfinite(out["images"]).all())
        if recorder.keep is not None:
            kept[i] = driver.program_outputs(out, recorder.keep, mix)
        recorder.keep = None
        if on_card:
            with torch.profiler.record_function("synchronize"):
                torch.cuda.synchronize()
        now = time.perf_counter()
        request_s.append(now - end)
        end = now
        completed_images += driver.images_per_request(mix)
        i += 1
        if prof is not None and i == trace_first + trace_n:
            slice_rows = {k: v - slice_rows.get(k, 0) for k, v in recorder.rows.items()}
            prof.__exit__(None, None, None)
    window_s = end - start
    attempted = i
    failed = sum(not bool(f) for f in finite)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    check_guard()

    # ---- the record the readers see --------------------------------------- #
    record = None
    if trace:
        summary = tracing.summarize(prof, HOST_RANGES + tuple(recorder.layers))
        flops = counts_per_request(cfg, mix, driver)
        record = types.SimpleNamespace(
            cfg=cfg, mix=mix, workload=workload, recorder=recorder, trace=summary,
            slice_requests=trace_n, slice_rows=slice_rows,
            flops_per_request=flops, requests=attempted, driver=driver)
        del prof
    program.close()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- correct ------------------------------------------------------- #
    check_start = time.perf_counter()
    set_reference_precision()
    parts = reference_parts(cfg, seed, device, parts)
    readings = {}
    for idx in check_requests(seed, attempted):
        req = driver.make_request(cfg, mix, seed, idx, device)
        for name, value in driver.readings(cfg, mix, parts, req, kept[idx]).items():
            readings[name] = max(readings.get(name, 0.0), value)
    del parts
    correct, rows = compare.judge(readings, limits)
    correct = correct and failed == 0
    check_s = time.perf_counter() - check_start

    # ---- the line ------------------------------------------------------- #
    metrics, breakdown, dev = {}, None, device_info(cell, device, peak)
    if trace:
        for name, (entry, reader) in reg.per_layer(workload).items():
            value = reader.read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": entry["unit"]}
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        breakdown = {"device_ops": record.trace.top_ops(10),
                     "idle_gaps": [[n, s] for n, s in record.trace.gaps]}
    else:
        values = {"images_per_min": completed_images * 60.0 / window_s,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for entry in reg.end_to_end(workload):
            metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    line["checks"]["failed_requests"] = {"value": failed, "limit": 0}
    side = {"images_per_min": completed_images * 60.0 / window_s, "window_s": window_s,
            "setup_s": setup_s, "check_s": check_s, "readings": readings,
            "request_s": request_s}
    return {"line": line, "rows": rows, "side": side}


def profiler_activities(on_card: bool) -> list:
    acts = torch.profiler.ProfilerActivity
    return [acts.CPU] + ([acts.CUDA] if on_card else [])


def counts_per_request(cfg: dict, mix: dict, driver) -> float:
    per_unit = cfg["counts"]
    return float(sum(n * per_unit[unit] for unit, n in driver.work_per_request(cfg, mix).items()))


def device_info(cell: dict, device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
