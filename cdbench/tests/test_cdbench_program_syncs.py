"""On the card: every blocking host-device synchronisation of a request
lies inside one of the program's ``sync.*`` spans, and each cell's kind of
request makes the ``sync.*`` calls that ``host_syncs_per_request`` reads
(the tiny cells run the drivers, the pipeline and its mixes' structure of
the full-size cells: the same prompts, chains, scales and chunks)."""

from __future__ import annotations

import gc
import traceback
import warnings
from pathlib import Path

import pytest
import torch

from cdbench.reference.models import PARTS
from cdbench.registry import Registry
from cdbench.spans import Recorder
from cdbench.weights import DTYPES, draw_state_dict
from cyclediffusion_tpu_torch.runtime import profiling

EDIT = {"sync.token_ids": 4, "sync.scales": 2}
REPO = str(Path(__file__).resolve().parents[2])


@pytest.mark.card
@pytest.mark.parametrize("cell, syncs", [
    ("tiny-clip-32.tiny_edit", EDIT),
    ("tiny-bert-32.tiny_edit", EDIT),
    ("tiny-guided-32.tiny_guided", {"sync.token_ids": 2}),
    ("tiny-ensemble-32.tiny_ensemble", {"sync.token_ids": 4, "sync.clip.token_ids": 2,
                                        "sync.scales": 3, "sync.best": 1}),
])
def test_every_sync_of_a_request_is_in_a_sync_span(tiny_root, card, cell, syncs):
    reg = Registry(tiny_root)
    spec = reg.workload(cell)
    cfg, mix = reg.config(spec["config"]), reg.traffic(spec["traffic"])
    driver = reg.driver(mix["driver"])
    seed = 2 ** 32 + 11
    sd = draw_state_dict(cfg["arch"], seed, card, DTYPES[cfg["dtype"]],
                         getattr(driver, "PARTS", PARTS))
    program = driver.Program(cfg, mix, seed, sd, card, DTYPES[cfg["dtype"]], Recorder(card))
    del sd
    gc.collect()
    program.run(driver.make_request(cfg, mix, seed, -1, card))      # set-up's captures
    req = driver.make_request(cfg, mix, seed, 0, card)
    torch.cuda.synchronize()
    inside, outside = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return              # another warning (setting the mode warns once)
        span = profiling._stack[-1].name if profiling._stack else None
        inside.append(span)
        if not (span or "").startswith("sync."):
            frames = [f"{f.filename[len(REPO) + 1:]}:{f.lineno}"
                      for f in traceback.extract_stack() if f.filename.startswith(REPO)]
            outside.append((span, frames[-4:]))

    profiling.reset()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiling.recording():
                    program.run(req)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        calls = {}
        for r in profiling.recorded().spans.values():
            if r.name.startswith("sync."):
                calls[r.name] = calls.get(r.name, 0) + r.calls
        assert inside and not outside, outside
        assert set(inside) == set(syncs)
        assert calls == syncs
    finally:
        profiling.reset()
        program.close()
