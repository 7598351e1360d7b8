"""The readers of the program's own spans and counters against a store
seeded through the program's ``runtime.profiling`` (device times from
stand-in CUDA events), a run record of two traced requests, an empty
store and a program without the store."""

from __future__ import annotations

import types

import pytest
import torch

from cdbench.registry import Registry
from cdbench.tests.conftest import REPO
from cyclediffusion_tpu_torch.runtime import profiling

NEW = ("host_syncs_per_request", "text_ms_per_prompt", "sampler_ms_per_step",
       "graph_captures_per_request")


class _Event:
    """Each pair reads 1.5 ms."""

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.5


@pytest.fixture
def readers():
    reg = Registry(REPO)
    return {name: reg._module("metrics", name) for name in NEW}


@pytest.fixture
def store():
    profiling.reset()
    yield
    profiling.reset()


def _seed(monkeypatch):
    """Two requests: each a pipeline span around 4 token-id copies, 4
    prompts' text graph (2 calls), 3 sampler steps of 2 spans each (one
    timed on every call, one on one call in 2), one capture; one
    outermost sync besides."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    card = types.SimpleNamespace(is_cuda=True)
    with profiling.recording():
        for _ in range(2):
            with profiling.span("pipeline.encode"):
                for _ in range(2):
                    with profiling.span("sync.token_ids"):
                        pass
                    with profiling.span("graph.text", rows=2) as s, s.device(card):
                        pass
                for _ in range(2):
                    with profiling.span("sync.token_ids"):
                        pass
                for _ in range(3):
                    profiling.count("sampler.steps")
                    with profiling.span("sampler.ddim_step") as s, s.device(card):
                        pass
                    with profiling.span("sampler.cfg_combine") as s, s.device(card, 2):
                        pass
                profiling.count("graph.captures.unet")
                profiling.count("graph.replays.unet", 3)
            with profiling.span("sync.best"):
                pass


def test_readers_on_a_seeded_store(readers, store, monkeypatch):
    _seed(monkeypatch)
    run = types.SimpleNamespace(slice_requests=2)
    got = {name: readers[name].read(run) for name in NEW}
    assert got == {"host_syncs_per_request": 5.0, "text_ms_per_prompt": 1.5 * 4 / 8,
                   "sampler_ms_per_step": 1.5 * 12 / 6, "graph_captures_per_request": 1.0}


def test_readers_on_a_cpu_store(readers, store):
    """Recorded without device events (the CPU): the device readers give
    None, the counters their numbers, 0 captures included."""
    with profiling.recording():
        with profiling.span("pipeline.generate"):
            with profiling.span("graph.text", rows=2):
                pass
            profiling.count("sampler.steps")
            with profiling.span("sampler.ddim_step"):
                pass
    run = types.SimpleNamespace(slice_requests=1)
    got = {name: readers[name].read(run) for name in NEW}
    assert got["text_ms_per_prompt"] is None and got["sampler_ms_per_step"] is None
    assert got["host_syncs_per_request"] == 0 and got["graph_captures_per_request"] == 0


def test_readers_without_a_record(readers, store, monkeypatch):
    run = types.SimpleNamespace(slice_requests=1)
    assert all(readers[name].read(run) is None for name in NEW)
    # a program that has no store (the port before its spans)
    monkeypatch.delattr(profiling, "recorded")
    assert all(readers[name].read(run) is None for name in NEW)
