"""The port's spans and counters (``runtime/profiling.py``): nothing but a
flag check while nothing records, host stamps on the profiler's own clock,
nesting and the host time spent in ``sync.*`` spans, what a tiny edit
records on the CPU under a foreign ``torch.profiler`` (and that it opens no
range there), and the span names as ranges in ``trace_if_enabled``'s
Chrome trace."""

from __future__ import annotations

import json
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cyclediffusion_tpu_torch.runtime import profiling


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


class _FakeEvent:
    """A CUDA event's surface, counted; each pair reads 2.5 ms."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


def _count_calls(monkeypatch, owner, attr):
    calls = []
    real = getattr(owner, attr)

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(owner, attr, counted)
    return calls


def test_off_a_span_costs_one_check(monkeypatch):
    """With no profiler and no ``recording()``, a span takes no timestamp,
    makes no CUDA event, opens no profiler range and records nothing, and
    every span and its device part are the same shared object; recording
    on, the same span's device part on a CUDA tensor makes its event pair."""
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    stamps = _count_calls(monkeypatch, profiling, "_now")
    ranges = _count_calls(monkeypatch, torch.profiler, "record_function")
    on_card = types.SimpleNamespace(is_cuda=True)
    assert not (profiling._recording or torch.autograd.profiler._is_profiler_enabled)
    assert profiling.span("a", 3) is profiling.span("b") is profiling.span("c").device(on_card)
    with profiling.span("graph.unet", rows=8) as s, s.device(on_card):
        with profiling.span("sync.token_ids"):
            pass
    profiling.count("sampler.steps")
    assert (len(stamps), _FakeEvent.made, len(ranges)) == (0, 0, 0)
    assert profiling.recorded() == ({}, {})

    with profiling.recording():
        with profiling.span("graph.unet", rows=8) as s, s.device(on_card):
            pass
        profiling.count("sampler.steps", 2)
    assert (len(stamps), _FakeEvent.made, len(ranges)) == (2, 2, 0)
    rec = profiling.recorded()
    unet = rec.spans[("graph.unet", None)]
    assert (unet.calls, unet.rows, unet.timed, unet.device_ms) == (1, 8, 1, 2.5)
    assert rec.counts == {"sampler.steps": 2}


def test_a_device_part_times_its_block_alone(monkeypatch):
    """The CUDA events of a span's device part are recorded around that
    block only (a graph's replay, not the copy-in before it or the copy-out
    after it); a span with none, on a CPU tensor or during a capture, has
    no device time; each device part of one call adds its pair."""
    log = []

    class Event(_FakeEvent):
        def record(self):
            log.append("event")

    monkeypatch.setattr(torch.cuda, "Event", Event)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    on_card = types.SimpleNamespace(is_cuda=True)
    with profiling.recording():
        with profiling.span("graph.text", rows=4) as s:
            log.append("copy-in")
            with s.device(on_card):
                log.append("replay")
            log.append("copy-out")
        with profiling.span("graph.unet") as s:
            with s.device(torch.ones(1)):
                log.append("cpu")
            capturing[0] = True
            with s.device(on_card):
                log.append("capture")
            capturing[0] = False
            with s.device(None):
                pass
        with profiling.span("sampler.pair") as s:
            for _ in range(2):
                with s.device(on_card):
                    log.append("step")
    assert log == ["copy-in", "event", "replay", "event", "copy-out", "cpu", "capture",
                   "event", "step", "event", "event", "step", "event"]
    spans = profiling.recorded().spans
    text, unet, pair = (spans[(n, None)] for n in ("graph.text", "graph.unet", "sampler.pair"))
    assert (text.timed, text.device_ms, text.rows) == (1, 2.5, 4)
    assert (unet.calls, unet.timed, unet.device_ms) == (1, 0, 0.0)
    assert (pair.calls, pair.timed, pair.device_ms) == (1, 1, 5.0)


def test_a_sampled_device_part_times_one_call_in_every(monkeypatch):
    """``device(on, every)`` times the last of each ``every`` calls of the
    span's name (under any parent), counted from :func:`reset`; the
    record's ``timed`` says how many, ``calls`` how many there were."""
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    on_card = types.SimpleNamespace(is_cuda=True)

    def steps(n, parent=None):
        with profiling.recording():
            for _ in range(n):
                with profiling.span(parent or "chain"):
                    with profiling.span("sampler.ddim_step") as s, s.device(on_card, 3):
                        pass

    steps(5)
    steps(2, "chain.guided")
    spans = profiling.recorded().spans
    a, b = spans[("sampler.ddim_step", "chain")], spans[("sampler.ddim_step", "chain.guided")]
    assert (a.calls, a.timed, a.device_ms) == (5, 1, 2.5)      # call 2
    assert (b.calls, b.timed, b.device_ms) == (2, 1, 2.5)      # call 5
    assert _FakeEvent.made == 2 * 2
    profiling.reset()
    steps(3)
    assert profiling.recorded().spans[("sampler.ddim_step", "chain")].timed == 1


def test_span_stamps_lie_inside_the_profilers_range():
    """A span's host stamps are on the clock of the profiler's recorded
    events: inside ``outer`` as ``kineto_results`` has it (with the card's
    activity too where there is a card)."""
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        with record_function("outer"):
            time.sleep(0.002)
            with profiling.span("inner") as s:
                if card:
                    torch.ones(8, device="cuda").sum().item()
                time.sleep(0.002)
            time.sleep(0.002)
    # the range's host event (with the card, a device annotation of it too)
    (outer,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "outer" and e.device_type() == torch.autograd.DeviceType.CPU]
    start = outer.start_ns()
    end = start + outer.duration_ns()
    assert start < s.start_ns < s.end_ns < end, (start, s.start_ns, s.end_ns, end)
    assert s.end_ns - s.start_ns >= 2_000_000


def test_nesting_outermost_spans_and_sync_time():
    """Records are kept by (name, parent); a ``sync.*`` span's host time is
    its own sync time and every enclosing span's; the stack unwinds through
    an exception."""
    with profiling.recording():
        with profiling.span("pipeline.encode"):
            with profiling.span("graph.text", rows=2):
                pass
            with profiling.span("sync.token_ids"):
                time.sleep(0.003)
            with profiling.span("chain"):
                with profiling.span("sync.scales"):
                    time.sleep(0.002)
        with profiling.span("sync.best"):
            time.sleep(0.001)
        with pytest.raises(RuntimeError):
            with profiling.span("pipeline.generate"):
                raise RuntimeError("boom")
        with profiling.span("graph.text", rows=3):
            pass
    spans = profiling.recorded().spans
    assert set(spans) == {("pipeline.encode", None), ("graph.text", "pipeline.encode"),
                          ("sync.token_ids", "pipeline.encode"), ("chain", "pipeline.encode"),
                          ("sync.scales", "chain"), ("sync.best", None),
                          ("pipeline.generate", None), ("graph.text", None)}
    enc, tok, chain, scales, best = (spans[k] for k in (
        ("pipeline.encode", None), ("sync.token_ids", "pipeline.encode"),
        ("chain", "pipeline.encode"), ("sync.scales", "chain"), ("sync.best", None)))
    for s in (tok, scales, best):
        assert s.sync_ns == s.host_ns > 0
    assert chain.sync_ns == scales.host_ns
    assert enc.sync_ns == tok.host_ns + scales.host_ns
    assert enc.host_ns > enc.sync_ns >= 5_000_000
    assert spans[("graph.text", None)].rows == 3
    assert spans[("graph.text", "pipeline.encode")].rows == 2
    assert {k for k, r in spans.items() if r.parent is None} == {
        ("pipeline.encode", None), ("sync.best", None), ("pipeline.generate", None),
        ("graph.text", None)}
    assert profiling._stack == []


@pytest.fixture(scope="module")
def tiny_pipe():
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
    from cyclediffusion_tpu_torch.text import HashTokenizer

    core = LatentDiffusionCore.random_init(LatentCoreSpec.tiny(), seed=3, device="cpu")
    return StochasticTextPipeline(
        core, HashTokenizer(96, 16), None, custom_steps=10, eta=0.1, white_box_steps=11,
        skip_steps=[5], encoder_unconditional_guidance_scales=[1.0],
        decoder_unconditional_guidance_scales=[5.0], n_trials=1)


def test_tiny_edit_under_a_foreign_profiler(tiny_pipe):
    """A tiny SD-shaped edit (2 images, 5 encode and 5 decode steps) on the
    CPU under ``torch.profiler``: the token ids' copy once per text
    encoding, ``sampler.steps`` equal to the chains' steps, the graphed
    entry points with their rows and no device time, the pipeline's entry
    points outermost, and no profiler range of the program's own."""
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 32, 32, 3), generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        z = tiny_pipe.encode(images, ["a red cat", "a dog"], generator=g)
        tiny_pipe.generate(z, ["a red dog", "a cat"], generator=g)
    rec = profiling.recorded()
    by_name = {}
    for r in rec.spans.values():
        calls, rows, timed = by_name.get(r.name, (0, 0, 0))
        by_name[r.name] = (calls + r.calls, rows + r.rows, timed + r.timed)
    assert by_name["sync.token_ids"][0] == by_name["graph.text"][0] == 4
    assert by_name["graph.text"][1] == 8
    assert rec.counts["sampler.steps"] == 5 + 5
    assert by_name["graph.unet"][:2] == (10, 10 * 4)          # the CFG pair of 2 images
    assert by_name["graph.first_stage.encode"][:2] == (1, 2)
    assert by_name["graph.first_stage.decode"][:2] == (1, 2)
    assert [by_name[f"sampler.{n}"][0] for n in (
        "sample_xt_next", "compute_eps", "ddim_step", "cfg_dual", "cfg_combine")] == [
        5, 5, 5, 10, 10]
    assert by_name["sync.scales"][0] == 2
    assert rec.counts["rows.launched"] == rec.counts["rows.real"] == 2
    assert not any(timed for _, _, timed in by_name.values())
    assert not any(k.startswith("graph.captures.") for k in rec.counts)
    assert {r.name for r in rec.spans.values() if r.parent is None} == {
        "pipeline.encode", "pipeline.generate"}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & set(by_name)


def test_trace_if_enabled_shows_the_spans_as_ranges(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path))
    with profiling.trace_if_enabled():
        with profiling.span("pipeline.encode"):
            with profiling.span("sync.token_ids"):
                torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"pipeline.encode", "sync.token_ids"} <= names
    assert set(profiling.recorded().spans) == {("pipeline.encode", None),
                                               ("sync.token_ids", "pipeline.encode")}
    assert not (profiling._recording or profiling._ranges)
