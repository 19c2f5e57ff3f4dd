"""The readers of the program's own spans and counters on synthetic runs:
two jobs' spans in a window, the counters' deltas, a trace with idle gaps
inside and outside the engine's calls; a program without the span store,
and a store that no longer holds the whole window, leave every one out."""

from __future__ import annotations

import pytest

from benchmark import program_spans, spec
from benchmark.run import Run
from benchmark.trace import Op, Trace

MS = 1_000_000  # ns
OFFSET = 7 * 10**12  # the synthetic store's perf_counter -> trace clock offset
NEW = ("submit.preprocess_ms", "restorator.codec_ms", "engine.queue_ms", "engine.device_ms", "engine.fetch_ms",
       "device.idle_starved_share")


class Store:
    """The program's store with a fixed clock offset."""

    def __init__(self, maxlen=1000):
        from image_restoration_platform_tpu_torch.obs import tracing

        self.tracing = tracing
        self.buffer = tracing._SpanBuffer(maxlen=maxlen)
        self.between = self.buffer.between

    def clock_offset_ns(self):
        return OFFSET

    def add(self, name, start_ms, end_ms, parent=None, **attributes):
        span = self.tracing.Tracer("test").start_span(name, attributes, parent=parent)
        span.start_ns, span.end_ns = 10_000 * MS + int(start_ms * MS), 10_000 * MS + int(end_ms * MS)
        self.buffer.add(span)
        return span


def job(store, t, queue_ms, program="sr_tiled/sr-x2/2048t256"):
    """One job's spans from ``t`` ms: 10 ms validate+preprocess, 7 ms codec,
    a call of 100 ms that waits ``queue_ms`` for the lock."""
    root = store.add("submit.job", t, t + 200)
    store.add("submit.validate", t, t + 2, root)
    store.add("submit.preprocess", t + 2, t + 10, root)
    restore = store.add("restorator.restore", t + 20, t + 190, root)
    store.add("restorator.decode", t + 20, t + 23, restore)
    call = store.add("engine.call", t + 30, t + 130, restore, **{"engine.program": program})
    store.add("engine.queue", t + 30, t + 30 + queue_ms, call)
    store.add("restorator.encode", t + 140, t + 144, restore)
    return call


@pytest.fixture
def run():
    trace = Trace(window=(OFFSET + 10_100 * MS, OFFSET + 10_500 * MS),
                  ops=[Op("k", OFFSET + 10_100 * MS, OFFSET + 10_150 * MS),
                       Op("k", OFFSET + 10_200 * MS, OFFSET + 10_300 * MS)],
                  steps=[], labels=[])
    counters = {"sr_tiled_calls.2048": 4.0, "engine.device_s.sr_tiled": 0.5, "engine.fetch_s.sr_tiled": 0.1,
                "engine.device_s.fuse": 9.0}
    return Run(cell=None, seconds=1.0, window=(10.0, 11.0), jobs=[], setup_s=0.0, counters=counters, trace=trace)


@pytest.fixture
def store(monkeypatch):
    s = Store()
    monkeypatch.setattr(program_spans, "store", lambda: s)
    job(s, 0, 20)
    job(s, 300, 40)
    job(s, 900, 0, program="fuse/restore-unet/k3/512")  # ends past the window: left out of the job metrics
    s.add("submit.job", -50, 10)  # starts before the window
    return s


def read(name, run):
    return spec.load_reader(name)(run)


def test_readers(store, run):
    assert read("submit.preprocess_ms", run) == pytest.approx(10.0)
    assert read("restorator.codec_ms", run) == pytest.approx(7.0)
    assert read("engine.queue_ms", run) == pytest.approx(30.0)
    assert read("engine.device_ms", run) == pytest.approx(125.0)
    assert read("engine.fetch_ms", run) == pytest.approx(25.0)
    # the calls run 30-130 and 330-430 ms: of the idle 150-200 and 300-500
    # ms, 150 ms lie outside them, in a window of 400 ms
    assert read("device.idle_starved_share", run) == pytest.approx(37.5)


def test_a_program_without_the_store_reports_none(monkeypatch, run):
    monkeypatch.setattr(program_spans, "store", lambda: None)
    assert [read(name, run) for name in NEW] == [None] * len(NEW)


def test_a_partial_window_reports_none(monkeypatch, run):
    s = Store(maxlen=4)
    monkeypatch.setattr(program_spans, "store", lambda: s)
    job(s, 0, 20)
    job(s, 300, 40)
    assert [read(name, run) for name in NEW] == [None] * len(NEW)


def test_the_parents_store_has_no_window_query(monkeypatch):
    """A program whose store cannot answer a window query (the parent of
    this reader) is no store to read."""
    from image_restoration_platform_tpu_torch.obs import tracing

    class Old:
        def export_otlp(self, limit=512):
            return {}

    monkeypatch.setattr(tracing, "span_buffer", lambda: Old())
    assert program_spans.store() is None


def test_entries_of_the_new_metrics():
    import json
    import os

    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in NEW:
        entry = per_layer[name]
        assert entry["moves"] == "images_per_s" and entry["workloads"] == ["sr-x2.upscale-2k"]
    assert {per_layer[n]["source"] for n in NEW[3:5]} == {"program_counter"}
