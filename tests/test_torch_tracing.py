"""PyTorch port: the spans of a job (obs/tracing.py) and the engine's call
timing.

One synchronous SR job through ``submit_job`` is one trace whose spans nest
as the job's layers call each other, each inside its parent; the span
store answers window queries, keeps its bound and maps its clock onto the
Unix epoch; the batcher's wait and the batch's engine call name the same
trace; on the card a tiled call's CUDA-event device time agrees with the
profiler's device time of the same call; and the engine's fetch lands in
page-locked blocks, each lent to one result at a time, while the CPU path
returns arrays of their own. This file imports no JAX, so its ``cuda``
tests run on the card's machine
(``python3 -m pytest tests/test_torch_tracing.py -m cuda -q --noconftest``).
"""

import io
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.obs import tracing
from image_restoration_platform_tpu_torch.obs.metrics import get_counters
from image_restoration_platform_tpu_torch.serve.batcher import MicroBatcher

# each span of a synchronous SR job and the span it nests in
JOB_PARENTS = {
    "submit.validate": "submit.job",
    "submit.preprocess": "submit.job",
    "moderation.moderate": "submit.job",
    "submit.record": "submit.job",
    "credits.checkAndDeduct": "submit.record",
    "job.process": "submit.job",
    "restorator.restore": "job.process",
    "restorator.decode": "restorator.restore",
    "restorator.canvas": "restorator.restore",
    "engine.call": "restorator.restore",
    "engine.queue": "engine.call",
    "engine.launch": "engine.call",
    "engine.fetch": "engine.call",
    "restorator.crop": "restorator.restore",
    "restorator.encode": "restorator.restore",
    "blobs.put_result": "job.process",
}
CLEAR = {k: "VERY_UNLIKELY" for k in ("adult", "violence", "racy", "spoof", "medical")}


def _jpeg(h, w, seed=0):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _span(name, start_ns, end_ns, parent=None):
    s = tracing.Tracer("test").start_span(name, parent=parent)
    s.start_ns, s.end_ns = start_ns, end_ns
    return s


@pytest.fixture
def service(monkeypatch):
    """The service graph on the CPU, its moderation cleared, with the tiled
    SR path taken from the 256 canvas up (the 2048 canvas's path at a CPU
    size)."""
    from image_restoration_platform_tpu_torch.api.context import AppContext
    from image_restoration_platform_tpu_torch.serve.moderation import ModerationService
    from image_restoration_platform_tpu_torch.serve.programs import sr as sr_programs

    monkeypatch.setattr(sr_programs, "DIRECT_MAX", 128)
    ctx = AppContext(device="cpu", use_batcher=False, queue_workers=1)
    ctx.moderation = ModerationService(vision_client=lambda data: dict(CLEAR), audit_log=ctx.moderation.audit)
    ctx.user_store.grant("u", 10)
    yield ctx
    ctx.shutdown()


def test_sync_job_is_one_trace_of_nested_spans(service):
    from image_restoration_platform_tpu_torch.api.submit import submit_job

    counters_before = get_counters().snapshot()
    t0 = time.perf_counter()
    status, body, _ = submit_job(service, {"id": "u"}, [("a.jpg", _jpeg(150, 200))], options={"model": "sr-x2"},
                                 sync=True)
    t1 = time.perf_counter()
    assert status == 200
    spans = tracing.span_buffer().between(t0, t1)
    assert len({s.trace_id for s in spans}) == 1
    by_id = {s.span_id: s for s in spans}
    by_name = {s.name: s for s in spans}
    assert set(by_name) == set(JOB_PARENTS) | {"submit.job"} and len(spans) == len(by_name)
    root = by_name["submit.job"]
    assert root.parent_id is None and root.attributes["job.id"] == body["id"]
    for name, parent_name in JOB_PARENTS.items():
        child, parent = by_name[name], by_id[by_name[name].parent_id]
        assert parent.name == parent_name, name
        assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns, name
    assert by_name["engine.call"].attributes["engine.program"] == "sr_tiled/sr-x2/256t256"
    assert {s.thread for s in spans} == {threading.get_native_id()}

    # deviceSeconds (the host clock on the CPU) bills the job and the counters
    meta = body["result"]["metadata"]
    cost = service.restorator.config.device_cost_per_hour_usd
    assert meta["deviceSeconds"] > 0
    assert meta["estimatedCostUsd"] == round(meta["deviceSeconds"] * cost / 3600.0, 8)
    after = get_counters().snapshot()
    delta = {k: after[k] - counters_before.get(k, 0.0) for k in after if k.startswith("engine.")}
    assert delta["engine.device_s.sr_tiled"] == pytest.approx(meta["deviceSeconds"])
    assert 0 < delta["engine.fetch_s.sr_tiled"] <= meta["deviceSeconds"]


def test_window_query_returns_the_spans_inside():
    buffer = tracing._SpanBuffer()
    inside = [_span("a", 2_000_000_000, 2_500_000_000), _span("b", 2_500_000_000, 3_000_000_000)]
    outside = [_span("early", 1_000_000_000, 2_100_000_000), _span("late", 2_900_000_000, 3_000_000_001),
               _span("before", 100, 200)]
    for s in [outside[2], outside[0], *inside, outside[1]]:
        buffer.add(s)
    assert buffer.between(2.0, 3.0) == inside
    assert buffer.between(0.0, 4.0) == [outside[2], outside[0], *inside, outside[1]]
    assert buffer.between(5.0, 6.0) == []


def test_store_keeps_its_bound():
    assert tracing._SpanBuffer()._records.maxlen == tracing.SPAN_STORE_SIZE >= 32768
    buffer = tracing._SpanBuffer(maxlen=8)
    spans = [_span(f"s{i}", i * 1_000_000_000, i * 1_000_000_000 + 10) for i in range(20)]
    for s in spans:
        buffer.add(s)
    assert buffer.between(0.0, 100.0) is None  # the first twelve are gone
    assert buffer.between(12.0, 100.0) == spans[12:]
    assert len(buffer.export_otlp(limit=100)["resourceSpans"][0]["scopeSpans"][0]["spans"]) == 8


def test_clock_offset_maps_spans_onto_the_epoch():
    buffer = tracing.span_buffer()
    with tracing.get_tracer("test").span("test.clock") as s:
        wall = time.time_ns()
    assert abs(s.start_ns + buffer.clock_offset_ns() - wall) < 1_000_000
    exported = buffer.export_otlp(limit=1)["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    assert exported["name"] == "test.clock" and abs(int(exported["startTimeUnixNano"]) - wall) < 1_000_000
    assert {"key": "thread.id", "value": {"intValue": str(threading.get_native_id())}} in exported["attributes"]


def test_spans_nest_within_a_thread_and_not_across():
    tracer = tracing.get_tracer("test")
    seen = {}
    with tracer.span("outer") as outer:
        with tracer.span("inner") as inner:
            worker = threading.Thread(target=lambda: seen.setdefault("span", tracer.start_span("elsewhere")))
            worker.start()
            worker.join()
        assert tracing._current.get() is outer
    assert tracing._current.get() is None
    assert (inner.trace_id, inner.parent_id) == (outer.trace_id, outer.span_id)
    assert seen["span"].parent_id is None and seen["span"].trace_id != outer.trace_id
    assert seen["span"].thread != outer.thread == threading.get_native_id()
    with pytest.raises(ValueError):
        with tracer.span("failing") as failing:
            raise ValueError("no")
    assert failing.status == "ERROR" and failing.events[0][0] == "exception"


def test_spans_from_many_threads_keep_their_own_chains(monkeypatch):
    """More threads than cores, switching often, each opening nested spans
    into one store: none is lost and every child names its own thread's
    parent."""
    import sys

    buffer = tracing._SpanBuffer()
    monkeypatch.setattr(tracing, "_buffer", buffer)
    tracer = tracing.get_tracer("test")

    def work():
        for _ in range(200):
            with tracer.span("outer"):
                with tracer.span("inner"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    spans = buffer.between(0.0, time.perf_counter())
    assert len(spans) == 16 * 200 * 2
    outer = {s.span_id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            parent = outer[s.parent_id]
            assert (parent.thread, parent.trace_id) == (s.thread, s.trace_id)
    assert len({s.trace_id for s in outer.values()}) == len(outer)


def test_batcher_wait_names_the_trace_its_batch_serves():
    served = []

    class Engine:
        device = torch.device("cpu")

        def restore_batch_async(self, imgs, valid_hw, is_jpeg, family, egress="rgb", trace_ids=()):
            served.append(trace_ids)
            n = imgs.shape[0]
            return lambda: (imgs.copy(), np.zeros((n, 7), np.float32), {"deviceSeconds": 0.0})

    batcher = MicroBatcher(Engine(), ServingConfig(size_buckets=(16,), max_batch=1), device="cpu")
    try:
        with tracing.get_tracer("test").span("request") as request:
            batcher.submit(np.zeros((16, 16, 3), np.uint8), (16, 16), False, "fam")
    finally:
        batcher.shutdown()
    wait = next(s for s in tracing.span_buffer().between(0.0, time.perf_counter()) if s.name == "batcher.wait"
                and s.parent_id == request.span_id)
    assert served == [(request.trace_id,)] and wait.trace_id == request.trace_id


def test_fetch_builds_at_first_use_and_takes_card_bytes_only():
    import os

    from image_restoration_platform_tpu_torch.ops.cuda import build, fetch

    assert os.path.isfile(os.path.join(build.CSRC_DIR, fetch.SOURCE))
    assert fetch._fn is None or torch.cuda.is_available()
    with pytest.raises(ValueError):
        fetch.fetch(torch.zeros(8, dtype=torch.uint8), None, None)


@pytest.mark.cuda
def test_call_events_agree_with_the_profiler():
    """On the card: a tiled SR call's deviceSeconds (its CUDA events, start
    to fetched) is within 5 % of the device time the profiler records for
    the operations inside the call's label."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the events time the card's stream")
    from torch.profiler import ProfilerActivity, profile

    from image_restoration_platform_tpu_torch.serve.engine import RestorationEngine

    engine = RestorationEngine(device="cuda")
    canvas = np.random.default_rng(0).integers(0, 256, (2048, 2048, 3), np.uint8)
    for _ in range(2):  # build, then warm
        engine.sr_tiled(canvas, "sr-x2")
    label = "sr_tiled/sr-x2/2048t256"
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, meta = engine.sr_tiled(canvas, "sr-x2")
            torch.cuda.synchronize()
        spans, ops = [], []
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                interval = (e.start_ns(), e.start_ns() + e.duration_ns())
                (spans if e.name() == label else ops).append(interval)
        assert len(spans) == 1
        a, b = spans[0]
        device_s = 1e-9 * sum(e - s for s, e in ops if a <= s < b)
        assert meta["deviceSeconds"] == pytest.approx(device_s, rel=0.05)


@pytest.fixture
def blocks(monkeypatch):
    """The fetch's cache of pinned blocks over plain host memory, so its
    lending runs on the CPU."""
    from image_restoration_platform_tpu_torch.ops.cuda import fetch

    monkeypatch.setattr(fetch, "_pinned", lambda n: torch.empty(n, dtype=torch.uint8))
    return fetch.PinnedBlocks()


def _pinned_bytes():
    return get_counters().snapshot().get("engine.pinned_alloc_bytes", 0.0)


def test_pinned_block_is_lent_again_once_its_arrays_are_gone(blocks):
    start = _pinned_bytes()
    first = blocks.lend(48)
    assert first.shape == (48,) and first.dtype == np.uint8 and first.flags.writeable
    assert _pinned_bytes() - start == 64  # 48 rounded up to a power of two
    view = first[8:40].view(np.float32).reshape(2, 4)
    address = first.ctypes.data
    del first
    second = blocks.lend(40)  # the view still holds the first block
    assert second.ctypes.data != address and _pinned_bytes() - start == 128
    del view
    third = blocks.lend(33)
    assert third.ctypes.data == address and _pinned_bytes() - start == 128
    del second, third
    assert blocks.lend(64).ctypes.data in {address, blocks._blocks[1][0].data_ptr()}
    assert _pinned_bytes() - start == 128


def test_pinned_blocks_of_one_size_serve_only_that_size(blocks):
    start = _pinned_bytes()
    large = blocks.lend(1000)
    address = large.ctypes.data
    del large
    small = blocks.lend(3)  # a free 1024-byte block is not lent for 3 bytes
    assert small.ctypes.data != address and _pinned_bytes() - start == 1024 + 4
    assert blocks.lend(1024).ctypes.data == address and _pinned_bytes() - start == 1024 + 4


def test_pinned_blocks_lend_to_many_threads_without_sharing(blocks):
    """More threads than cores, switching often: a block lent to one thread
    is never lent to another while its array is alive."""
    import sys

    errors = []

    def work(tag):
        for _ in range(200):
            host = blocks.lend(256)
            host[:] = tag
            time.sleep(0)
            if not (host == tag).all():
                errors.append(tag)
            del host

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(tag,)) for tag in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(blocks._blocks) <= 16


def test_cpu_path_returns_arrays_of_their_own():
    """On the CPU ``_run_sync`` fetches with no pinned block: each call's
    arrays are writable, over memory no other call's arrays share, and no
    ``engine.fetch_pinned.*`` is counted."""
    from image_restoration_platform_tpu_torch.serve.engine import RestorationEngine

    engine = RestorationEngine(device="cpu")
    before = get_counters().snapshot()
    calls = [
        engine._run_sync("sr_tiled/test", lambda i=i: (torch.full((4, 5, 3), i, dtype=torch.uint8),
                                                      torch.full((2, 7), float(i))), "sr-x2")[0]
        for i in range(2)
    ]
    (image0, scores0), (image1, scores1) = calls
    assert image0.shape == (4, 5, 3) and image0.dtype == np.uint8 and scores0.dtype == np.float32
    assert all(a.flags.writeable for a in (image0, scores0, image1, scores1))
    assert not np.shares_memory(image0, image1) and not np.shares_memory(scores0, scores1)
    image0[:] = 255
    scores0[:] = -1.0
    assert (image1 == 1).all() and (scores1 == 1.0).all()
    after = get_counters().snapshot()
    assert after["engine.device_s.sr_tiled"] > before.get("engine.device_s.sr_tiled", 0.0)
    assert not [k for k in after if k.startswith("engine.fetch_pinned.") and after[k] != before.get(k, 0.0)]
    assert after.get("engine.pinned_alloc_bytes", 0.0) == before.get("engine.pinned_alloc_bytes", 0.0)


@pytest.mark.cuda
def test_fetch_lands_in_pinned_blocks_lent_once():
    """On the card: the fetch returns exactly the card's bytes in page-locked
    memory, at the 4K canvas's size and at an odd one; two tiled calls in a
    row return arrays over distinct blocks while the first is alive, the
    second leaving the first's bytes as they were; both count under
    ``engine.fetch_pinned.sr_tiled``; and a third call, once the first's
    arrays are gone, pins nothing new."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fetch copies from its memory")
    from image_restoration_platform_tpu_torch.ops.cuda import fetch
    from image_restoration_platform_tpu_torch.serve.engine import RestorationEngine

    stream = torch.cuda.current_stream()
    fetched = torch.cuda.Event()
    fetched.record(stream)
    generator = torch.Generator(device="cuda").manual_seed(0)
    for n in (50_331_648, 12_582_917):
        src = torch.randint(0, 256, (n,), dtype=torch.uint8, device="cuda", generator=generator)
        host = fetch.fetch(src, stream, fetched)
        assert host.shape == (n,) and host.dtype == np.uint8
        assert np.array_equal(host, src.cpu().numpy())
        assert torch.from_numpy(host).is_pinned()
        del host

    engine = RestorationEngine(device="cuda")
    rng = np.random.default_rng(0)
    canvases = [rng.integers(0, 256, (2048, 2048, 3), np.uint8) for _ in range(2)]
    engine.sr_tiled(canvases[0], "sr-x2")  # build
    before = get_counters().snapshot()
    first, _ = engine.sr_tiled(canvases[0], "sr-x2")
    kept = first.copy()
    second, _ = engine.sr_tiled(canvases[1], "sr-x2")
    assert first.shape == second.shape == (4096, 4096, 3)
    assert not np.shares_memory(first, second) and not np.array_equal(first, second)
    assert np.array_equal(first, kept)
    assert torch.from_numpy(first).is_pinned() and torch.from_numpy(second).is_pinned()
    after = get_counters().snapshot()
    assert after["engine.fetch_pinned.sr_tiled"] - before.get("engine.fetch_pinned.sr_tiled", 0.0) == 2
    del first
    third, _ = engine.sr_tiled(canvases[0], "sr-x2")
    assert np.array_equal(third, kept)
    assert get_counters().snapshot()["engine.pinned_alloc_bytes"] == after["engine.pinned_alloc_bytes"]
