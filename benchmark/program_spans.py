"""What the readers of the program's own spans and counters share: the
spans the port's store (``obs/tracing.py``) holds for the run's window,
each job's share of named spans, the engine's per-call counters, and the
card's idle time outside every engine call.

A program without that store (one that predates it) leaves every such
metric out, and so does a store that no longer holds the whole window.
"""

from __future__ import annotations

import time

SR_CALL = "sr_tiled/"  # the program label of a tiled SR call


def store():
    """The program's span store, or None where the program has none that
    answers a window query."""
    try:
        from image_restoration_platform_tpu_torch.obs import tracing
    except ImportError:
        return None
    buffer = tracing.span_buffer()
    return buffer if hasattr(buffer, "between") and hasattr(buffer, "clock_offset_ns") else None


def window_spans(run):
    """The program's spans that lie inside ``run.window``, or None."""
    buffer = store()
    return None if buffer is None else buffer.between(*run.window)


def per_job_ms(run, names: tuple[str, ...]):
    """Mean ms per job of the spans named ``names`` in the traces of the
    jobs (``submit.job`` spans) that lie in the window."""
    spans = window_spans(run)
    if spans is None:
        return None
    jobs = {s.trace_id for s in spans if s.name == "submit.job"}
    if not jobs:
        return None
    total = sum(s.end_ns - s.start_ns for s in spans if s.name in names and s.trace_id in jobs)
    return 1e-6 * total / len(jobs)


def queue_ms(run):
    """Mean ms a tiled SR call waits for the engine's run lock."""
    spans = window_spans(run)
    if spans is None:
        return None
    calls = {s.span_id for s in spans
             if s.name == "engine.call" and str(s.attributes.get("engine.program", "")).startswith(SR_CALL)}
    waits = [s.end_ns - s.start_ns for s in spans if s.name == "engine.queue" and s.parent_id in calls]
    return 1e-6 * sum(waits) / len(waits) if waits else None


def per_call_ms(run, counter: str):
    """ms of ``counter`` (seconds summed over the window's calls) per tiled
    SR call, from the window's counter deltas."""
    if window_spans(run) is None:
        return None
    calls = run.counter("sr_tiled_calls.")
    seconds = run.counters.get(counter)
    if not calls or seconds is None:
        return None
    return 1000.0 * seconds / calls


def idle_starved_share(run):
    """The share of the profiled window, in %, in which the card is idle
    and no ``engine.call`` span is open on any thread: the card waits on
    the host's job work, not on an engine call's own staging, lock hand-off
    or fetch. Spans are moved onto the trace's clock by the store's offset;
    calls that end after the run's window count too."""
    t = run.trace
    buffer = store()
    if t is None or buffer is None:
        return None
    spans = buffer.between(run.window[0], time.perf_counter())
    if spans is None:
        return None
    offset = buffer.clock_offset_ns()
    calls = sorted((s.start_ns + offset, s.end_ns + offset) for s in spans if s.name == "engine.call")
    merged: list[list[int]] = []
    for a, b in calls:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starved, i = 0, 0
    for a, b in sorted(t.gaps()):  # disjoint, in order: one sweep over the calls
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        covered, j = 0, i
        while j < len(merged) and merged[j][0] < b:
            covered += max(0, min(b, merged[j][1]) - max(a, merged[j][0]))
            j += 1
        starved += b - a - covered
    return 100.0 * starved / (t.window[1] - t.window[0])
