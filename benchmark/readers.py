"""Arithmetic the metric readers share: a layer's self time from the
benchmark's spans, and the per-step reductions of the profiler's trace
(device time, served work, roofline shares against the card's data-sheet
peaks)."""

from __future__ import annotations

from benchmark import flops


def self_ms(run, outer: str, inner: str):
    if run.spans is None:
        return None
    return run.spans.self_ms(outer, inner, *run.window)


def steps(run):
    return run.trace.steps if run.trace is not None and run.trace.steps else None


def step_ms(run):
    s = steps(run)
    return None if s is None else 1e-6 * sum(st.device_ns() for st in s) / len(s)


def step_mfu(run):
    """The profiled steps' canonical operations over their device time, as
    a share of the card's bf16 peak, in %."""
    s = steps(run)
    if s is None:
        return None
    work = sum(flops.image_flops(run.config, st.canvas, run.cell.reference) for st in s)
    return 100.0 * work / (1e-9 * sum(st.device_ns() for st in s)) / run.peaks["bf16_flops"]


def roofline(run, kernels: tuple[str, ...], bytes_of):
    """The minimal bytes of the named kernels' work in the profiled steps
    (``bytes_of(step)``) at the card's memory bandwidth, over their device
    time, in %; None where no step ran them."""
    s = steps(run)
    if s is None:
        return None
    ns = sum(st.device_ns(k) for st in s for k in kernels)
    if ns == 0:
        return None
    return 100.0 * sum(bytes_of(st) for st in s) / run.peaks["hbm_bytes_per_s"] / (ns * 1e-9)


def idle_share(run):
    """The share of the profiled window in which no operation ran on the
    card, in %."""
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_ns() / (t.window[1] - t.window[0]))
