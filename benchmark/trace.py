"""A few steady seconds of the traced run under ``torch.profiler``, reduced
to what the per-layer readers and the result's ``device`` and
``breakdown`` need: the device's activity in the window, each engine step
(the program's own ``device_trace`` label of a tiled SR call) with the
device operations inside its device-side span, and the host's labels open
at each idle gap.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

PROGRAM_STEP = re.compile(r"^sr_tiled/[^/]+/(\d+)t\d+$")


@dataclass
class Op:
    name: str
    start: int  # ns
    end: int


@dataclass
class Step:
    canvas: int  # one served image a step
    ops: list[Op] = field(default_factory=list)

    def device_ns(self, match: str | None = None) -> int:
        return sum(o.end - o.start for o in self.ops if match is None or match in o.name)


@dataclass
class Trace:
    window: tuple[int, int]  # ns
    ops: list[Op]  # device operations (kernels, copies, sets) inside the window
    steps: list[Step]  # engine steps whose device span lies inside the window
    labels: list[tuple[str, int, int, int]]  # (host label, thread, start, end)
    note: str = ""  # what the reduction saw, for the run's standard error

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_ns(self) -> int:
        total, cur_s, cur_e = 0, None, None
        for o in sorted(self.ops, key=lambda o: o.start):
            s, e = max(o.start, self.window[0]), min(o.end, self.window[1])
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def gaps(self) -> list[tuple[int, int]]:
        """Intervals of the window with no device operation, longest first."""
        out, t = [], self.window[0]
        for o in sorted(self.ops, key=lambda o: o.start):
            if o.start > t:
                out.append((t, min(o.start, self.window[1])))
            t = max(t, o.end)
            if t >= self.window[1]:
                break
        if t < self.window[1]:
            out.append((t, self.window[1]))
        return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the count of each benchmark
        label open across its threads, e.g. ``submit8_restore5_wait20``."""
        counts: dict[str, int] = {}
        for name, _tid, s, e in self.labels:
            if s <= t < e and name.startswith("bench.") and name != "bench.window":
                key = name[len("bench."):]
                counts[key] = counts.get(key, 0) + 1
        return "_".join(f"{k}{counts[k]}" for k in sorted(counts)) or "unlabelled"

    def breakdown(self) -> dict:
        by_name: dict[str, int] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0) + o.end - o.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "device_ops": [[name[:120], ns * 1e-9] for name, ns in top],
            "idle_gaps": [[self.host_at((a + b) // 2), (b - a) * 1e-9] for a, b in self.gaps()[:10]],
        }


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        return profile(activities=activities, experimental_config=config)
    except TypeError:
        return profile(activities=activities)


def initialise() -> None:
    """Start the profiler once, on the thread that made the CUDA context and
    before the service's threads exist: the profiler's first start sets up
    its tracing of the card, and a later first start, with threads already
    launching work, records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def record(t_begin: float, seconds: float) -> dict:
    """Run the profiler from the host time ``t_begin`` for ``seconds`` (on
    the calling thread); returns {"trace": Trace | None, "error": str}."""
    import torch

    try:
        while time.perf_counter() < t_begin:
            time.sleep(0.001)
        with _profiler(torch) as prof:
            with torch.profiler.record_function("bench.window"):
                time.sleep(seconds)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        return {"trace": reduce(prof.profiler.kineto_results.events()), "error": ""}
    except Exception as error:  # noqa: BLE001 - the traced run reports what it could not read
        return {"trace": None, "error": repr(error)}


def reduce(events) -> Trace:
    """The trace's device operations in the window and its engine steps.

    A step is the device-side span that the profiler records for the
    program's ``device_trace`` label of a tiled SR call (its name gives the
    canvas), with every device operation that starts inside it: one stream
    runs the steps in turn, so the span holds its own step's work. Each
    tiled call serves one image."""
    window = None
    device, spans, labels = [], [], []
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if name.startswith("bench.") or PROGRAM_STEP.match(name):
                spans.append((name, start, end))
            else:
                device.append(Op(name, start, end))
            continue
        if name == "bench.window":
            window = (start, end)
        if e.is_user_annotation() or name.startswith("bench."):
            labels.append((name, e.start_thread_id(), start, end))
    if window is None:
        raise ValueError("the trace has no window label")
    ops = sorted((o for o in device if o.end > window[0] and o.start < window[1]), key=lambda o: o.start)
    steps = []
    for name, a, b in spans:
        pm = PROGRAM_STEP.match(name)
        if not pm or a < window[0] or b > window[1]:
            continue
        step = Step(int(pm.group(1)))
        step.ops = [o for o in ops if a <= o.start < b]
        steps.append(step)
    note = (f"{len(device)} device operations, {len(ops)} in the window, device-side label spans "
            f"{sorted({n for n, *_ in spans})}, {len(steps)} steps in the window; steps (ops, device ms, span ms): "
            + ", ".join(f"({len(st.ops)}, {st.device_ns() * 1e-6:.3f}, "
                        f"{(max(o.end for o in st.ops) - min(o.start for o in st.ops)) * 1e-6 if st.ops else 0:.3f})"
                        for st in steps[:12]))
    return Trace(window, ops, [st for st in steps if st.ops], labels, note)
