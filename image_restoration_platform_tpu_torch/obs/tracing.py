"""Lightweight tracing spans with the reference's span taxonomy.

The reference wires @opentelemetry/api directly into every service
(restorator.js:38-45, classifier.js:41-47, credits.js:40-47, ...) but never
bootstraps an SDK, so spans are no-ops at runtime. We keep the same taxonomy
(span names, attributes, events) with a dependency-free implementation that
*does* record timings in-process, into a store that holds the last
``SPAN_STORE_SIZE`` spans (a few minutes of a loaded service), and annotates
device steps for ``torch.profiler`` traces.

A span opened while another is open on the same thread (or in the same
``contextvars`` context) is its child: same trace id, the other as parent.
Spans are stamped with ``time.perf_counter_ns`` and the native id of the
thread that opened them; ``_SpanBuffer.clock_offset_ns`` maps those stamps
onto Unix-epoch nanoseconds, the clock of ``torch.profiler``'s events and of
the OTLP export. Spans never open ``torch.profiler`` ranges: only
``device_trace`` does.

W3C trace context (traceparent/tracestate) is parsed/propagated by the API
middleware and attached to the root span, mirroring requestContext.js:12-28.
"""

from __future__ import annotations

import contextvars
import itertools
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator

SPAN_STORE_SIZE = 32768

_ids = random.Random()  # seeded from the OS; ids need uniqueness, not secrecy
_span_ids = itertools.count(_ids.getrandbits(63))  # a random start, then one by one
_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar("irp_current_span", default=None)


class Span:
    __slots__ = (
        "name",
        "attributes",
        "events",
        "start_ns",
        "end_ns",
        "status",
        "status_message",
        "trace_id",
        "span_id",
        "parent_id",
        "thread",
    )

    def __init__(
        self,
        name: str,
        attributes: dict[str, Any] | None = None,
        trace_id: str | None = None,
        parent_id: str | None = None,
    ):
        self.name = name
        self.attributes: dict[str, Any] = dict(attributes) if attributes else {}
        self.events: list[tuple[str, dict[str, Any], int]] | None = None  # made by the first add_event
        self.status = "UNSET"
        self.status_message: str | None = None
        self.trace_id = trace_id or f"{_ids.getrandbits(128):032x}"
        self.span_id = f"{next(_span_ids):016x}"
        self.parent_id = parent_id
        self.thread = threading.get_native_id()
        self.end_ns: int | None = None
        self.start_ns = time.perf_counter_ns()

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_attributes(self, attrs: dict[str, Any]) -> None:
        self.attributes.update(attrs)

    def add_event(self, name: str, attrs: dict[str, Any] | None = None) -> None:
        if self.events is None:
            self.events = []
        self.events.append((name, dict(attrs or {}), time.perf_counter_ns()))

    def record_exception(self, error: BaseException) -> None:
        self.add_event("exception", {"exception.message": str(error), "exception.type": type(error).__name__})

    def set_status(self, status: str, message: str | None = None) -> None:
        self.status = status
        self.status_message = message

    def end(self) -> None:
        if self.end_ns is None:
            self.end_ns = time.perf_counter_ns()


class _SpanBuffer:
    """The last ``maxlen`` finished spans (name, trace, span and parent ids,
    thread, start, end, attributes, status, events), for the admin export
    and for reading a window of spans back (``between``)."""

    def __init__(self, maxlen: int = SPAN_STORE_SIZE):
        self._records: deque[Span] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._horizon_ns = -1  # the latest end of a span let go

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._horizon_ns = max(self._horizon_ns, self._records[0].end_ns)
            self._records.append(span)

    def between(self, start_s: float, end_s: float) -> list[Span] | None:
        """The kept spans that lie inside [start_s, end_s] (``perf_counter``
        seconds), in the order they ended; None where the store has let go
        of a span that ended after ``start_s``, so the interval is not whole."""
        lo, hi = int(start_s * 1e9), int(end_s * 1e9)
        with self._lock:
            if self._horizon_ns > lo:
                return None
            return [r for r in self._records if lo <= r.start_ns and r.end_ns <= hi]

    @staticmethod
    def clock_offset_ns() -> int:
        """Unix-epoch ns less ``perf_counter`` ns now: added to a span's
        stamps it gives ``time.time_ns()``'s clock, the one
        ``torch.profiler`` stamps its events with. From the tightest of a
        few readings of both clocks."""
        best = None
        for _ in range(5):
            a = time.perf_counter_ns()
            wall = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, wall - (a + b) // 2)
        return best[1]

    def export_otlp(self, limit: int = 512) -> dict:
        """OTLP/JSON-shaped export of the last ``limit`` finished spans —
        the exporter the reference spec'd but never bootstrapped
        (design.md:1494-1530 wires an OTLP endpoint; the runtime spans stay
        no-ops). An OTLP collector can ingest this payload from
        ``/v1/admin/traces`` verbatim. Stamps are rebased onto the Unix epoch
        (``clock_offset_ns``) and each span carries its thread as
        ``thread.id``."""
        epoch_offset_ns = self.clock_offset_ns()

        def _value(v: Any) -> dict:
            if isinstance(v, bool):
                return {"boolValue": v}
            if isinstance(v, int):
                return {"intValue": str(v)}
            if isinstance(v, float):
                return {"doubleValue": v}
            return {"stringValue": str(v)}

        def _attrs(d: dict[str, Any]) -> list[dict]:
            return [{"key": k, "value": _value(v)} for k, v in d.items()]

        with self._lock:
            spans = list(self._records)[-limit:]
        status_code = {"UNSET": 0, "OK": 1, "ERROR": 2}
        otlp_spans = []
        for s in spans:
            otlp_spans.append(
                {
                    "traceId": s.trace_id,
                    "spanId": s.span_id,
                    **({"parentSpanId": s.parent_id} if s.parent_id else {}),
                    "name": s.name,
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": str(s.start_ns + epoch_offset_ns),
                    "endTimeUnixNano": str(s.end_ns + epoch_offset_ns),
                    "attributes": _attrs({**s.attributes, "thread.id": s.thread}),
                    "events": [
                        {
                            "name": name,
                            "timeUnixNano": str(ts + epoch_offset_ns),
                            "attributes": _attrs(attrs),
                        }
                        for name, attrs, ts in s.events or ()
                    ],
                    "status": {
                        "code": status_code.get(s.status, 0),
                        **({"message": s.status_message} if s.status_message else {}),
                    },
                }
            )
        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": _attrs({"service.name": "image-restoration-api"})
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "image_restoration_platform_tpu_torch"},
                            "spans": otlp_spans,
                        }
                    ],
                }
            ]
        }


_buffer = _SpanBuffer()


def span_buffer() -> _SpanBuffer:
    return _buffer


class Tracer:
    def __init__(self, component: str):
        self.component = component

    def start_span(
        self,
        name: str,
        attributes: dict[str, Any] | None = None,
        parent: Span | None = None,
    ) -> Span:
        """A span under ``parent``, by default under the span open in this
        context; a root span (a new trace) where there is none. The caller
        ends it with ``end_span``."""
        parent = parent or _current.get()
        return Span(
            name,
            attributes,
            trace_id=parent.trace_id if parent else None,
            parent_id=parent.span_id if parent else None,
        )

    def end_span(self, span: Span) -> None:
        """End ``span`` (status OK unless set) and keep it in the store."""
        if span.status == "UNSET":
            span.set_status("OK")
        span.end()
        _buffer.add(span)

    def span(
        self,
        name: str,
        attributes: dict[str, Any] | None = None,
        parent: Span | None = None,
    ) -> _Scope:
        """``start_span`` as the current span of a ``with`` body; ended and
        kept on exit, with the body's exception recorded (and re-raised)."""
        return _Scope(self, self.start_span(name, attributes, parent))


class _Scope:
    """The ``with`` block of ``Tracer.span``."""

    __slots__ = ("tracer", "span", "token")

    def __init__(self, tracer: Tracer, span: Span):
        self.tracer, self.span = tracer, span

    def __enter__(self) -> Span:
        self.token = _current.set(self.span)
        return self.span

    def __exit__(self, exc_type, error, traceback) -> None:
        _current.reset(self.token)
        if error is not None:
            self.span.record_exception(error)
            self.span.set_status("ERROR", str(error))
        self.tracer.end_span(self.span)


_tracers: dict[str, Tracer] = {}
_tracers_lock = threading.Lock()


def get_tracer(component: str) -> Tracer:
    with _tracers_lock:
        tracer = _tracers.get(component)
        if tracer is None:
            tracer = _tracers[component] = Tracer(component)
        return tracer


@contextmanager
def device_trace(name: str) -> Iterator[None]:
    """``torch.profiler.record_function`` annotation around a device step, so
    a profiler trace of the serving loop names each batch. The body's
    exceptions propagate untouched."""
    import torch

    with torch.profiler.record_function(name):
        yield
