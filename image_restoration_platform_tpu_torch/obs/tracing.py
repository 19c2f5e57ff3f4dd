"""Lightweight tracing spans with the reference's span taxonomy.

The reference wires @opentelemetry/api directly into every service
(restorator.js:38-45, classifier.js:41-47, credits.js:40-47, ...) but never
bootstraps an SDK, so spans are no-ops at runtime. We keep the same taxonomy
(span names, attributes, events) with a dependency-free implementation that
*does* record timings in-process, can export to a ring buffer for debugging,
and annotates device steps for ``torch.profiler`` traces.

W3C trace context (traceparent/tracestate) is parsed/propagated by the API
middleware and attached to the root span, mirroring requestContext.js:12-28.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator


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
    )

    def __init__(
        self,
        name: str,
        attributes: dict[str, Any] | None = None,
        trace_id: str | None = None,
        parent_id: str | None = None,
    ):
        self.name = name
        self.attributes: dict[str, Any] = dict(attributes or {})
        self.events: list[tuple[str, dict[str, Any], int]] = []
        self.start_ns = time.perf_counter_ns()
        self.end_ns: int | None = None
        self.status = "UNSET"
        self.status_message: str | None = None
        self.trace_id = trace_id or uuid.uuid4().hex
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_attributes(self, attrs: dict[str, Any]) -> None:
        self.attributes.update(attrs)

    def add_event(self, name: str, attrs: dict[str, Any] | None = None) -> None:
        self.events.append((name, dict(attrs or {}), time.perf_counter_ns()))

    def record_exception(self, error: BaseException) -> None:
        self.add_event("exception", {"exception.message": str(error), "exception.type": type(error).__name__})

    def set_status(self, status: str, message: str | None = None) -> None:
        self.status = status
        self.status_message = message

    def end(self) -> None:
        if self.end_ns is None:
            self.end_ns = time.perf_counter_ns()

    @property
    def duration_ms(self) -> float:
        end = self.end_ns or time.perf_counter_ns()
        return (end - self.start_ns) / 1e6


class _SpanBuffer:
    """Ring buffer of completed spans for debugging/admin introspection."""

    def __init__(self, maxlen: int = 512):
        self._spans: deque[Span] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def snapshot(self, limit: int = 50) -> list[dict]:
        with self._lock:
            spans = list(self._spans)[-limit:]
        return [
            {
                "name": s.name,
                "durationMs": round(s.duration_ms, 3),
                "status": s.status,
                "attributes": s.attributes,
                "events": [e[0] for e in s.events],
            }
            for s in spans
        ]

    def export_otlp(self, limit: int = 512) -> dict:
        """OTLP/JSON-shaped export of the completed-span ring — the exporter
        the reference spec'd but never bootstrapped (design.md:1494-1530 wires
        an OTLP endpoint; the runtime spans stay no-ops). An OTLP collector
        can ingest this payload from ``/v1/admin/traces`` verbatim.

        Span clocks are perf_counter_ns; they are rebased onto the unix epoch
        at export time so startTimeUnixNano/endTimeUnixNano are real stamps.
        """
        epoch_offset_ns = time.time_ns() - time.perf_counter_ns()

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
            spans = list(self._spans)[-limit:]
        status_code = {"UNSET": 0, "OK": 1, "ERROR": 2}
        otlp_spans = []
        for s in spans:
            end_ns = s.end_ns or time.perf_counter_ns()
            otlp_spans.append(
                {
                    "traceId": s.trace_id,
                    "spanId": s.span_id,
                    **({"parentSpanId": s.parent_id} if s.parent_id else {}),
                    "name": s.name,
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": str(s.start_ns + epoch_offset_ns),
                    "endTimeUnixNano": str(end_ns + epoch_offset_ns),
                    "attributes": _attrs(s.attributes),
                    "events": [
                        {
                            "name": name,
                            "timeUnixNano": str(ts + epoch_offset_ns),
                            "attributes": _attrs(attrs),
                        }
                        for name, attrs, ts in s.events
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
        return Span(
            name,
            attributes,
            trace_id=parent.trace_id if parent else None,
            parent_id=parent.span_id if parent else None,
        )

    @contextmanager
    def span(
        self,
        name: str,
        attributes: dict[str, Any] | None = None,
        parent: Span | None = None,
    ) -> Iterator[Span]:
        s = self.start_span(name, attributes, parent)
        try:
            yield s
            if s.status == "UNSET":
                s.set_status("OK")
        except BaseException as error:
            s.record_exception(error)
            s.set_status("ERROR", str(error))
            raise
        finally:
            s.end()
            _buffer.add(s)


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
