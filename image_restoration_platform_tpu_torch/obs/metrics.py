"""In-process request metrics and serving counters, copied from
image_restoration_platform_tpu/obs/metrics.py: the request-duration ring
buffer behind ``GET /health/ready`` (count / average / nearest-rank p95 over
the last ``HEALTH_METRIC_SAMPLE_SIZE`` requests, default 1000), and the
monotonic counters and gauges of the serving loop (images, device seconds,
batch sizes, host syncs, the engine's fetches into pinned host memory
``engine.fetch_pinned.<kind>`` and the pinned bytes they newly allocated
``engine.pinned_alloc_bytes``), plus ``host_flag``; and ``KERNELS``, the
hand-written kernels whose launches are counted."""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque


class RequestMetrics:
    def __init__(self, sample_size: int | None = None):
        if sample_size is None:
            try:
                sample_size = int(os.environ.get("HEALTH_METRIC_SAMPLE_SIZE", 1000))
            except ValueError:
                sample_size = 1000
        self._samples: deque[float] = deque(maxlen=max(1, sample_size))
        self._lock = threading.Lock()

    def record(self, duration_ms: float) -> None:
        if not isinstance(duration_ms, (int, float)) or not math.isfinite(duration_ms):
            return
        with self._lock:
            self._samples.append(float(duration_ms))

    def snapshot(self) -> dict:
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {"count": 0, "averageMs": 0.0, "p95Ms": 0.0}
        ordered = sorted(samples)
        # nearest-rank p95 over the sampled window
        idx = min(len(ordered) - 1, max(0, math.ceil(0.95 * len(ordered)) - 1))
        return {
            "count": len(ordered),
            "averageMs": round(sum(ordered) / len(ordered), 3),
            "p95Ms": round(ordered[idx], 3),
        }


class Counters:
    """Monotonic counters + gauges for the serving loop (device accounting)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._started = time.monotonic()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> dict:
        with self._lock:
            uptime = time.monotonic() - self._started
            out = dict(self._counters)
            out.update(self._gauges)
            images = self._counters.get("images_restored_total", 0.0)
            if uptime > 0:
                out["images_per_sec"] = round(images / uptime, 4)
            out["uptime_s"] = round(uptime, 1)
        return out


_global_metrics = RequestMetrics()
_global_counters = Counters()
# the hand-written kernels' bindings (ops/cuda/build.py ``Kernel``), each added
# as it is made: a CUDA graph's capture takes their launches back and its
# replays publish them as ``kernels.launches.<name>`` (serve/exec_cache.py)
KERNELS: list = []


def record_request_duration(duration_ms: float) -> None:
    _global_metrics.record(duration_ms)


def get_request_metrics() -> dict:
    return _global_metrics.snapshot()


def get_counters() -> Counters:
    return _global_counters


def host_flag(name: str, flag) -> bool:
    """``bool(flag)`` for a device tensor, as a counted and timed
    synchronisation: ``host_syncs.<name>`` counts the calls and
    ``host_sync_wait_s.<name>`` sums the seconds the host waited for the
    device to reach the flag."""
    t0 = time.perf_counter()
    value = bool(flag)
    _global_counters.inc(f"host_syncs.{name}")
    _global_counters.inc(f"host_sync_wait_s.{name}", time.perf_counter() - t0)
    return value
