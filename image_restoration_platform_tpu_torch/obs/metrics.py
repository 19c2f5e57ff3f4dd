"""In-process serving counters and gauges (images, device seconds, batch
sizes, host syncs), copied from image_restoration_platform_tpu/obs/metrics.py
(``Counters``). The request-duration ring buffer of the health route comes
with the API."""

from __future__ import annotations

import threading
import time


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


_global_counters = Counters()


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
