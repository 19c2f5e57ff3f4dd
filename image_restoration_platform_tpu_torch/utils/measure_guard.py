"""Measurement validity: fresh-buffer device->host probes and the stamp of
a measured record.

Counterpart of image_restoration_platform_tpu/utils/measure_guard.py. A
host-timed record is VALID only if a device->host probe before and after
its timed section both passed (a stalled copy path would otherwise be timed
as step time); a record timed on the device's own clock is exempt and
stamps DEVICE_CLOCK; a record taken on the CPU stamps CPU. The probe times
the copy on the card with CUDA events around it, and the admin route
``POST /v1/admin/probe/d2h`` serves it to an HTTP-side harness.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

PROBE_MB = 12
PROBE_LIMIT_S = 5.0

VALID = "VALID"
INVALID = "INVALID"
DEVICE_CLOCK = "DEVICE_CLOCK"
CPU = "CPU"


def d2h_probe(
    mb: int = PROBE_MB, limit_s: float = PROBE_LIMIT_S, device: str | torch.device = "cuda"
) -> Dict[str, Any]:
    """Time the device->host copy of a fresh ``mb`` MB buffer on ``device``
    (a buffer never fetched before, so no cached page is read back)."""
    from ..serve.engine import resolve_device

    device = resolve_device(device)
    if device.type == "cpu":
        return {"mode": "cpu", "ok": True}
    a = np.random.default_rng(int(time.time() * 1e3) % 2**31).integers(
        0, 255, (1024, 1024, mb), dtype=np.uint8
    )
    d = torch.from_numpy(a).to(device)
    host = torch.empty(d.shape, dtype=d.dtype)  # pageable, like the engine's fetch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    host.copy_(d)
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3
    return {
        "mode": "cuda",
        "seconds": round(dt, 6),
        "mb_per_s": round(mb / dt, 2),
        "ok": dt < limit_s,
    }


def stamp(record: Dict[str, Any], pre: Dict[str, Any], post: Dict[str, Any],
          clock: str = "host") -> Dict[str, Any]:
    """Attach a validity verdict to a measurement record (in place):
    host-clock records are VALID only if both probes passed; device-clock
    records are exempt."""
    if clock == "device":
        status = DEVICE_CLOCK
    elif pre.get("mode") == "cpu" and post.get("mode") == "cpu":
        status = CPU
    else:
        status = VALID if (pre.get("ok") and post.get("ok")) else INVALID
    record["validity"] = {"status": status, "clock": clock, "pre": pre, "post": post}
    return record


class guarded:
    """Context manager for a measured section on ``device``.

    with guarded(device=...) as g:
        ... timed work ...
    g.stamp(record)   # runs the post-probe, attaches validity

    With ``clock="device"`` the probes are skipped and the section's own
    clock is the card's: CUDA events recorded at entry and exit, read as
    ``g.device_ms`` (None on the CPU, which has no device clock)."""

    def __init__(self, clock: str = "host", mb: int = PROBE_MB,
                 limit_s: float = PROBE_LIMIT_S, device: str | torch.device = "cuda"):
        from ..serve.engine import resolve_device

        self.clock = clock
        self.mb = mb
        self.limit_s = limit_s
        self.device = resolve_device(device)
        self.pre: Dict[str, Any] = {}
        self._events = None

    def _probe(self) -> Dict[str, Any]:
        if self.clock == "device":
            return {"ok": True, "mode": "device-clock"}
        return d2h_probe(self.mb, self.limit_s, self.device)

    def __enter__(self) -> "guarded":
        self.pre = self._probe()
        if self.clock == "device" and self.device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        return None

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between entry and exit on the card's clock."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])

    def stamp(self, record: Dict[str, Any]) -> Dict[str, Any]:
        if self.device_ms is not None:
            record["device_ms"] = self.device_ms
        return stamp(record, self.pre, self._probe(), clock=self.clock)
