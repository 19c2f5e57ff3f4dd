"""Fresh-buffer device->host probe of the serving process.

Counterpart of ``d2h_probe`` in image_restoration_platform_tpu/
utils/measure_guard.py: the admin route ``POST /v1/admin/probe/d2h`` lets an
HTTP-side measurement harness stamp its host-timed records with the
device->host rate the serving process sees. The copy is timed on the card
with CUDA events around it.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

PROBE_MB = 12
PROBE_LIMIT_S = 5.0


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
