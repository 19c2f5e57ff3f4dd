"""Serving configuration with environment overrides.

The port's copy of the fields of image_restoration_platform_tpu/config.py
(``ServingConfig``) that the serving paths read: same environment variables,
same defaults.

Not ported: ``SERVE_FOLD_W`` / ``SERVE_FOLD_W_SR``. The W-fold
(models/folded.py in the JAX package) is a TPU lane-fill reparameterization
of the same function; it has no counterpart here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclass
class ServingConfig:
    # micro-batching: requests within max_wait_ms coalesce into one batch
    max_batch: int = field(default_factory=lambda: _env_int("SERVE_MAX_BATCH", 8))
    max_wait_ms: float = field(default_factory=lambda: _env_float("SERVE_MAX_WAIT_MS", 5.0))
    # square canvas sizes every request is letterboxed into
    size_buckets: tuple[int, ...] = field(
        default_factory=lambda: tuple(
            int(s)
            for s in os.environ.get("SERVE_SIZE_BUCKETS", "256,512,1024").split(",")
            if s
        )
    )
    # restore_batch fan-out: images restored at once, and the stagger between
    # their starts
    batch_concurrency: int = field(
        default_factory=lambda: max(1, _env_int("RESTORATION_BATCH_CONCURRENCY", 3))
    )
    batch_delay_ms: int = field(default_factory=lambda: _env_int("RESTORATION_BATCH_DELAY_MS", 0))
    request_deadline_s: float = field(default_factory=lambda: _env_float("SERVE_DEADLINE_S", 120.0))
    # batches dispatched to the device but not yet fetched (2 = double-buffering)
    pipeline_depth: int = field(default_factory=lambda: max(1, _env_int("SERVE_PIPELINE_DEPTH", 2)))
    # a queue whose oldest request waited longer than this is dispatched next
    fairness_age_ms: float = field(default_factory=lambda: _env_float("SERVE_FAIRNESS_AGE_MS", 50.0))
    # gated spectral Wiener deblur stage (ops/deblur.py)
    deblur: bool = field(default_factory=lambda: _env_int("SERVE_DEBLUR", 1) == 1)
    # gated JPEG deblocking stage (ops/deblock.py)
    deblock: bool = field(default_factory=lambda: _env_int("SERVE_DEBLOCK", 1) == 1)
    # 16-bit PNG float deblur pre-pass; not ported yet, so where the native
    # codec exists such uploads raise NotImplementedError while this is on
    hdr_deblur: bool = field(default_factory=lambda: _env_int("SERVE_HDR_DEBLUR", 1) == 1)
    # space-to-depth IO for the s2d-stem UNet families: the residual add runs
    # in s2d layout and egress reads the s2d tensor directly
    s2d_io: bool = field(default_factory=lambda: _env_int("SERVE_S2D_IO", 1) == 1)
    # restore egress: "yuv420" emits (Y, Cb, Cr) u8 planes for the JPEG
    # encoder (1.5 B/px device->host); "rgb" emits the RGB canvas
    restore_egress: str = field(
        default_factory=lambda: os.environ.get("SERVE_RESTORE_EGRESS", "yuv420")
    )
