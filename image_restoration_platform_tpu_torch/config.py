"""Typed configuration with environment overrides.

The port's copy of image_restoration_platform_tpu/config.py: the boot-time
secrets gate (``assert_required_secrets``), the rate-limit, upload, credits
and queue configs, ``ServingConfig`` and ``Config`` / ``load_config``; same
environment variables, same defaults but the W-fold's (below).

``SERVE_FOLD_W`` / ``SERVE_FOLD_W_SR`` choose the W-fold serving layout
(models/folded.py) as in the reference: the same function with width pairs
folded into channels, so every convolution runs at twice the channels and
half the width on a half-zero kernel. Their defaults are the card's, not the
reference's (on for the restore UNets, off for SR: the reference has the
opposite), from ``chip_smoke.py``'s fold phase on an NVIDIA H100 80GB HBM3 at
700.00 W, graph steps, median of 24 each taken in alternation: the folded
restore-unet 512 b8 step 29.88 ms against 31.92 unfolded (interquartile
spreads 0.59 and 0.35 ms), the folded sr_tiled 2048 step 99.60 ms against
94.64 (spreads 2.17 and 2.39 ms).

``DEVICE_COST_PER_HOUR_USD`` is the port's own: the price of one card-hour
that ``estimatedCostUsd`` and the ``tpu_cost_usd`` counter are computed at
(the reference prices a TPU chip-hour instead).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field


# Required in production deployments (reference: config/secrets.js:1-8). In dev
# every consumer degrades to a local fake, mirroring the reference's mock tiers.
REQUIRED_SECRETS = (
    "FIRESTORE_CREDS",
    "REDIS_URL",
    "STRIPE_WEBHOOK_SECRET",
    "NEXT_PUBLIC_API_URL",
    "LOG_LEVEL",
)


def list_required_secrets() -> tuple[str, ...]:
    return REQUIRED_SECRETS


def assert_required_secrets(env: dict | None = None, *, exit_on_missing: bool = True) -> list[str]:
    """Fail-fast startup gate (reference: config/secrets.js:17-38).

    Returns the list of missing secrets; exits the process when
    ``exit_on_missing`` and anything is missing. ``ALLOW_DEGRADED=1`` is an
    explicit dev/TPU-bench opt-out (all external clients run as local fakes);
    the default is fail-fast, matching the reference's secrets.js gate.
    """
    env = env if env is not None else os.environ
    missing = [k for k in REQUIRED_SECRETS if not env.get(k)]
    if missing and env.get("ALLOW_DEGRADED", "0") != "1" and exit_on_missing:
        print(
            f"[secrets] Missing required secrets: {', '.join(missing)}. "
            "Set them in the environment (the reference injects them via Doppler).",
            file=sys.stderr,
        )
        raise SystemExit(1)
    return missing


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
class RateLimitConfig:
    # knob names follow the reference (middleware/rateLimit.js:74-84)
    user_limit: int = field(default_factory=lambda: _env_int("RATE_LIMIT_USER_LIMIT", 120))
    user_interval_s: int = field(default_factory=lambda: _env_int("RATE_LIMIT_USER_INTERVAL", 60))
    ip_limit: int = field(default_factory=lambda: _env_int("RATE_LIMIT_IP_LIMIT", 100))
    ip_interval_s: int = field(default_factory=lambda: _env_int("RATE_LIMIT_IP_INTERVAL", 60))


@dataclass
class UploadConfig:
    # reference: middleware/uploadValidation.js:6-9, imagePreprocess.js:4-5
    max_file_size_bytes: int = 10 * 1024 * 1024
    max_dimension: int = 2048
    jpeg_quality: int = 85
    max_images_per_call: int = 3
    accepted_mimes: tuple[str, ...] = ("image/jpeg", "image/png", "image/webp")
    accepted_extensions: tuple[str, ...] = (".jpg", ".jpeg", ".png", ".webp")
    retry_after_seconds: int = 60


@dataclass
class CreditsConfig:
    # reference: services/credits.js:14-16
    daily_free_limit: int = field(default_factory=lambda: _env_int("CREDITS_DAILY_FREE_LIMIT", 3))
    cache_ttl_seconds: int = 60


@dataclass
class QueueConfig:
    # reference: queues/jobQueue.js:4-9,37-45
    attempts: int = field(default_factory=lambda: _env_int("JOBS_MAX_ATTEMPTS", 5))
    backoff_base_ms: int = field(default_factory=lambda: _env_int("JOBS_BACKOFF_BASE_MS", 500))
    backoff_jitter: float = 0.3
    keep_completed: int = field(default_factory=lambda: _env_int("JOBS_KEEP_COMPLETED", 100))
    keep_failed: int = field(default_factory=lambda: _env_int("JOBS_KEEP_FAILED", 500))


# an operator's price for one H100 card-hour, not a measurement: a round
# figure for renting one card on demand; set DEVICE_COST_PER_HOUR_USD to
# what the deployment pays
DEVICE_COST_PER_HOUR_USD = 3.0


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
    # serve the restore UNet families (restore-unet, restore-unet-small,
    # diffusion-restore) in the W-folded layout (models/folded.py): the same
    # function, every convolution at twice the channels and half the width,
    # the decoder's upsample inside its convolutions. It turns space-to-depth
    # IO off for the families it folds. On by default: on the card the folded
    # 512 b8 step is 6 % faster (fewer copies and elementwise passes than the
    # unfolded decoder's upsample; see the module docstring)
    fold_w: bool = field(default_factory=lambda: _env_int("SERVE_FOLD_W", 1) == 1)
    # the W-fold for the SR families (sr_batch, sr_tiled, the mesh sr_tiled;
    # never sr_spatial, whose halo exchange is defined on unfolded weights).
    # Off by default: on the card the folded sr_tiled 2048 step is 5 % slower
    # (its convolutions do twice the multiply-adds; nothing else shrinks)
    fold_w_sr: bool = field(default_factory=lambda: _env_int("SERVE_FOLD_W_SR", 0) == 1)
    # gated spectral Wiener deblur stage (ops/deblur.py)
    deblur: bool = field(default_factory=lambda: _env_int("SERVE_DEBLUR", 1) == 1)
    # gated JPEG deblocking stage (ops/deblock.py)
    deblock: bool = field(default_factory=lambda: _env_int("SERVE_DEBLOCK", 1) == 1)
    # 16-bit PNG uploads decode to raw u16 and run the float Wiener deblur
    # with the disk (defocus) channel on before 8-bit quantization
    # (ops/deblur.py deblur_canvas_f32); 8-bit traffic is untouched
    hdr_deblur: bool = field(default_factory=lambda: _env_int("SERVE_HDR_DEBLUR", 1) == 1)
    # space-to-depth IO for the s2d-stem UNet families: the residual add runs
    # in s2d layout and egress reads the s2d tensor directly
    s2d_io: bool = field(default_factory=lambda: _env_int("SERVE_S2D_IO", 1) == 1)
    # restore egress: "yuv420" emits (Y, Cb, Cr) u8 planes for the JPEG
    # encoder (1.5 B/px device->host); "rgb" emits the RGB canvas
    restore_egress: str = field(
        default_factory=lambda: os.environ.get("SERVE_RESTORE_EGRESS", "yuv420")
    )
    # USD per card-hour behind estimatedCostUsd and tpu_cost_usd
    device_cost_per_hour_usd: float = field(
        default_factory=lambda: _env_float("DEVICE_COST_PER_HOUR_USD", DEVICE_COST_PER_HOUR_USD)
    )


@dataclass
class MeshConfig:
    # axis sizes; -1 means "use all remaining devices on the data axis"
    data: int = field(default_factory=lambda: _env_int("MESH_DATA", -1))
    tensor: int = field(default_factory=lambda: _env_int("MESH_TENSOR", 1))
    spatial: int = field(default_factory=lambda: _env_int("MESH_SPATIAL", 1))


@dataclass
class Config:
    port: int = field(default_factory=lambda: _env_int("PORT", 8080))
    log_level: str = field(default_factory=lambda: os.environ.get("LOG_LEVEL", "info"))
    health_metric_sample_size: int = field(
        default_factory=lambda: _env_int("HEALTH_METRIC_SAMPLE_SIZE", 1000)
    )
    rate_limit: RateLimitConfig = field(default_factory=RateLimitConfig)
    upload: UploadConfig = field(default_factory=UploadConfig)
    credits: CreditsConfig = field(default_factory=CreditsConfig)
    queue: QueueConfig = field(default_factory=QueueConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def load_config() -> Config:
    return Config()
