"""Boot-time warm-up across every documented serving surface.

Counterpart of image_restoration_platform_tpu/serve/warmup.py. The programs
are eager, so warming runs each one once: the first launch builds the CUDA
kernels with nvcc and fills cuDNN's plan caches, and the first request does
not pay for that. Restore-style families warm every (size bucket x
power-of-two batch bucket) the micro-batcher can form; SR families warm the
direct path plus the tiled 2K->4K canvas in both egress modes; the
``"fusion"`` pseudo-surface warms k-image fuse_batch (SERVE_WARMUP /
SERVE_WARMUP_FAMILIES, api/app.py).
"""

from __future__ import annotations

import time

import numpy as np


def _batch_buckets(max_batch: int) -> tuple[int, ...]:
    batches, b = [], 1
    while b <= max_batch:
        batches.append(b)
        b *= 2
    return tuple(batches)


def warmup_restore(engine, family_name="restore-unet", sizes=None, batches=None) -> float:
    """Warm the restore programs for the serving buckets; returns seconds.
    Defaults to every power-of-two batch bucket up to max_batch: cuDNN picks
    its plans per shape, so a warm start that only covered b1 would still pay
    on the first batched burst per size."""
    sizes = sizes or engine.config.size_buckets
    batches = batches or _batch_buckets(engine.config.max_batch)
    t0 = time.perf_counter()
    for size in sizes:
        for batch in batches:
            imgs = np.zeros((batch, size, size, 3), dtype=np.uint8)
            engine.restore_batch(imgs, family_name=family_name)
    warm_s = time.perf_counter() - t0
    engine.logger.info(
        "Warmup complete",
        {"family": family_name, "sizes": list(sizes), "seconds": round(warm_s, 1)},
    )
    return warm_s


def warmup_serving(
    engine,
    families: tuple[str, ...] = ("restore-unet",),
    sizes: tuple[int, ...] | None = None,
    batches: tuple[int, ...] | None = None,
    fusion_k: tuple[int, ...] = (3,),
    sr_tiled_canvas: int | None = None,
) -> dict:
    """Warm EVERY surface ``families`` names; returns {surface: seconds}.

    SR families warm the direct path at buckets <= SR_TILE_THRESHOLD plus
    the tiled canvas — the routes _restore_sr actually takes
    (serve/restorator.py)."""
    sizes = sizes or engine.config.size_buckets
    batches = batches or _batch_buckets(engine.config.max_batch)
    report: dict[str, float] = {}

    def timed(tag, fn):
        t0 = time.perf_counter()
        fn()
        report[tag] = round(time.perf_counter() - t0, 3)

    for fam in families:
        if fam == "fusion":
            for size in sizes:
                for k in fusion_k:
                    canvas = np.zeros((k, size, size, 3), dtype=np.uint8)
                    vhw = np.tile(np.asarray([[size, size]], np.int32), (k, 1))
                    jf = np.zeros((k,), np.float32)
                    timed(
                        f"fusion/k{k}/{size}",
                        lambda c=canvas, v=vhw, j=jf: engine.fuse_batch(c, v, j),
                    )
        elif fam.startswith("sr-"):
            for size in sizes:
                if size <= engine.SR_TILE_THRESHOLD:
                    img = np.zeros((1, size, size, 3), dtype=np.uint8)
                    timed(f"{fam}/direct/{size}", lambda i=img, f=fam: engine.sr_batch(i, f))
            tc = sr_tiled_canvas or engine.SR_TILED_CANVAS
            canvas = np.zeros((tc, tc, 3), dtype=np.uint8)
            tile = min(256, tc)  # clamp for small test canvases
            # yuv420 planes egress is what the serving path takes for huge
            # canvases (restorator._restore_sr); rgb is the fallback when a
            # host resize follows — warm both programs
            for mode in ("yuv420", "rgb"):
                timed(
                    f"{fam}/tiled-{mode}/{tc}",
                    lambda c=canvas, f=fam, t=tile, m=mode: engine.sr_tiled(
                        c, f, tile=t, output=m
                    ),
                )
        else:
            for size in sizes:
                for batch in batches:
                    imgs = np.zeros((batch, size, size, 3), dtype=np.uint8)
                    timed(
                        f"{fam}/restore/{size}/b{batch}",
                        lambda i=imgs, f=fam: engine.restore_batch(i, family_name=f),
                    )
    engine.logger.info(
        "Serving warmup complete",
        {"surfaces": len(report), "seconds": round(sum(report.values()), 1)},
    )
    return report
