"""Boot-time warm-up across every documented serving surface.

Counterpart of image_restoration_platform_tpu/serve/warmup.py. Warming a
surface serves it once, which builds its executable (serve/exec_cache.py):
on a card the kernels' nvcc builds, the cuDNN and cuFFT plans and the CUDA
graphs of every segment and BOTH branches of every stage decision, whatever
the warming input fires (zero images fire nothing; the reference's
``lax.cond`` compiles both branches into one executable for the same
reason). So no request builds anything. Restore-style families warm every
(size bucket x power-of-two batch bucket) the micro-batcher can form, in RGB
and, where the restorator takes it, YCbCr-plane egress; SR families warm the direct path plus the tiled 2K->4K canvas in both egress
modes; the ``"fusion"`` pseudo-surface warms k-image fuse_batch
(SERVE_WARMUP / SERVE_WARMUP_FAMILIES, api/app.py). The largest shapes go
first: every graph of an engine shares one memory pool, which then settles
at the largest graph's working memory. On a mesh engine the same calls
build the mesh executables (the ``"mesh"`` restore step of every bucket the
data axis rounds to, ``"sr_tiled_mesh"``), and on a spatial mesh the SRNet
families warm ``sr_spatial`` at every canvas the restorator row-shards in
place of the tiled programs. A surface the engine serves W-folded
(``fold_w``, ``fold_w_sr``: models/folded.py) warms its folded executable,
under a key that carries the fold.
"""

from __future__ import annotations

import time

import numpy as np

from ..models import SRNetConfig, get_family, is_sr_family


def _batch_buckets(max_batch: int) -> tuple[int, ...]:
    batches, b = [], 1
    while b <= max_batch:
        batches.append(b)
        b *= 2
    return tuple(batches)


def _largest_first(values) -> tuple[int, ...]:
    return tuple(sorted(values, reverse=True))


def _spatial_mesh(engine) -> bool:
    from ..parallel.mesh import AXIS_SPATIAL

    return engine.mesh is not None and engine.mesh.shape[AXIS_SPATIAL] > 1


def _restore_egresses(engine, family_name: str) -> tuple[str, ...]:
    """The egresses the restorator serves a restore family in: RGB, and the
    YCbCr planes where they go straight to the native JPEG encoder
    (serve/restorator.py)."""
    from .. import imageio

    if (family_name != "diffusion-restore" and engine.config.restore_egress == "yuv420"
            and imageio.native_available()):
        return ("rgb", "yuv420")
    return ("rgb",)


def warmup_restore(engine, family_name="restore-unet", sizes=None, batches=None) -> float:
    """Warm the restore programs for the serving buckets; returns seconds.
    Defaults to every power-of-two batch bucket up to max_batch: cuDNN picks
    its plans per shape, so a warm start that only covered b1 would still pay
    on the first batched burst per size."""
    sizes = _largest_first(sizes or engine.config.size_buckets)
    batches = _largest_first(batches or _batch_buckets(engine.config.max_batch))
    t0 = time.perf_counter()
    for size in sizes:
        for batch in batches:
            imgs = np.zeros((batch, size, size, 3), dtype=np.uint8)
            for egress in _restore_egresses(engine, family_name):
                engine.restore_batch(imgs, family_name=family_name, egress=egress)
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
    sizes = _largest_first(sizes or engine.config.size_buckets)
    batches = _largest_first(batches or _batch_buckets(engine.config.max_batch))
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
        elif is_sr_family(fam):
            for size in sizes:
                if size <= engine.SR_TILE_THRESHOLD:
                    img = np.zeros((1, size, size, 3), dtype=np.uint8)
                    timed(f"{fam}/direct/{size}", lambda i=img, f=fam: engine.sr_batch(i, f))
            tc = sr_tiled_canvas or engine.SR_TILED_CANVAS
            if _spatial_mesh(engine) and isinstance(get_family(fam).config, SRNetConfig):
                # on a spatial mesh the restorator row-shards every canvas
                # above the direct threshold (restorator._restore_sr)
                for size in _largest_first({s for s in sizes if s > engine.SR_TILE_THRESHOLD} | {tc}):
                    canvas = np.zeros((size, size, 3), dtype=np.uint8)
                    timed(f"{fam}/spatial/{size}", lambda c=canvas, f=fam: engine.sr_spatial(c, f))
                continue
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
                    for egress in _restore_egresses(engine, fam):
                        tag = "restore" if egress == "rgb" else f"restore-{egress}"
                        timed(
                            f"{fam}/{tag}/{size}/b{batch}",
                            lambda i=imgs, f=fam, e=egress: engine.restore_batch(i, family_name=f, egress=e),
                        )
    engine.logger.info(
        "Serving warmup complete",
        {"surfaces": len(report), "seconds": round(sum(report.values()), 1)},
    )
    return report
