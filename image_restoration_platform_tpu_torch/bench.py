"""Benchmark of the port: images/s per card at 512 px single-image restore,
end to end.

    python -m image_restoration_platform_tpu_torch.bench

Port of the repository's root bench.py. It times the full serving path
(decode -> letterbox -> the restore program: masked classification,
conditioning, the gated deblock and deblur stages and the restore-unet
forward -> crop -> encode) through ``RestoratorService`` on the card, in the
reference's sections:

1. warm-up: two requests (model load, cuDNN plans);
2. 12 single 512 px requests, one at a time: the headline images/s, p50/p95;
3. 6 batched rounds of 8 concurrent requests through ``MicroBatcher``, with
   the mean batch the rounds formed;
4. the device-only step: the restore program on resident inputs, timed with
   CUDA events around a chain of 20 steps minus a chain of 1, divided by 19
   (the reference's chain difference). The three host syncs of a step (the
   stages' fire decisions) are inside it. ``mfu`` is the model FLOPs of the
   canonical program (deblock and deblur off, as the reference counts them)
   over that step time over the card's bf16 peak (utils/peaks.py): the
   convolutions and matmuls as ``torch.utils.flop_counter.FlopCounterMode``
   counts them, plus 4 N H T^2 D per launch of the attention kernel, which
   the counter cannot see;
5. the per-family sweep, each surface cold then warm: restore-unet-small,
   diffusion-restore, sr-x2 direct, sr-x2 tiled 2048 -> 4096 with yuv420
   egress, and a fusion of three.

The headline is ONE JSON line on stdout after the last section; the
detail goes to stderr. ``detail`` holds the platform, the batched images/s,
the device ms per image, ``mfu``, the validity stamp (utils/measure_guard.py:
a device->host probe before and after) and the attention and blend kernel
launches of the run. A failing section fails the run (non-zero exit).
``vs_baseline`` divides by 0.0454 images/s, the JAX reference pipeline's
figure on a 1-core CPU (XLA:CPU, BASELINE.md), not a card's.

Without a card it raises unless given ``--device cpu``; ``--device cpu``
and the size and count flags exist for the CPU test.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the reference pipeline on a 1-core CPU (XLA:CPU, restore-unet, 512 px end
# to end; BASELINE.md): a JAX figure, not a measurement of the port
CPU_BASELINE_IMAGES_PER_SEC = 0.0454
FAMILY = "restore-unet"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device_seconds(device: torch.device, work) -> float:
    """Seconds of ``work()`` on the device's clock: CUDA events on a card,
    the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        work()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    work()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def model_flops(engine, canvas, valid, is_jpeg) -> tuple[float, float]:
    """(FLOPs of one canonical restore step on these inputs, of which the
    attention kernel's). Canonical: the restore program with the deblock and
    deblur stages off, as the reference counts model FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    from .models.registry import attention_shapes
    from .ops.cuda.attention import flash_kernel
    from .serve.programs import build_restore_program

    program = build_restore_program(
        FAMILY, dtype=engine.dtype, use_s2d_io=engine._uses_s2d_io(FAMILY),
        use_deblur=False, use_deblock=False,
    )
    model = engine.model(FAMILY)
    before = flash_kernel.launches
    with FlopCounterMode(display=False) as counter:
        program(model, canvas, valid, is_jpeg)
    launched = flash_kernel.launches - before
    shapes = attention_shapes(FAMILY, (canvas.shape[1],), canvas.shape[0])
    attention = float(launched * sum(4 * n * h * t * t * d for n, h, t, d in shapes))
    return float(counter.get_total_flops()) + attention, attention


def _parse(argv):
    ap = argparse.ArgumentParser(description="Benchmark the port's 512 px restore on one card.")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, default=512, help="the square bucket and the test image's side")
    ap.add_argument("--batch", type=int, default=8, help="the batched section's batch")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--single", type=int, default=12)
    ap.add_argument("--batched", type=int, default=6, help="rounds of --batch concurrent requests")
    ap.add_argument("--chain", type=int, default=20, help="steps in the device-only chain")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    from . import imageio
    from .config import ServingConfig
    from .obs.metrics import get_counters
    from .ops.cuda.attention import flash_kernel
    from .ops.cuda.blend import blend_kernel
    from .serve import MicroBatcher, RestorationEngine, RestoratorService, resolve_device
    from .utils.measure_guard import guarded
    from .utils.peaks import PEAK_FLOPS

    device = resolve_device(args.device)
    size, batch = args.size, args.batch
    cfg = ServingConfig(size_buckets=(size,), max_batch=batch)
    engine = RestorationEngine(device=device, serving_config=cfg)
    service = RestoratorService(engine=engine, serving_config=cfg, device=device)
    for kernel in (flash_kernel, blend_kernel):  # the run's launches, from 0
        kernel.launches = 0
        kernel.launches_by_variant = dict.fromkeys(kernel.launches_by_variant, 0)

    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(0, 20, (size, size, 3)) + [90, 80, 70], 0, 255).astype(np.uint8)
    photo = imageio.encode_jpeg(img, quality=80)
    detail: dict = {
        "platform": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": str(engine.dtype).replace("torch.", ""),
        "baseline": {"images_per_sec": CPU_BASELINE_IMAGES_PER_SEC,
                     "what": "the JAX reference pipeline on a 1-core CPU (XLA:CPU), BASELINE.md"},
    }

    def restore():
        result = service.restore(photo, options={"model": FAMILY})
        if not result.get("success"):
            raise RuntimeError(f"restore failed: {result.get('error')}")

    with guarded(device=device) as guard:
        # ---- warm-up: model load, cuDNN plans
        t0 = time.time()
        for _ in range(args.warm):
            restore()
        log(f"warmup: {time.time() - t0:.1f}s")

        # ---- single-image end to end
        latencies = []
        t0 = time.time()
        for _ in range(args.single):
            t = time.time()
            restore()
            latencies.append((time.time() - t) * 1000)
        e2e_ips = len(latencies) / (time.time() - t0)
        detail["p50_ms"] = round(float(np.percentile(latencies, 50)), 1)
        detail["p95_ms"] = round(float(np.percentile(latencies, 95)), 1)
        log(f"e2e single {size}px: {e2e_ips:.3f} images/sec | p50 {detail['p50_ms']:.0f} ms | "
            f"p95 {detail['p95_ms']:.0f} ms")

        # ---- batched: rounds of `batch` concurrent requests through the micro-batcher
        canvas = np.repeat(img[None], batch, axis=0)
        valid = np.tile(np.asarray([[size, size]], np.int32), (batch, 1))
        jpeg_f = np.ones((batch,), np.float32)
        # (one pool for every round: threads started per round arrive too
        # far apart for the batcher's linger and split the round's batch)
        batcher = MicroBatcher(engine, cfg, device=device)
        pool = ThreadPoolExecutor(max_workers=batch)
        try:
            def round_trip():
                list(pool.map(lambda i: batcher.submit(canvas[i], (size, size), True, FAMILY), range(batch)))

            round_trip()  # the batch program's first run
            before = get_counters().snapshot().get(f"restore_batches.{size}", 0)
            t0 = time.time()
            for _ in range(args.batched):
                round_trip()
            batched_ips = args.batched * batch / (time.time() - t0)
            batches = get_counters().snapshot().get(f"restore_batches.{size}", 0) - before
        finally:
            pool.shutdown()
            batcher.shutdown()
        detail["batched_images_per_sec_per_chip"] = round(batched_ips, 3)
        detail["batched_mean_batch"] = args.batched * batch / batches
        log(f"batched {size}px (rounds of {batch}, MicroBatcher): {batched_ips:.3f} images/sec/chip, "
            f"mean batch {detail['batched_mean_batch']:.2f}")

        # ---- device-only step on resident inputs, chain-differenced
        model = engine.model(FAMILY)
        program = engine._program(FAMILY, "rgb")
        args_d = (torch.from_numpy(canvas).to(device), torch.from_numpy(valid).to(device),
                  torch.from_numpy(jpeg_f).to(device))

        def chain(n: int) -> float:
            def work():
                for _ in range(n):
                    program(model, *args_d)
            return _device_seconds(device, work)

        chain(1)
        step_s = min((chain(args.chain) - chain(1)) / (args.chain - 1) for _ in range(2))
        detail["device_step_ms"] = round(step_s * 1000.0, 4)
        detail[f"device_ms_per_image_b{batch}"] = round(step_s / batch * 1000.0, 4)
        flops, attention_flops = model_flops(engine, *args_d)
        detail["model_flops_per_step"] = flops
        detail["attention_flops_per_step"] = attention_flops
        peak = PEAK_FLOPS.get(detail["dtype"]) if device.type == "cuda" else None
        detail["peak_flops"] = peak
        detail["mfu"] = round(flops / step_s / peak, 4) if peak else None
        log(f"device-only {size}px b{batch}: {step_s * 1000:.3f} ms a step, "
            f"{detail[f'device_ms_per_image_b{batch}']:.3f} ms/img | {flops / 1e9:.1f} GFLOP a step"
            + (f" | MFU {detail['mfu'] * 100:.2f}%" if detail["mfu"] else ""))

        # ---- per-family sweep: the first call (model load, plans) and the next
        half = img[: size // 2, : size // 2]
        surfaces = [
            ("restore-unet-small", lambda: service.restore(photo, options={"model": "restore-unet-small"})),
            ("diffusion-restore", lambda: service.restore(photo, options={"model": "diffusion-restore"})),
            ("sr-x2-direct", lambda: service.restore(imageio.encode_jpeg(half, quality=80),
                                                     options={"model": "sr-x2"})),
            (f"sr-x2-tiled-{4 * size}", lambda: engine.sr_tiled(
                np.repeat(np.repeat(img, 4, axis=0), 4, axis=1), "sr-x2", output="yuv420")),
            ("fusion-k3", lambda: engine.fuse_batch(
                np.repeat(img[None], 3, axis=0), np.tile(np.asarray([[size, size]], np.int32), (3, 1)),
                np.ones((3,), np.float32))),
        ]
        families = {}
        for name, call in surfaces:
            timings = []
            for _ in range(2):
                t = time.time()
                result = call()
                timings.append((time.time() - t) * 1000)
                if isinstance(result, dict) and not result.get("success"):
                    raise RuntimeError(f"family {name} failed: {result.get('error')}")
            families[name] = {"cold_ms": round(timings[0], 1), "warm_ms": round(timings[1], 1)}
            log(f"family {name}: cold {timings[0]:.0f} ms -> warm {timings[1]:.0f} ms")
        detail["families"] = families

    guard.stamp(detail)
    detail["launches"] = {"flash_attention": flash_kernel.launches, "blend_tiles": blend_kernel.launches}
    print(json.dumps({
        "metric": f"images_per_sec_per_chip_{size}px_single_restore_e2e",
        "value": round(e2e_ips, 4),
        "unit": "images/sec/chip",
        "vs_baseline": round(e2e_ips / CPU_BASELINE_IMAGES_PER_SEC, 2),
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
