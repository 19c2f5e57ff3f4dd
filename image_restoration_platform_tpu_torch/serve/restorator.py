"""Restorator — decode -> letterbox -> restore program -> prompt -> JPEG.

Counterpart of image_restoration_platform_tpu/serve/restorator.py
(``RestoratorService``): ``restore`` for the standard, diffusion and
super-resolution families (direct SRNet up to the 512 bucket, tiled
overlap-blend above it), ``restore_fusion``, the ``restore_batch`` fan-out
and ``get_health_status``, with the reference's result contract (per-stage
timings, degradation analysis, enhanced prompt, metadata with
``classificationIssues``) and its structured failure with error taxonomy and
failed stage.

A 16-bit PNG upload takes the HDR deblur pre-pass (``SERVE_HDR_DEBLUR``,
``_hdr_prepass``) where the native codec exists; without it such an upload
is served on the 8-bit path, as in the reference. ``estimatedCostUsd`` is
the request's device seconds at ``ServingConfig.device_cost_per_hour_usd``
(the card's price), and ``restore`` also adds it to the ``tpu_cost_usd``
counter, under the reference's names. With a mesh whose spatial axis is
larger than 1, a huge super-resolution canvas is row-sharded
(``engine.sr_spatial``) instead of tiled.
"""

from __future__ import annotations

import base64
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import imageio
from ..classify.classifier import DEGRADATION_ORDER, ClassifierService
from ..config import ServingConfig
from ..models import get_family
from ..obs.metrics import get_counters
from ..obs.tracing import get_tracer
from ..ops.resize import fit_inside
from ..parallel.mesh import AXIS_SPATIAL
from ..prompt import PromptEnhancerService
from ..utils.logging import get_logger
from .engine import RestorationEngine, resolve_device
from .programs import sr as sr_programs

def _classify_error(error: Exception) -> str:
    message = str(error).lower()
    if "rate limit" in message or "429" in message:
        return "RATE_LIMIT_EXCEEDED"
    if "timeout" in message or "etimedout" in message:
        return "TIMEOUT"
    if "invalid" in message or "400" in message or "corrupt" in message:
        return "INVALID_INPUT"
    if "unauthorized" in message or "401" in message:
        return "AUTHENTICATION_FAILED"
    if "service unavailable" in message or "503" in message:
        return "SERVICE_UNAVAILABLE"
    if "resource exhausted" in message or "out of memory" in message:
        return "RESOURCE_EXHAUSTED"
    return "UNKNOWN_ERROR"


def _failure_stage(timings: dict) -> str:
    if "classify_ms" in timings and "prompt_ms" not in timings:
        return "PROMPT_ENHANCEMENT"
    if "prompt_ms" in timings and "restore_ms" not in timings:
        return "AI_RESTORATION"
    if "classify_ms" not in timings:
        return "CLASSIFICATION"
    return "UNKNOWN"


class RestoratorService:
    def __init__(
        self,
        engine: RestorationEngine | None = None,
        classifier: ClassifierService | None = None,
        prompt_enhancer: PromptEnhancerService | None = None,
        serving_config: ServingConfig | None = None,
        batcher=None,
        logger=None,
        device: str = "cuda",
    ):
        device = resolve_device(device)
        self.engine = engine or RestorationEngine(device=device, serving_config=serving_config)
        if self.engine.device.type != device.type:
            raise ValueError(f"restorator device {device} differs from the engine's {self.engine.device}")
        self.classifier = classifier or ClassifierService(device=device)
        self.prompt_enhancer = prompt_enhancer or PromptEnhancerService()
        self.config = serving_config or ServingConfig()
        self.batcher = batcher  # optional continuous micro-batcher (serve/batcher.py)
        self.logger = logger or get_logger("restorator")
        self._tracer = get_tracer("restorator")

    def _cost_usd(self, device_s: float) -> float:
        return device_s * self.config.device_cost_per_hour_usd / 3600.0

    # ------------------------------------------------------ size bucketing

    def _bucket_for(self, h: int, w: int) -> int:
        longest = max(h, w)
        for bucket in sorted(self.config.size_buckets):
            if longest <= bucket:
                return bucket
        return max(self.config.size_buckets)

    def _canonicalize(self, img: np.ndarray) -> tuple[np.ndarray, tuple[int, int], int]:
        """Letterbox into the serving bucket: aspect-preserving host Lanczos
        resize to fit, then edge-pad to the square bucket. Returns (canvas,
        (scaled_h, scaled_w), bucket)."""
        h, w = img.shape[:2]
        bucket = self._bucket_for(h, w)
        sw, sh = fit_inside(w, h, bucket)
        if (sh, sw) != (h, w):
            img = imageio.resize_rgb8(img, (sh, sw))
        if (sh, sw) != (bucket, bucket):
            canvas = np.pad(img, ((0, bucket - sh), (0, bucket - sw), (0, 0)), mode="edge")
        else:
            canvas = img
        return canvas, (sh, sw), bucket

    def _wants_hdr(self, image) -> bool:
        if not self.config.hdr_deblur or not isinstance(image, (bytes, bytearray)):
            return False
        if not imageio.native_available():
            return False
        try:
            return (
                imageio.sniff_format(bytes(image[:32])) == "png"
                and imageio.decode_bit_depth(bytes(image[:32])) >= 16
            )
        except ValueError:
            return False

    def _hdr_prepass(self, image) -> tuple[np.ndarray | None, str | None]:
        """16-bit PNG -> float disk-enabled Wiener deconvolution -> u8 pixels.
        The image is edge-padded (never resized) into the smallest serving
        bucket that holds it; an oversized image, or one under 128 px (the
        deblur analysis size), skips the pre-pass. Returns (None, None) to
        fall back to the standard 8-bit decode."""
        pixels16 = imageio.decode_image_u16(bytes(image))
        h, w = pixels16.shape[:2]
        buckets = [b for b in self.config.size_buckets if b >= max(h, w)]
        if not buckets or min(h, w) < 128:
            return None, None
        bucket = min(buckets)
        x = pixels16.astype(np.float32) / 65535.0
        canvas = np.pad(x, ((0, bucket - h), (0, bucket - w), (0, 0)), mode="edge")
        out, _meta = self.engine.hdr_deblur_batch(
            canvas[None],
            np.asarray([[h, w]], np.int32),
            np.zeros((1,), np.float32),  # PNG is lossless: compression 0
        )
        restored = np.clip(np.round(out[0, :h, :w] * 255.0), 0, 255).astype(np.uint8)
        return restored, "png"

    def _decode(self, image, options: dict) -> tuple[np.ndarray, str | None]:
        if isinstance(image, (bytes, bytearray)):
            decoded = imageio.decode_image(bytes(image))
            pixels, fmt = decoded.pixels, decoded.format
        else:
            pixels, fmt = np.asarray(image, dtype=np.uint8), options.get("format")
        if pixels.ndim == 2:
            pixels = np.repeat(pixels[:, :, None], 3, axis=2)
        if pixels.shape[-1] == 4:
            pixels = pixels[:, :, :3]
        return pixels, fmt

    # -------------------------------------------------------------- public

    def restore(
        self,
        image: bytes | np.ndarray,
        user_prompt: str | None = None,
        user_context: dict | None = None,
        options: dict | None = None,
    ) -> dict:
        options = options or {}
        user_context = user_context or {}
        family = options.get("model", "restore-unet")
        start = time.perf_counter()
        timings: dict = {}

        with self._tracer.span(
            "restorator.restore",
            {
                "restoration.user_id": user_context.get("userId", "anonymous"),
                "restoration.has_user_prompt": bool(user_prompt),
            },
        ) as span:
            try:
                # 16-bit PNGs take the float deblur pre-pass (disk channel on)
                # first; it returns (None, None) where it does not apply
                pixels, fmt = self._hdr_prepass(image) if self._wants_hdr(image) else (None, None)
                if pixels is None:
                    with self._tracer.span("restorator.decode"):
                        pixels, fmt = self._decode(image, options)
                kind = get_family(family).kind
                if kind == "sr":
                    return self._restore_sr(pixels, fmt, family, timings, start, span)

                # classification, conditioning and restoration run as one
                # device program; its time is attributed to classify_ms
                t = time.perf_counter()
                with self._tracer.span("restorator.canvas"):
                    canvas, (sh, sw), bucket = self._canonicalize(pixels)
                is_jpeg = fmt == "jpeg"
                # planes whenever the canvas goes straight to the native JPEG
                # encoder; a host resize afterwards, or the Pillow codec,
                # needs RGB
                egress = (
                    "yuv420"
                    if (
                        self.config.restore_egress == "yuv420"
                        and kind != "diffusion"
                        and (sh, sw) == pixels.shape[:2]
                        and imageio.native_available()
                    )
                    else "rgb"
                )
                if self.batcher is not None:
                    restored_canvas, score_vec, engine_meta = self.batcher.submit(
                        canvas, (sh, sw), is_jpeg, family, egress
                    )
                else:
                    out_batch, score_batch, engine_meta = self.engine.restore_batch(
                        canvas[None],
                        np.asarray([[sh, sw]], np.int32),
                        np.asarray([is_jpeg], np.float32),
                        family,
                        egress,
                    )
                    if egress == "yuv420":
                        restored_canvas = tuple(p[0] for p in out_batch)
                    else:
                        restored_canvas = out_batch[0]
                    score_vec = score_batch[0]
                degradation = {k: float(v) for k, v in zip(DEGRADATION_ORDER, score_vec)}
                timings["classify_ms"] = round((time.perf_counter() - t) * 1000, 3)
                span.add_event("classification_complete", {"classification.duration_ms": timings["classify_ms"]})

                t = time.perf_counter()
                enhanced_prompt = self.prompt_enhancer.enhance(degradation, user_prompt, options)
                timings["prompt_ms"] = round((time.perf_counter() - t) * 1000, 3)
                span.add_event("prompt_enhancement_complete", {"prompt.duration_ms": timings["prompt_ms"]})

                # host post: crop the letterbox, restore the native size
                t = time.perf_counter()
                with self._tracer.span("restorator.crop"):
                    if egress == "yuv420":
                        py, pcb, pcr = restored_canvas
                        yuv_planes = (
                            py[:sh, :sw],
                            pcb[: (sh + 1) // 2, : (sw + 1) // 2],
                            pcr[: (sh + 1) // 2, : (sw + 1) // 2],
                        )
                        restored = None
                    else:
                        yuv_planes = None
                        restored = restored_canvas[:sh, :sw]
                        if (sh, sw) != pixels.shape[:2]:
                            restored = imageio.resize_rgb8(restored, pixels.shape[:2])
                timings["restore_ms"] = round((time.perf_counter() - t) * 1000, 3)
                timings["total_ms"] = round((time.perf_counter() - start) * 1000, 3)
                span.add_event("restoration_complete", {"restoration.duration_ms": timings["restore_ms"]})

                issues = [{"type": k, "confidence": v} for k, v in degradation.items() if v > 0.3]
                device_s = engine_meta.get("deviceSeconds", 0.0)
                counters = get_counters()
                counters.inc("restorations_total")
                counters.inc("device_seconds_restore", device_s)
                counters.inc("tpu_cost_usd", self._cost_usd(device_s))
                with self._tracer.span("restorator.encode"):
                    if yuv_planes is not None:
                        jpeg_out = imageio.encode_jpeg_ycbcr420(*yuv_planes, quality=85)
                    else:
                        jpeg_out = imageio.encode_jpeg(restored, quality=85)
                    restored_b64 = base64.b64encode(jpeg_out).decode("ascii")
                result = {
                    "success": True,
                    "restoredImage": restored_b64,
                    "degradationAnalysis": degradation,
                    "enhancedPrompt": enhanced_prompt,
                    "timings": timings,
                    "metadata": {
                        "providerRequestId": engine_meta.get("engineRequestId"),
                        "estimatedCostUsd": round(self._cost_usd(device_s), 8),
                        "billedTokens": None,
                        "deviceSeconds": device_s,
                        "fetchSeconds": engine_meta.get("fetchSeconds"),
                        "model": engine_meta.get("family"),
                        "sizeBucket": bucket,
                        "processingTime": timings["total_ms"],
                        "classificationIssues": issues,
                    },
                }
                span.set_attributes(
                    {
                        "restoration.success": True,
                        "restoration.total_duration_ms": timings["total_ms"],
                        "restoration.device_seconds": device_s,
                    }
                )
                return result

            except Exception as error:
                timings["total_ms"] = round((time.perf_counter() - start) * 1000, 3)
                span.record_exception(error)
                span.set_status("ERROR", str(error))
                self.logger.error(
                    "Restoration failed",
                    {"userId": user_context.get("userId"), "error": str(error), "timings": timings},
                )
                return {
                    "success": False,
                    "error": {
                        "message": str(error),
                        "code": getattr(error, "code", "RESTORATION_FAILED"),
                        "type": _classify_error(error),
                    },
                    "timings": timings,
                    "metadata": {
                        "processingTime": timings["total_ms"],
                        "failureStage": _failure_stage(timings),
                    },
                }

    # -------------------------------------------------- super-resolution

    def _spatial_shards(self) -> int:
        mesh = self.engine.mesh
        return 1 if mesh is None else int(mesh.shape[AXIS_SPATIAL])

    def _restore_sr(self, pixels, fmt, family, timings, start, span) -> dict:
        """Super-resolution: the family's network direct for small inputs;
        for large ones the row-sharded program on a mesh with a spatial axis
        (SRNet families), else tiled overlap-blend."""
        scale = get_family(family).config.scale
        h, w = pixels.shape[:2]
        t = time.perf_counter()
        with self._tracer.span("restorator.canvas"):
            canvas, (sh, sw), bucket = self._canonicalize_sr(pixels)
        if bucket <= sr_programs.DIRECT_MAX:
            out_batch, engine_meta = self.engine.sr_batch(canvas[None], family)
            out_canvas = out_batch[0]
        elif self._spatial_shards() > 1 and get_family(family).row_shards:
            # one canvas row-sharded over the spatial slots, a one-row halo
            # exchanged at every convolution
            out_canvas, engine_meta = self.engine.sr_spatial(canvas, family)
        elif (sh, sw) == (h, w) and imageio.native_available():
            # huge-canvas egress: the device emits YCbCr 4:2:0 planes (1.5
            # B/px instead of 3) and the native encoder consumes them raw;
            # only when no host resize follows
            out_canvas, engine_meta = self.engine.sr_tiled(canvas, family, output="yuv420")
        else:
            out_canvas, engine_meta = self.engine.sr_tiled(canvas, family)
        with self._tracer.span("restorator.crop"):
            if isinstance(out_canvas, tuple):  # (Y, Cb, Cr) planes
                py, pcb, pcr = out_canvas
                hs, ws = sh * scale, sw * scale
                yuv_planes = (py[:hs, :ws], pcb[: hs // 2, : ws // 2], pcr[: hs // 2, : ws // 2])
            else:
                yuv_planes = None
                restored = out_canvas[: sh * scale, : sw * scale]
                if (sh, sw) != (h, w):
                    restored = imageio.resize_rgb8(restored, (h * scale, w * scale))
        timings["restore_ms"] = round((time.perf_counter() - t) * 1000, 3)
        timings["classify_ms"] = 0.0
        timings["prompt_ms"] = 0.0
        timings["total_ms"] = round((time.perf_counter() - start) * 1000, 3)
        device_s = engine_meta.get("deviceSeconds", 0.0)
        span.set_attributes({"restoration.sr_scale": scale, "restoration.success": True})
        with self._tracer.span("restorator.encode"):
            if yuv_planes is not None:
                jpeg_bytes = imageio.encode_jpeg_ycbcr420(*yuv_planes, quality=90)
            else:
                jpeg_bytes = imageio.encode_jpeg(restored, quality=90)
            restored_b64 = base64.b64encode(jpeg_bytes).decode("ascii")
        return {
            "success": True,
            "restoredImage": restored_b64,
            "degradationAnalysis": {},
            "enhancedPrompt": "",
            "timings": timings,
            "metadata": {
                "providerRequestId": engine_meta.get("engineRequestId"),
                "estimatedCostUsd": round(self._cost_usd(device_s), 8),
                "billedTokens": None,
                "deviceSeconds": device_s,
                "fetchSeconds": engine_meta.get("fetchSeconds"),
                "model": family,
                "scaleFactor": scale,
                "outputSize": [h * scale, w * scale],
                "sizeBucket": bucket,
                "processingTime": timings["total_ms"],
                "classificationIssues": [],
            },
        }

    def _canonicalize_sr(self, img: np.ndarray) -> tuple[np.ndarray, tuple[int, int], int]:
        """SR canonicalization allows the tiled canvas's bucket on top of the
        serving buckets (2K input -> 4K output)."""
        h, w = img.shape[:2]
        buckets = tuple(sorted(set(self.config.size_buckets) | {sr_programs.TILED_CANVAS}))
        longest = max(h, w)
        bucket = next((b for b in buckets if longest <= b), buckets[-1])
        sw, sh = fit_inside(w, h, bucket)
        if (sh, sw) != (h, w):
            img = imageio.resize_rgb8(img, (sh, sw))
        if (sh, sw) != (bucket, bucket):
            img = np.pad(img, ((0, bucket - sh), (0, bucket - sw), (0, 0)), mode="edge")
        return img, (sh, sw), bucket

    # ---------------------------------------------------- multi-image fusion

    def restore_fusion(
        self,
        images: list,
        user_prompt: str | None = None,
        user_context: dict | None = None,
        options: dict | None = None,
    ) -> dict:
        """Fuse up to 3 aligned captures into one restored image in a single
        batched device call. All inputs are letterboxed into the largest
        member's bucket; the engine restores each and composites with
        quality-derived weights. The response mirrors restore() plus
        per-image analyses."""
        options = options or {}
        user_context = user_context or {}
        start = time.perf_counter()
        timings: dict = {}
        family = options.get("model", "restore-unet")

        with self._tracer.span(
            "restorator.restoreFusion", {"restoration.fusion_inputs": len(images)}
        ) as span:
            try:
                if not 1 <= len(images) <= 3:
                    raise ValueError("fusion requires 1-3 images")
                decoded = [self._decode(img, options) for img in images]
                ref_pixels, _ = decoded[0]

                t = time.perf_counter()
                bucket = max(self._bucket_for(p.shape[0], p.shape[1]) for p, _ in decoded)
                canvases, valids, jpegs = [], [], []
                for pixels, fmt in decoded:
                    h, w = pixels.shape[:2]
                    sw, sh = fit_inside(w, h, bucket)
                    scaled = imageio.resize_rgb8(pixels, (sh, sw)) if (sh, sw) != (h, w) else pixels
                    canvases.append(
                        np.pad(scaled, ((0, bucket - sh), (0, bucket - sw), (0, 0)), mode="edge")
                        if (sh, sw) != (bucket, bucket)
                        else scaled
                    )
                    valids.append((sh, sw))
                    jpegs.append(fmt == "jpeg")

                fused, scores, engine_meta = self.engine.fuse_batch(
                    np.stack(canvases), np.asarray(valids, np.int32),
                    np.asarray(jpegs, np.float32), family,
                )
                per_image = [{k: float(v) for k, v in zip(DEGRADATION_ORDER, s)} for s in scores]
                mean_scores = {
                    k: float(np.mean([p[k] for p in per_image])) for k in DEGRADATION_ORDER
                }
                timings["classify_ms"] = round((time.perf_counter() - t) * 1000, 3)

                t = time.perf_counter()
                enhanced_prompt = self.prompt_enhancer.enhance(mean_scores, user_prompt, options)
                timings["prompt_ms"] = round((time.perf_counter() - t) * 1000, 3)

                t = time.perf_counter()
                sh, sw = valids[0]
                restored = fused[:sh, :sw]
                if (sh, sw) != ref_pixels.shape[:2]:
                    restored = imageio.resize_rgb8(restored, ref_pixels.shape[:2])
                timings["restore_ms"] = round((time.perf_counter() - t) * 1000, 3)
                timings["total_ms"] = round((time.perf_counter() - start) * 1000, 3)

                device_s = engine_meta.get("deviceSeconds", 0.0)
                span.set_attributes({"restoration.success": True})
                return {
                    "success": True,
                    "restoredImage": base64.b64encode(
                        imageio.encode_jpeg(restored, quality=85)
                    ).decode("ascii"),
                    "degradationAnalysis": mean_scores,
                    "enhancedPrompt": enhanced_prompt,
                    "timings": timings,
                    "metadata": {
                        "providerRequestId": engine_meta.get("engineRequestId"),
                        "estimatedCostUsd": round(self._cost_usd(device_s), 8),
                        "billedTokens": None,
                        "deviceSeconds": device_s,
                        "fetchSeconds": engine_meta.get("fetchSeconds"),
                        "model": family,
                        "fusionInputs": len(images),
                        "perImageAnalysis": per_image,
                        "sizeBucket": bucket,
                        "processingTime": timings["total_ms"],
                        "classificationIssues": [
                            {"type": k, "confidence": v} for k, v in mean_scores.items() if v > 0.3
                        ],
                    },
                }
            except Exception as error:
                timings["total_ms"] = round((time.perf_counter() - start) * 1000, 3)
                span.record_exception(error)
                span.set_status("ERROR", str(error))
                return {
                    "success": False,
                    "error": {
                        "message": str(error),
                        "code": "FUSION_FAILED",
                        "type": _classify_error(error),
                    },
                    "timings": timings,
                    "metadata": {
                        "processingTime": timings["total_ms"],
                        "failureStage": _failure_stage(timings),
                    },
                }

    def restore_batch(
        self,
        images: list,
        user_prompt: str | None = None,
        user_context: dict | None = None,
        options: dict | None = None,
    ) -> list[dict]:
        """Bounded-concurrency batch fan-out: every image goes through
        restore() on a thread pool of ``batch_concurrency`` workers. One bad
        image fails only its own slot, never the batch."""
        options = options or {}
        with self._tracer.span("restorator.restoreBatch", {"restoration.batch_size": len(images)}):
            delay_ms = self.config.batch_delay_ms

            def run(idx_image):
                index, image = idx_image
                if delay_ms > 0 and index > 0:
                    time.sleep(delay_ms / 1000.0)
                return self.restore(
                    image,
                    user_prompt,
                    user_context,
                    {**options, "batchIndex": index, "batchSize": len(images)},
                )

            with ThreadPoolExecutor(max_workers=self.config.batch_concurrency) as pool:
                return list(pool.map(run, enumerate(images)))

    def get_health_status(self) -> dict:
        try:
            probe = np.full((32, 32, 3), 128, dtype=np.uint8)
            self.classifier.analyze_array(probe, "png")
            classifier_healthy = True
        except Exception:
            classifier_healthy = False
        return {
            "healthy": classifier_healthy,
            "services": {
                "classifier": classifier_healthy,
                "promptEnhancer": True,
                "engine": True,
            },
            "timestamp": time.time(),
        }


def create_restorator_service(**kwargs) -> RestoratorService:
    return RestoratorService(**kwargs)
