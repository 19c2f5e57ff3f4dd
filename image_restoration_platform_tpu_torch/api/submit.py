"""The work of a job submission, without the HTTP layer.

``POST /v1/jobs`` (api/routes.py) parses its multipart form and hands the
uploads to ``submit_job``, which validates them (extension allowlist and
magic sniff), preprocesses each one (EXIF auto-orient, downscale of the
longest side to ``UploadConfig.max_dimension`` with ``resize_u8`` on the
service's device, JPEG q85 4:4:4 re-encode with an sRGB ICC profile), runs
the moderation gate, creates the job, charges one credit, and then either
processes it at once (``sync``) or enqueues it. It raises the same RFC 7807
problems, in the same order, as image_restoration_platform_tpu/api/routes.py,
and imports no aiohttp, so the submission path runs where the HTTP layer
cannot. A submission is the trace of its ``submit.job`` span (with the job's
id), whose children are ``submit.validate``, ``submit.preprocess``, the
moderation, ``submit.record`` (the job and its credit) and, when ``sync``,
``job.process``.
"""

from __future__ import annotations

import base64
import os

import numpy as np
import torch

from .. import imageio
from ..obs.tracing import get_tracer
from ..ops.resize import fit_inside, resize_u8
from ..problem import (
    content_rejected,
    file_too_large,
    image_missing,
    insufficient_credits,
    preprocess_failed,
    unsupported_extension,
    unsupported_media_type,
)
from ..serve.jobs import JobState
from .context import AppContext

MAX_IMAGES_PER_CALL = 3
_tracer = get_tracer("submit")


def validate_upload(filename: str, data: bytes, ctx: AppContext) -> str:
    """Extension allowlist + magic sniff; returns the sniffed format."""
    ext = os.path.splitext(filename or "")[1].lower()
    if ext not in ctx.config.upload.accepted_extensions:
        raise unsupported_extension()
    fmt = imageio.sniff_format(data)
    if fmt is None or f"image/{fmt}" not in ctx.config.upload.accepted_mimes:
        raise unsupported_media_type()
    return fmt


def preprocess(data: bytes, ctx: AppContext) -> tuple[np.ndarray, bytes, list[str]]:
    """EXIF auto-orient -> downscale longest side <= max_dimension (on the
    device) -> JPEG q85 4:4:4 sRGB re-encode; returns (pixels, jpeg, the
    operations applied)."""
    operations = []
    try:
        decoded = imageio.decode_image(data)  # auto-orients
        operations.append("auto_orient")
        pixels = decoded.pixels
        max_dim = ctx.config.upload.max_dimension
        if max(pixels.shape[:2]) > max_dim:
            w, h = fit_inside(pixels.shape[1], pixels.shape[0], max_dim)
            pixels = resize_u8(pixels, (h, w), device=ctx.device).to(torch.uint8).cpu().numpy()
            operations.append(f"resize_{w}x{h}")
        jpeg = imageio.encode_jpeg(
            pixels, quality=ctx.config.upload.jpeg_quality, chroma_444=True, attach_srgb_icc=True
        )
        operations.append(f"compress_jpeg_q{ctx.config.upload.jpeg_quality}")
        operations.append("attach_sRGB_icc")
        return pixels, jpeg, operations
    except ValueError as error:
        raise preprocess_failed(str(error))


def moderate(ctx: AppContext, jpeg: bytes, context: dict) -> None:
    """The fail-closed moderation gate: 422 on rejection."""
    moderation = ctx.moderation.moderate(jpeg, context)
    if not moderation["allowed"]:
        raise content_rejected(
            moderation["rejection"]["reason"],
            moderation["rejection"]["categories"],
            moderation["flags"],
        )


def submit_job(
    ctx: AppContext,
    user: dict,
    images: list[tuple[str, bytes]],
    prompt: str | None = None,
    options: dict | None = None,
    request_id: str | None = None,
    traceparent: str | None = None,
    sync: bool = False,
) -> tuple[int, dict, dict]:
    """Submit one job of 1-3 uploads ``(filename, bytes)`` for ``user``.
    Returns (HTTP status, JSON body, headers): 200 or 502 with the finished
    job when ``sync``, else 202 with a Location header; raises a Problem."""
    with _tracer.span("submit.job", {"submit.images": len(images), "submit.sync": sync,
                                     **({"job.traceparent": traceparent} if traceparent else {})}) as span:
        if not images:
            raise image_missing()
        if len(images) > MAX_IMAGES_PER_CALL:
            raise preprocess_failed(f"At most {MAX_IMAGES_PER_CALL} images per call.")

        preprocessed: list[bytes] = []
        all_operations: list[list[str]] = []
        for filename, data in images:
            with _tracer.span("submit.validate"):
                if len(data) > ctx.config.upload.max_file_size_bytes:
                    raise file_too_large(ctx.config.upload.max_file_size_bytes // (1024 * 1024))
                validate_upload(filename, data, ctx)
            with _tracer.span("submit.preprocess"):
                _, jpeg, operations = preprocess(data, ctx)
            preprocessed.append(jpeg)
            all_operations.append(operations)

        for jpeg in preprocessed:
            moderate(ctx, jpeg, {"userId": user["id"], "requestId": request_id})

        # create the job first so the ledger entry carries its id, then bill
        with _tracer.span("submit.record"):
            payload = {
                "imageB64": base64.b64encode(preprocessed[0]).decode("ascii"),
                "imagesB64": [base64.b64encode(j).decode("ascii") for j in preprocessed],
                "prompt": prompt,
                "options": options or {},
                "preprocessOperations": all_operations,
            }
            job = ctx.jobs.create(user["id"], payload, request_id=request_id, traceparent=traceparent)
            span.set_attribute("job.id", job.id)
            decision = ctx.credits.check_and_deduct(user["id"], 1, job.id)
            if not decision["allowed"]:
                ctx.jobs.transition(job.id, JobState.DEAD_LETTER, error={"message": "insufficient credits"})
                raise insufficient_credits(decision.get("remainingCredits", 0))

        if sync:
            ctx.jobs.transition(job.id, JobState.RUNNING, attempts=1)
            result = ctx._process_job(job)
            if result.get("success"):
                ctx.jobs.transition(job.id, JobState.SUCCEEDED, result=result, timings=result.get("timings", {}))
            else:
                ctx.jobs.transition(job.id, JobState.FAILED, error=result.get("error"))
                ctx.credits.refund(user["id"], job.id, 1, "Synchronous job failed")
            body = ctx.jobs.get(job.id).to_public()
            body["credits"] = decision
            return (200 if result.get("success") else 502), body, {}

        ctx.queue.enqueue(job)
        body = {"id": job.id, "status": job.state.value, "createdAt": job.created_at, "credits": decision}
        return 202, body, {"Location": f"/v1/jobs/{job.id}"}
