"""RFC 7807 application/problem+json errors.

Behavioral contract from the reference (server-node/src/utils/problem.js:5-73):
every error surface is a Problem document with type/title/status/detail/instance
plus arbitrary extras, ``X-Request-Id`` echoed, and ``Cache-Control: no-store``.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any

DEFAULT_TYPE = "about:blank"
PROBLEM_CONTENT_TYPE = "application/problem+json"

# problem type URIs mirror the reference's docs.image-restoration.ai namespace
_DOCS = "https://docs.image-restoration.ai/problem"


@dataclass
class Problem(Exception):
    title: str = "Error"
    status: int = 500
    type: str = DEFAULT_TYPE
    detail: str | None = None
    instance: str | None = None
    extras: dict[str, Any] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        super().__init__(self.detail or self.title)

    def to_body(self, request_id: str | None = None) -> dict[str, Any]:
        instance = self.instance or request_id or str(uuid.uuid4())
        body: dict[str, Any] = {
            "type": self.type or DEFAULT_TYPE,
            "title": self.title,
            "status": self.status,
            "instance": instance,
        }
        if self.detail is not None:
            body["detail"] = self.detail
        body.update(self.extras)
        return body


def create_problem(**kwargs: Any) -> Problem:
    return Problem(**kwargs)


def is_problem(value: Any) -> bool:
    return isinstance(value, Problem)


# ---- canonical problem constructors used across middleware/services -----

def idempotency_key_missing() -> Problem:
    return Problem(
        type=f"{_DOCS}/idempotency-key-missing",
        title="Idempotency Key Required",
        status=400,
        detail="The Idempotency-Key header is required for this endpoint.",
    )


def idempotency_key_invalid() -> Problem:
    return Problem(
        type=f"{_DOCS}/idempotency-key-invalid",
        title="Invalid Idempotency Key",
        status=400,
        detail="The Idempotency-Key header must be a valid token.",
    )


def idempotency_conflict() -> Problem:
    return Problem(
        type=f"{_DOCS}/idempotency-conflict",
        title="Idempotency Conflict",
        status=409,
        detail="A request with the same Idempotency-Key but different payload already exists.",
    )


def too_many_requests(detail: str, retry_after: int) -> Problem:
    return Problem(
        type="https://httpstatuses.com/429",
        title="Too Many Requests",
        status=429,
        detail=detail,
        extras={"retryAfter": retry_after},
        headers={"Retry-After": str(retry_after)},
    )


def bad_request(detail: str = "Invalid request.") -> Problem:
    return Problem(
        type=f"{_DOCS}/bad-request",
        title="Bad Request",
        status=400,
        detail=detail,
    )


def image_missing() -> Problem:
    return Problem(
        type=f"{_DOCS}/image-missing",
        title="Image File Required",
        status=400,
        detail="An image file must be provided in the request.",
    )


def unsupported_extension() -> Problem:
    return Problem(
        type=f"{_DOCS}/unsupported-file-extension",
        title="Unsupported File Extension",
        status=415,
        detail="Only .jpg, .jpeg, .png, or .webp files are allowed.",
    )


def unsupported_media_type() -> Problem:
    return Problem(
        type=f"{_DOCS}/unsupported-media-type",
        title="Unsupported Media Type",
        status=415,
        detail="Only JPEG, PNG, or WebP images are supported.",
    )


def file_too_large(max_mb: int, retry_after: int = 60) -> Problem:
    return Problem(
        type=f"{_DOCS}/file-too-large",
        title="File Too Large",
        status=413,
        detail=f"The uploaded file exceeds the maximum allowed size of {max_mb} MB.",
        headers={"Retry-After": str(retry_after)},
    )


def upload_failed(detail: str | None = None) -> Problem:
    return Problem(
        type=f"{_DOCS}/upload-failed",
        title="Upload Failed",
        status=400,
        detail=detail or "Unable to process the uploaded file.",
    )


def upload_validation_failed(detail: str | None = None) -> Problem:
    return Problem(
        type=f"{_DOCS}/upload-validation-failed",
        title="Upload Validation Failed",
        status=400,
        detail=detail or "Unable to validate the uploaded image.",
    )


def preprocess_failed(detail: str | None = None) -> Problem:
    return Problem(
        type=f"{_DOCS}/preprocess-failed",
        title="Image Preprocessing Failed",
        status=422,
        detail=detail or "Unable to preprocess the uploaded image.",
    )


def content_rejected(reason: str, categories: list[str], flags: dict[str, str]) -> Problem:
    return Problem(
        type=f"{_DOCS}/content-rejected",
        title="Content Rejected",
        status=422,
        detail=reason,
        extras={"categories": categories, "flags": flags},
    )


def insufficient_credits(remaining: int) -> Problem:
    return Problem(
        type=f"{_DOCS}/insufficient-credits",
        title="Insufficient Credits",
        status=402,
        detail="Not enough credits to run this job.",
        extras={"remainingCredits": remaining},
    )


def unauthorized(detail: str = "Authentication required.") -> Problem:
    return Problem(
        type=f"{_DOCS}/unauthorized",
        title="Unauthorized",
        status=401,
        detail=detail,
    )


def forbidden(detail: str = "You do not have access to this resource.") -> Problem:
    return Problem(
        type=f"{_DOCS}/forbidden",
        title="Forbidden",
        status=403,
        detail=detail,
    )


def not_found(detail: str = "The requested resource was not found.") -> Problem:
    return Problem(
        type=f"{_DOCS}/not-found",
        title="Not Found",
        status=404,
        detail=detail,
    )


def internal_error() -> Problem:
    return Problem(
        title="Internal Server Error",
        status=500,
        detail="An unexpected error occurred.",
    )


def service_unavailable(detail: str = "Service temporarily unavailable.") -> Problem:
    return Problem(
        type=f"{_DOCS}/service-unavailable",
        title="Service Unavailable",
        status=503,
        detail=detail,
    )
