"""Content moderation with fail-closed semantics.

Contract from the reference (services/moderation.js): SafeSearch-style flags
{adult, violence, racy, spoof, medical} with likelihoods UNKNOWN..VERY_LIKELY;
reject when adult/violence/racy is LIKELY or VERY_LIKELY (:12-16, 229-248);
on any service error the content is rejected as a precaution (fail-closed,
:125-147); without a vision backend a deterministic mock keyed on
``len(image) % 100`` produces 85% pass / 10% flagged / 5% reject (:184-224);
every decision is audited (:259-287).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..obs.tracing import get_tracer
from ..utils.logging import get_logger

REJECTION_THRESHOLDS = {
    "adult": ("LIKELY", "VERY_LIKELY"),
    "violence": ("LIKELY", "VERY_LIKELY"),
    "racy": ("LIKELY", "VERY_LIKELY"),
}

LIKELIHOOD_SCORES = {
    "UNKNOWN": 0,
    "VERY_UNLIKELY": 1,
    "UNLIKELY": 2,
    "POSSIBLE": 3,
    "LIKELY": 4,
    "VERY_LIKELY": 5,
}


class ModerationAuditLog:
    """moderation_logs audit sink (in-memory durable tier)."""

    def __init__(self, maxlen: int = 10000):
        self._entries: list[dict] = []
        self._lock = threading.Lock()
        self._maxlen = maxlen

    def add(self, entry: dict) -> None:
        with self._lock:
            self._entries.append(dict(entry))
            if len(self._entries) > self._maxlen:
                self._entries = self._entries[-self._maxlen :]

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]


class ModerationService:
    def __init__(
        self,
        vision_client: Callable[[bytes], dict] | None = None,
        audit_log: ModerationAuditLog | None = None,
        logger=None,
    ):
        self.vision_client = vision_client
        self.audit = audit_log or ModerationAuditLog()
        self.logger = logger or get_logger("moderation")
        self._tracer = get_tracer("moderation")
        self.use_mock = vision_client is None
        if self.use_mock:
            self.logger.warn_once(
                "mock", "Using mock moderation - vision backend not configured"
            )

    def moderate(self, image_bytes: bytes, context: dict | None = None) -> dict:
        context = context or {}
        with self._tracer.span(
            "moderation.moderate",
            {
                "moderation.user_id": context.get("userId", "anonymous"),
                "moderation.image_size_bytes": len(image_bytes),
                "moderation.use_mock": self.use_mock,
            },
        ) as span:
            try:
                if self.use_mock:
                    flags = self._mock_flags(image_bytes)
                else:
                    flags = self.vision_client(image_bytes)
                rejection = self._evaluate_rejection(flags)
                result = {
                    "allowed": not rejection["rejected"],
                    "flags": flags,
                    "rejection": (
                        {"reason": rejection["reason"], "categories": rejection["categories"]}
                        if rejection["rejected"]
                        else None
                    ),
                    "confidence": self._overall_confidence(flags),
                    "timestamp": time.time(),
                }
                span.set_attributes(
                    {
                        "moderation.allowed": result["allowed"],
                        "moderation.rejection_reason": rejection.get("reason") or "none",
                    }
                )
                self._record_audit(result, context)
                return result
            except Exception as error:
                span.record_exception(error)
                span.set_status("ERROR", str(error))
                self.logger.error("Moderation failed", {"error": str(error)})
                # fail-closed: reject on service failure (moderation.js:125-147)
                failure = {
                    "allowed": False,
                    "flags": {k: "UNKNOWN" for k in ("adult", "violence", "racy", "spoof", "medical")},
                    "rejection": {
                        "reason": "Moderation service unavailable. Content rejected as a precaution.",
                        "categories": ["moderation-service-error"],
                    },
                    "error": {"message": str(error), "code": "MODERATION_SERVICE_ERROR"},
                    "confidence": 1,
                    "timestamp": time.time(),
                }
                self._record_audit(failure, context)
                return failure

    def _mock_flags(self, image_bytes: bytes) -> dict:
        seed = len(image_bytes) % 100
        if seed < 85:
            return {
                "adult": "VERY_UNLIKELY",
                "violence": "UNLIKELY",
                "racy": "UNLIKELY",
                "spoof": "POSSIBLE",
                "medical": "UNLIKELY",
            }
        if seed < 95:
            return {
                "adult": "POSSIBLE",
                "violence": "UNLIKELY",
                "racy": "POSSIBLE",
                "spoof": "LIKELY",
                "medical": "UNLIKELY",
            }
        return {
            "adult": "LIKELY",
            "violence": "POSSIBLE",
            "racy": "VERY_LIKELY",
            "spoof": "POSSIBLE",
            "medical": "UNLIKELY",
        }

    def _evaluate_rejection(self, flags: dict) -> dict:
        rejected = [
            category
            for category, thresholds in REJECTION_THRESHOLDS.items()
            if flags.get(category) in thresholds
        ]
        if rejected:
            return {
                "rejected": True,
                "reason": "Content violates community guidelines",
                "categories": rejected,
            }
        return {"rejected": False, "reason": None, "categories": []}

    def _overall_confidence(self, flags: dict) -> float:
        scores = [LIKELIHOOD_SCORES.get(v, 0) for v in flags.values()]
        return (max(scores) if scores else 0) / 5.0

    def _record_audit(self, result: dict, context: dict) -> None:
        try:
            self.audit.add(
                {
                    "userId": context.get("userId"),
                    "jobId": context.get("jobId"),
                    "requestId": context.get("requestId"),
                    "allowed": result["allowed"],
                    "flags": result["flags"],
                    "rejection": result.get("rejection"),
                    "error": result.get("error"),
                    "confidence": result["confidence"],
                    "timestamp": result["timestamp"],
                }
            )
        except Exception as error:  # pragma: no cover - audit must not block
            self.logger.error("Failed to persist moderation audit", {"error": str(error)})

    @staticmethod
    def get_moderation_policy() -> dict:
        return {
            "description": "SafeSearch-style content moderation",
            "rejectionThresholds": {k: list(v) for k, v in REJECTION_THRESHOLDS.items()},
            "categories": {
                "adult": "Adult content detection",
                "violence": "Violence and graphic content detection",
                "racy": "Racy or suggestive content detection",
                "spoof": "Spoof or fake content detection (logged but not rejected)",
                "medical": "Medical content detection (logged but not rejected)",
            },
            "likelihoodLevels": list(LIKELIHOOD_SCORES),
            "failureMode": "Reject content if moderation service fails (fail-closed)",
        }


def create_moderation_service(**kwargs: Any) -> ModerationService:
    return ModerationService(**kwargs)
