"""Idempotency-key request replay.

Contract from the reference (middleware/idempotency.js:50-140): POSTs require
a UUID ``Idempotency-Key``; the payload fingerprint is sha256(method + url +
body); a cached entry with a different fingerprint is a 409 conflict; cached
2xx-4xx responses replay verbatim (status/headers/body) for 24h.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass

from ..problem import (
    Problem,
    idempotency_conflict,
    idempotency_key_invalid,
    idempotency_key_missing,
)
from .store import MemoryStore

DEFAULT_TTL_SECONDS = 24 * 60 * 60
_UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$", re.IGNORECASE
)


@dataclass
class CachedResponse:
    status: int
    headers: dict[str, str]
    body: bytes
    content_type: str


def payload_hash(method: str, url: str, body: bytes | None) -> str:
    h = hashlib.sha256()
    h.update(method.encode())
    h.update(url.encode())
    if body:
        h.update(body)
    return h.hexdigest()


class IdempotencyService:
    def __init__(self, store: MemoryStore, ttl_seconds: float = DEFAULT_TTL_SECONDS):
        self.store = store
        self.ttl = ttl_seconds

    def validate_key(self, key: str | None) -> Problem | None:
        if not key:
            return idempotency_key_missing()
        if not _UUID_RE.match(key):
            return idempotency_key_invalid()
        return None

    def lookup(self, key: str, fingerprint: str) -> tuple[CachedResponse | None, Problem | None]:
        """(cached_response, problem): replay hit, conflict, or fresh (None, None)."""
        cached = self.store.get_idempotency(key)
        if cached is None:
            return None, None
        if cached["payloadHash"] != fingerprint:
            return None, idempotency_conflict()
        r = cached["response"]
        return (
            CachedResponse(
                status=r["status"],
                headers=dict(r["headers"]),
                body=r["body"],
                content_type=r.get("contentType", "application/json"),
            ),
            None,
        )

    def record(
        self,
        key: str,
        fingerprint: str,
        status: int,
        headers: dict[str, str],
        body: bytes,
        content_type: str,
    ) -> None:
        """Cache 2xx-4xx responses; 5xx must stay retryable (idempotency.js:121)."""
        if not (200 <= status < 500):
            return
        headers = {k: v for k, v in headers.items() if k.lower() != "content-length"}
        self.store.set_idempotency(
            key,
            {
                "payloadHash": fingerprint,
                "response": {
                    "status": status,
                    "headers": headers,
                    "body": body,
                    "contentType": content_type,
                },
            },
            self.ttl,
        )
