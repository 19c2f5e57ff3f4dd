"""Control-plane KV store abstraction.

The reference keeps all shared mutable state in Redis behind atomic Lua
scripts (redisClient.js:152-177, credits.js:291-366) with a full in-memory
fallback replica (redisClient.js:6-128). Our serving loop is single-controller
(SURVEY.md section 5 "race detection"), so the default store is process-local
with a mutex providing the same atomicity the Lua scripts did; the interface
is kept Redis-shaped so a networked store can back multi-replica deployments.

All TTLs are seconds. Time is injectable for tests.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class TakeResult:
    allowed: bool
    remaining: int
    reset_ms: float  # epoch millis when the bucket refills


class MemoryStore:
    """In-memory store: KV with TTL, token buckets, idempotency records.

    Mirrors the reference's unified store facade (redisClient.js:189-307):
    ``take`` (token bucket), ``get/set/incr/decr/incr_by/expire``, and
    idempotency get/set under an ``idem:`` prefix.
    """

    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.RLock()
        self._kv: dict[str, tuple[Any, float | None]] = {}
        self._buckets: dict[str, tuple[int, float]] = {}  # key -> (remaining, reset_epoch)

    # ---------------------------------------------------------------- kv

    def _now(self) -> float:
        return self._clock()

    def _live(self, key: str) -> bool:
        value = self._kv.get(key)
        if value is None:
            return False
        _, expires = value
        if expires is not None and expires <= self._now():
            del self._kv[key]
            return False
        return True

    def get(self, key: str) -> Any:
        with self._lock:
            return self._kv[key][0] if self._live(key) else None

    def set(self, key: str, value: Any, ttl_seconds: float | None = None) -> None:
        with self._lock:
            expires = self._now() + ttl_seconds if ttl_seconds else None
            self._kv[key] = (value, expires)

    def delete(self, key: str) -> None:
        with self._lock:
            self._kv.pop(key, None)

    def set_if_absent(self, key: str, value: Any, ttl_seconds: float | None = None) -> bool:
        """Atomic SET NX (redis SET key value NX EX ttl). Returns True when the
        key was set, False when it already existed — used for event dedup."""
        with self._lock:
            if self._live(key):
                return False
            self.set(key, value, ttl_seconds)
            return True

    def incr(self, key: str) -> int:
        return self.incr_by(key, 1)

    def decr(self, key: str) -> int:
        return self.incr_by(key, -1)

    def incr_by(self, key: str, amount: int) -> int:
        with self._lock:
            current = int(self.get(key) or 0)
            new = current + amount
            expires = self._kv.get(key, (None, None))[1] if self._live(key) else None
            self._kv[key] = (new, expires)
            return new

    def expire(self, key: str, ttl_seconds: float) -> None:
        with self._lock:
            if self._live(key):
                value, _ = self._kv[key]
                self._kv[key] = (value, self._now() + ttl_seconds)

    # ----------------------------------------- atomic compound operations
    # (the process-local equivalents of the reference's Lua scripts)

    def incr_with_limit(self, key: str, limit: int, ttl_seconds: float) -> int:
        """Atomic GET -> limit check -> INCR -> EXPIRE (credits.js:291-309).
        Returns the new value, or 0 if the limit was already reached."""
        with self._lock:
            current = int(self.get(key) or 0)
            if current >= limit:
                return 0
            new = current + 1
            self._kv[key] = (new, self._now() + ttl_seconds)
            return new

    def check_and_decrement(self, key: str, amount: int, ttl_seconds: float) -> tuple[bool, int]:
        """Atomic balance check-and-decrement (credits.js:346-366).
        Returns (success, new_or_current_balance)."""
        with self._lock:
            current = int(self.get(key) or 0)
            if current < amount:
                return False, current
            new = current - amount
            self._kv[key] = (new, self._now() + ttl_seconds)
            return True, new

    # ------------------------------------------------------ token bucket

    def take(self, key: str, limit: int, interval_seconds: float) -> TakeResult:
        """Fixed-window token bucket (redisClient.js:152-177 semantics)."""
        with self._lock:
            now = self._now()
            bucket = self._buckets.get(key)
            if bucket is None or bucket[1] <= now:
                bucket = (limit, now + interval_seconds)
            remaining, reset = bucket
            if remaining <= 0:
                self._buckets[key] = (0, reset)
                return TakeResult(False, 0, reset * 1000.0)
            self._buckets[key] = (remaining - 1, reset)
            return TakeResult(True, remaining - 1, reset * 1000.0)

    # ------------------------------------------------------- idempotency

    def set_idempotency(self, key: str, record: dict, ttl_seconds: float) -> None:
        self.set(f"idem:{key}", record, ttl_seconds)

    def get_idempotency(self, key: str) -> dict | None:
        return self.get(f"idem:{key}")

    # ------------------------------------------------------------ health

    def ping(self) -> bool:
        return True

    def get_mode(self) -> str:
        return "memory"

    def is_fallback(self) -> bool:
        return False


def create_store():
    """Store factory: REDIS_URL selects the networked Redis backend (with the
    runtime memory-fallback flip); otherwise the in-memory store is
    authoritative (single-controller mode)."""
    import os

    url = os.environ.get("REDIS_URL")
    if url:
        from .redis_store import RedisStore

        store = RedisStore(url)
        if not store.ping():
            # stays usable via its internal fallback; readiness reports the flip
            pass
        return store
    return MemoryStore()
