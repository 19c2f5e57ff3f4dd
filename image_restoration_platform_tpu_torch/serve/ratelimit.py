"""Token-bucket rate limiting per user and per IP.

Contract from the reference (middleware/rateLimit.js:63-127): check the
``user:<id>`` bucket (default 120/60s) then ``ip:<addr>`` (default 100/60s);
on rejection set RateLimit-Limit/-Remaining/-Reset and Retry-After headers and
return a 429 problem; on success expose the tightest bucket's headers.
"""

from __future__ import annotations

import math
import time

from ..config import RateLimitConfig
from ..problem import Problem, too_many_requests
from .store import MemoryStore


class RateLimiter:
    def __init__(self, store: MemoryStore, config: RateLimitConfig | None = None):
        self.store = store
        self.config = config or RateLimitConfig()

    def check(self, user_id: str | None, ip: str | None) -> tuple[dict[str, str], Problem | None]:
        """Returns (headers, problem). ``problem`` is None when allowed."""
        configs = []
        if user_id:
            configs.append(
                (
                    f"user:{user_id}",
                    self.config.user_limit,
                    self.config.user_interval_s,
                    "User rate limit exceeded.",
                )
            )
        if ip:
            configs.append(
                (
                    f"ip:{ip}",
                    self.config.ip_limit,
                    self.config.ip_interval_s,
                    f"IP rate limit exceeded for {ip}.",
                )
            )

        tightest: dict[str, str] | None = None
        for key, limit, interval, detail in configs:
            result = self.store.take(key, limit, interval)
            reset_s = max(0, math.ceil((result.reset_ms / 1000.0) - time.time()))
            headers = {
                "RateLimit-Limit": str(limit),
                "RateLimit-Remaining": str(max(0, result.remaining)),
                "RateLimit-Reset": str(reset_s),
            }
            if tightest is None or int(headers["RateLimit-Remaining"]) < int(
                tightest["RateLimit-Remaining"]
            ):
                tightest = headers
            if not result.allowed:
                retry_after = max(1, reset_s)
                headers["Retry-After"] = str(retry_after)
                return headers, too_many_requests(detail, retry_after)
        return tightest or {}, None
