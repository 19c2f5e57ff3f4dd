"""Generic exponential backoff with multiplicative jitter.

Semantics follow the reference's retry util (server-node/src/utils/retry.js:12-47)
and the queue's jittered backoff (queues/jobQueue.js:37-45): delay grows by a
multiplier per attempt and is perturbed by +/- ``jitter`` fraction.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Awaitable, Callable, TypeVar

T = TypeVar("T")


def backoff_delay_ms(
    attempt: int,
    *,
    base_ms: float = 500.0,
    multiplier: float = 2.0,
    jitter: float = 0.3,
    max_ms: float | None = None,
    rng: random.Random | None = None,
) -> float:
    """Delay before retry number ``attempt`` (1-based), jittered +/- ``jitter``."""
    rng = rng or random
    delay = base_ms * (multiplier ** (attempt - 1))
    if max_ms is not None:
        delay = min(delay, max_ms)
    spread = delay * jitter
    return max(0.0, delay + rng.uniform(-spread, spread))


def exponential_backoff(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_ms: float = 500.0,
    multiplier: float = 2.0,
    jitter: float = 0.3,
    retryable: Callable[[Exception], bool] | None = None,
    on_retry: Callable[[int, Exception, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    last_error: Exception | None = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as error:  # noqa: BLE001 - retry wrapper must be generic
            last_error = error
            if attempt >= attempts or (retryable is not None and not retryable(error)):
                raise
            delay_ms = backoff_delay_ms(
                attempt, base_ms=base_ms, multiplier=multiplier, jitter=jitter
            )
            if on_retry is not None:
                on_retry(attempt, error, delay_ms)
            sleep(delay_ms / 1000.0)
    raise last_error  # pragma: no cover - unreachable


async def exponential_backoff_async(
    fn: Callable[[], Awaitable[T]],
    *,
    attempts: int = 3,
    base_ms: float = 500.0,
    multiplier: float = 2.0,
    jitter: float = 0.3,
    retryable: Callable[[Exception], bool] | None = None,
    on_retry: Callable[[int, Exception, float], None] | None = None,
) -> T:
    last_error: Exception | None = None
    for attempt in range(1, attempts + 1):
        try:
            return await fn()
        except Exception as error:  # noqa: BLE001
            last_error = error
            if attempt >= attempts or (retryable is not None and not retryable(error)):
                raise
            delay_ms = backoff_delay_ms(
                attempt, base_ms=base_ms, multiplier=multiplier, jitter=jitter
            )
            if on_retry is not None:
                on_retry(attempt, error, delay_ms)
            await asyncio.sleep(delay_ms / 1000.0)
    raise last_error  # pragma: no cover
