"""Serving layer of the port: engine, micro-batcher, restorator, and the host
services of the HTTP API (store, rate limit, idempotency, credits, jobs and
queue, durable tier, blobs, moderation)."""

from .batcher import MicroBatcher
from .credits import CreditsService, DurableUserStore, Ledger
from .durable import SqliteJobStore, SqliteLedger, SqliteUserStore, create_durable_tier, create_job_store
from .engine import RestorationEngine, resolve_device
from .idempotency import IdempotencyService, payload_hash
from .jobs import Job, JobState, JobStore
from .moderation import ModerationAuditLog, ModerationService
from .queue import JobQueue
from .ratelimit import RateLimiter
from .redis_store import RedisStore
from .restorator import RestoratorService
from .store import MemoryStore, create_store

__all__ = [
    "CreditsService",
    "DurableUserStore",
    "IdempotencyService",
    "Job",
    "JobQueue",
    "JobState",
    "JobStore",
    "Ledger",
    "MemoryStore",
    "MicroBatcher",
    "ModerationAuditLog",
    "ModerationService",
    "RateLimiter",
    "RedisStore",
    "RestorationEngine",
    "RestoratorService",
    "SqliteJobStore",
    "SqliteLedger",
    "SqliteUserStore",
    "create_durable_tier",
    "create_job_store",
    "create_store",
    "payload_hash",
    "resolve_device",
]
