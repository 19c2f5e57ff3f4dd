"""Job store and lifecycle state machine.

Implements the async job model the reference specified but never shipped
(design.md:912-933 via SURVEY.md sections 3.5, 1): states
``queued -> running -> {succeeded | failed}`` with retries re-entering
``queued`` and exhausted jobs parked in ``dead_letter`` (DLQ) until replayed.
Every transition is timestamped; watchers (SSE streams, pollers) observe a
monotonically increasing version.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum


class JobState(str, Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DEAD_LETTER = "dead_letter"


_TRANSITIONS = {
    JobState.QUEUED: {JobState.RUNNING, JobState.DEAD_LETTER},
    JobState.RUNNING: {JobState.SUCCEEDED, JobState.FAILED, JobState.QUEUED, JobState.DEAD_LETTER},
    JobState.FAILED: {JobState.QUEUED},       # retry re-entry
    JobState.DEAD_LETTER: {JobState.QUEUED},  # replay
    JobState.SUCCEEDED: set(),
}


@dataclass
class Job:
    id: str
    user_id: str
    state: JobState = JobState.QUEUED
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    attempts: int = 0
    version: int = 0
    payload: dict = field(default_factory=dict)     # prompt/options; image held separately
    result: dict | None = None
    error: dict | None = None
    timings: dict = field(default_factory=dict)
    traceparent: str | None = None
    request_id: str | None = None

    def to_public(self, include_result: bool = True) -> dict:
        """Response shape for GET /v1/jobs/{id} (design.md:208-240 schema)."""
        doc = {
            "id": self.id,
            "status": self.state.value,
            "createdAt": self.created_at,
            "updatedAt": self.updated_at,
            "attempts": self.attempts,
        }
        if self.timings:
            doc["timings"] = dict(self.timings)
        if self.error:
            doc["error"] = dict(self.error)
        if include_result and self.result is not None:
            doc["result"] = self.result
        return doc


class JobStore:
    """In-memory durable-tier analog of the reference's Firestore job records,
    with the spec'd retention policy (jobQueue.js keep 100 completed / 500
    failed)."""

    def __init__(self, keep_completed: int = 100, keep_failed: int = 500,
                 result_retention_s: float | None = None, clock=time.time):
        self._jobs: dict[str, Job] = {}
        self._order: list[str] = []
        self._lock = threading.Condition()
        self._keep_completed = keep_completed
        self._keep_failed = keep_failed
        # result-retention lifecycle, the GCS 30-day restored-object rule
        # (gcsClient.js:26-42): restored image payloads are dropped after the
        # TTL while job metadata stays queryable
        if result_retention_s is None:
            import os

            result_retention_s = float(
                os.environ.get("JOBS_RESULT_RETENTION_S", 30 * 24 * 3600)
            )
        self._result_retention_s = result_retention_s
        self._clock = clock

    def create(self, user_id: str, payload: dict, request_id: str | None = None,
               traceparent: str | None = None) -> Job:
        now = self._clock()
        job = Job(
            id=str(uuid.uuid4()),
            user_id=user_id,
            payload=payload,
            request_id=request_id,
            traceparent=traceparent,
            created_at=now,
            updated_at=now,
        )
        with self._lock:
            self._jobs[job.id] = job
            self._order.append(job.id)
            self._persist_locked(job)
        return job

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            self._expire_results_locked()
            return self._jobs.get(job_id)

    def transition(self, job_id: str, state: JobState, **updates) -> Job:
        with self._lock:
            job = self._jobs[job_id]
            if state is not job.state and state not in _TRANSITIONS[job.state]:
                raise ValueError(f"illegal transition {job.state.value} -> {state.value}")
            job.state = state
            job.updated_at = self._clock()
            job.version += 1
            for key, value in updates.items():
                setattr(job, key, value)
            self._persist_locked(job)
            self._lock.notify_all()
            self._trim_locked()
            return job

    def wait_for_change(self, job_id: str, seen_version: int, timeout: float = 10.0) -> Job | None:
        """Block until the job's version passes ``seen_version`` (SSE stream)."""
        deadline = time.time() + timeout
        with self._lock:
            while True:
                job = self._jobs.get(job_id)
                if job is None or job.version > seen_version:
                    return job
                remaining = deadline - time.time()
                if remaining <= 0:
                    return job
                self._lock.wait(timeout=remaining)

    def list_for_user(self, user_id: str, limit: int = 50) -> list[Job]:
        with self._lock:
            jobs = [self._jobs[j] for j in reversed(self._order) if self._jobs[j].user_id == user_id]
            return jobs[:limit]

    def dead_letter_jobs(self) -> list[Job]:
        with self._lock:
            return [j for j in self._jobs.values() if j.state is JobState.DEAD_LETTER]

    def purge_expired_results(self) -> int:
        """Drop restored-image payloads past the retention TTL; returns the
        number of purged results. Called lazily from get() and periodically
        by the queue workers."""
        with self._lock:
            return self._expire_results_locked()

    def _expire_results_locked(self) -> int:
        if not self._result_retention_s:
            return 0
        cutoff = self._clock() - self._result_retention_s
        purged = 0
        for job in self._jobs.values():
            if (
                job.state is JobState.SUCCEEDED
                and job.result is not None
                and job.updated_at < cutoff
            ):
                job.result = None
                job.error = {"message": "Result expired per retention policy."}
                job.version += 1
                self._persist_locked(job)
                purged += 1
        if purged:
            self._lock.notify_all()
        return purged

    def _trim_locked(self) -> None:
        completed = [j for j in self._order if self._jobs[j].state is JobState.SUCCEEDED]
        failed = [
            j for j in self._order
            if self._jobs[j].state in (JobState.FAILED, JobState.DEAD_LETTER)
        ]
        drop = []
        if len(completed) > self._keep_completed:
            drop += completed[: len(completed) - self._keep_completed]
        if len(failed) > self._keep_failed:
            drop += failed[: len(failed) - self._keep_failed]
        for job_id in drop:
            self._jobs.pop(job_id, None)
            self._order.remove(job_id)
            self._delete_locked(job_id)

    # --------------------------------------------------- durability hooks
    #
    # No-ops for the in-memory store; SqliteJobStore (serve/durable.py)
    # overrides them to write-through every mutation while keeping all state
    # machine / watcher semantics here. Both are called under self._lock.

    def _persist_locked(self, job: Job) -> None:
        pass

    def _delete_locked(self, job_id: str) -> None:
        pass

    def recover_incomplete(self) -> list[Job]:
        """Crash recovery (design.md:912-933 durable state machine): jobs the
        previous process left mid-flight come back as QUEUED so the composition
        root can re-enqueue them. RUNNING means the worker died mid-attempt —
        the attempt count is preserved so the retry budget still bounds work."""
        with self._lock:
            recovered = []
            for job_id in self._order:
                job = self._jobs[job_id]
                if job.state is JobState.RUNNING:
                    job.state = JobState.QUEUED
                    job.updated_at = self._clock()
                    job.version += 1
                    self._persist_locked(job)
                if job.state is JobState.QUEUED:
                    recovered.append(job)
            if recovered:
                self._lock.notify_all()
            return recovered
