"""Job queue with jittered retries, DLQ, refund-on-exhaustion, and replay.

The reference enqueues to BullMQ over Redis with 5 attempts of +/-30%-jittered
exponential backoff and DLQ + replay specified but unimplemented
(queues/jobQueue.js:37-75, design.md:855-906). Here the queue is an in-process
scheduler feeding worker threads (the restoration work itself is batched on
the device by serve/batcher.py, so workers mostly wait on futures); the DLQ
hook triggers the credit refund compensation path the spec mandates.

Trace context (traceparent) recorded at submit time is reattached in the
worker, mirroring design.md:819-837.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable

from ..config import QueueConfig
from ..obs.metrics import get_counters
from ..utils.logging import get_logger
from ..utils.retry import backoff_delay_ms
from .jobs import Job, JobState, JobStore


class JobQueue:
    def __init__(
        self,
        store: JobStore,
        handler: Callable[[Job], dict],
        config: QueueConfig | None = None,
        workers: int = 2,
        on_exhausted: Callable[[Job], None] | None = None,
    ):
        self.store = store
        self.handler = handler
        self.config = config or QueueConfig()
        self.on_exhausted = on_exhausted
        self.logger = get_logger("job-queue")
        self._heap: list[tuple[float, int, str]] = []  # (ready_time, seq, job_id)
        self._seq = 0
        self._cv = threading.Condition()
        self._running = True
        self._threads = [
            threading.Thread(target=self._worker_loop, daemon=True, name=f"job-worker-{i}")
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # -------------------------------------------------------------- public

    def enqueue(self, job: Job, delay_s: float = 0.0) -> None:
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, (time.time() + delay_s, self._seq, job.id))
            get_counters().gauge("queue_depth", len(self._heap))
            self._cv.notify()

    def replay_dead_letter(self, job_id: str) -> Job:
        """DLQ replay preserving the job id (design.md:887-906)."""
        job = self.store.get(job_id)
        if job is None or job.state is not JobState.DEAD_LETTER:
            raise ValueError(f"job {job_id} is not in the dead-letter queue")
        job = self.store.transition(job_id, JobState.QUEUED, attempts=0, error=None)
        self.enqueue(job)
        return job

    def depth(self) -> int:
        with self._cv:
            return len(self._heap)

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout / max(1, len(self._threads)))

    # -------------------------------------------------------------- worker

    def _next_job_id(self) -> str | None:
        with self._cv:
            while self._running:
                if self._heap and self._heap[0][0] <= time.time():
                    _, _, job_id = heapq.heappop(self._heap)
                    get_counters().gauge("queue_depth", len(self._heap))
                    return job_id
                wait = 0.5
                if self._heap:
                    wait = max(0.01, min(wait, self._heap[0][0] - time.time()))
                self._cv.wait(timeout=wait)
            return None

    def _worker_loop(self) -> None:
        while True:
            job_id = self._next_job_id()
            if job_id is None:
                return
            job = self.store.get(job_id)
            if job is None:
                continue
            try:
                job = self.store.transition(job.id, JobState.RUNNING, attempts=job.attempts + 1)
            except ValueError:
                continue  # raced with an external transition
            try:
                # re-attach the submit-time W3C trace context in the worker
                # (design.md:819-837: traceparent flows through the queue)
                from ..obs.tracing import get_tracer

                with get_tracer("job-worker").span(
                    "queue.attempt",
                    {
                        "job.id": job.id,
                        "job.attempt": job.attempts,
                        "job.traceparent": job.traceparent or "",
                        "job.request_id": job.request_id or "",
                    },
                ):
                    result = self.handler(job)
                if result.get("success"):
                    self.store.transition(
                        job.id,
                        JobState.SUCCEEDED,
                        result=result,
                        timings=result.get("timings", {}),
                    )
                    continue
                raise RuntimeError(result.get("error", {}).get("message", "job failed"))
            except Exception as error:  # noqa: BLE001
                self._handle_failure(job, error)

    def _handle_failure(self, job: Job, error: Exception) -> None:
        error_doc = {"message": str(error), "attempts": job.attempts}
        if job.attempts >= self.config.attempts:
            self.logger.error(
                "Job exhausted retries -> dead letter",
                {"jobId": job.id, "attempts": job.attempts},
            )
            self.store.transition(job.id, JobState.DEAD_LETTER, error=error_doc)
            if self.on_exhausted is not None:
                try:
                    self.on_exhausted(job)  # credit refund compensation
                except Exception as hook_error:  # pragma: no cover
                    self.logger.error(
                        "on_exhausted hook failed", {"jobId": job.id, "error": str(hook_error)}
                    )
            return
        delay_s = backoff_delay_ms(
            job.attempts,
            base_ms=self.config.backoff_base_ms,
            jitter=self.config.backoff_jitter,
        ) / 1000.0
        self.logger.warn(
            "Job failed; retrying",
            {"jobId": job.id, "attempt": job.attempts, "delayS": round(delay_s, 2)},
        )
        job = self.store.transition(job.id, JobState.QUEUED, error=error_doc)
        self.enqueue(job, delay_s=delay_s)
