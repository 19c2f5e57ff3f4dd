"""Continuous micro-batching across concurrent requests.

Counterpart of image_restoration_platform_tpu/serve/batcher.py: requests
arriving within ``max_wait_ms`` coalesce into one device batch per
(family, canvas size, egress). A dispatcher thread picks a queue, lingers
for stragglers, and launches the batch without waiting; a collector thread
fetches results (the one synchronising copy) and resolves the futures.
``pipeline_depth`` bounds the batches in flight. A queue whose oldest
request has waited past ``fairness_age_ms`` is dispatched next, and
deadline expiry is swept across all queues. A failed batch fails only its
own requests. A request's wait is its ``batcher.wait`` span; the batch's
``engine.call`` names the traces of the requests it serves.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from ..config import ServingConfig
from ..obs.metrics import get_counters
from ..obs.tracing import get_tracer
from ..utils.logging import get_logger
from .engine import RestorationEngine, resolve_device


class _Pending:
    __slots__ = ("canvas", "valid_hw", "is_jpeg", "future", "arrived", "trace_id")

    def __init__(self, canvas, valid_hw, is_jpeg, future, trace_id):
        self.canvas = canvas
        self.valid_hw = valid_hw
        self.is_jpeg = is_jpeg
        self.future = future
        self.arrived = time.perf_counter()
        self.trace_id = trace_id


class MicroBatcher:
    def __init__(
        self,
        engine: RestorationEngine,
        config: ServingConfig | None = None,
        device: str = "cuda",
    ):
        if resolve_device(device).type != engine.device.type:
            raise ValueError(f"batcher device {device} differs from the engine's {engine.device}")
        self.engine = engine
        self.config = config or ServingConfig()
        self.logger = get_logger("batcher")
        self._tracer = get_tracer("batcher")
        self._queues: dict[tuple, deque[_Pending]] = {}
        self._cv = threading.Condition()
        self._running = True
        # pipeline_depth bounds DISPATCHED-but-unfetched batches: the slot is
        # taken before the engine launch and released after the collector's
        # fetch, so the device never holds more than `depth` batches. The
        # handoff queue itself is unbounded (slots are the backpressure).
        depth = max(1, int(getattr(self.config, "pipeline_depth", 2)))
        self._slots = threading.BoundedSemaphore(depth)
        self._inflight: queue_mod.Queue = queue_mod.Queue()
        # observability: high-water mark of concurrently in-flight batches
        self.max_inflight_observed = 0
        self._inflight_count = 0
        self._inflight_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="micro-batcher-dispatch"
        )
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True, name="micro-batcher-collect"
        )
        self._dispatcher.start()
        self._collector.start()

    # -------------------------------------------------------------- public

    def submit(
        self,
        canvas: np.ndarray,
        valid_hw: tuple[int, int],
        is_jpeg: bool,
        family: str,
        egress: str = "rgb",
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Blocking submit; returns (restored_canvas, scores[7], engine_meta).
        With egress="yuv420" the first element is this request's (Y, Cb, Cr)
        u8 plane tuple (engine.restore_batch egress). Egress is part of the
        batch key: a batch runs one compiled program, so requests wanting
        planes and requests wanting RGB cannot share a launch."""
        key = (family, canvas.shape[0], canvas.shape[1], egress)
        with self._tracer.span("batcher.wait", {"batcher.family": family, "batcher.canvas": canvas.shape[0]}) as span:
            pending = _Pending(canvas, np.asarray(valid_hw, np.int32), bool(is_jpeg), Future(), span.trace_id)
            with self._cv:
                if not self._running:
                    raise RuntimeError("batcher is shut down")
                self._queues.setdefault(key, deque()).append(pending)
                self._cv.notify()
            # the dispatcher's expiry sweep is the deadline authority (it
            # reports queue-expiry distinctly); the caller-side timeout is a
            # backstop one second behind it
            return pending.future.result(timeout=self.config.request_deadline_s + 1.0)

    def shutdown(self, drain: bool = True) -> None:
        """Queue drain on SIGTERM (SURVEY.md section 5 failure handling)."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._dispatcher.join(timeout=30 if drain else 1)
        self._collector.join(timeout=30 if drain else 1)

    def depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    # ---------------------------------------------------------- dispatcher

    def _pick_key(self, now: float):
        """Deepest queue first for device economics — unless some queue's head
        has aged past the fairness bound, in which case the oldest head wins
        (starvation guard for cold buckets under a hot-bucket flood)."""
        fairness_age_s = getattr(self.config, "fairness_age_ms", 50.0) / 1000.0
        oldest_key, oldest_age = None, -1.0
        deepest_key, deepest_score = None, None
        for key, q in self._queues.items():
            if not q:
                continue
            age = now - q[0].arrived
            if age > oldest_age:
                oldest_key, oldest_age = key, age
            score = (len(q), age)
            if deepest_score is None or score > deepest_score:
                deepest_key, deepest_score = key, score
        if oldest_key is not None and oldest_age >= fairness_age_s:
            return oldest_key
        return deepest_key

    def _sweep_expired_locked(self, now: float) -> list[_Pending]:
        """Collect deadline-expired requests from EVERY queue (round-2 expiry
        only ran on the winning queue, so a starved queue's requests could sit
        past their deadline unobserved)."""
        expired = []
        for q in self._queues.values():
            while q and now - q[0].arrived > self.config.request_deadline_s:
                expired.append(q.popleft())
        return expired

    def _expire_all(self) -> None:
        with self._cv:
            expired = self._sweep_expired_locked(time.perf_counter())
        for pending in expired:
            if not pending.future.done():
                pending.future.set_exception(TimeoutError("request expired in batch queue"))

    def _dispatch_loop(self) -> None:
        max_wait_s = self.config.max_wait_ms / 1000.0
        while True:
            # 1. wait for work
            with self._cv:
                while self._running and not any(self._queues.values()):
                    self._cv.wait(timeout=0.5)
                if not self._running and not any(self._queues.values()):
                    self._inflight.put(None)  # wake + stop the collector
                    return
            # 2. wait for a free pipeline slot, sweeping deadline-expired
            # requests meanwhile (a full device pipeline must not stop the
            # expiry clock for queued work)
            acquired = False
            while self._running or self.depth() > 0:
                if self._slots.acquire(timeout=0.05):
                    acquired = True
                    break
                self._expire_all()
            if not acquired:
                continue  # shutting down with nothing queued
            # 3. pick a queue, linger for stragglers, form the batch
            with self._cv:
                now = time.perf_counter()
                key = self._pick_key(now)
                if key is None:  # everything expired/drained while waiting
                    batch, expired = [], []
                else:
                    q = self._queues[key]
                    # linger only if the batch isn't already full
                    if len(q) < self.config.max_batch and self._running:
                        oldest = q[0].arrived if q else now
                        deadline = oldest + max_wait_s
                        while (
                            len(q) < self.config.max_batch
                            and time.perf_counter() < deadline
                            and self._running
                        ):
                            self._cv.wait(timeout=max(0.001, deadline - time.perf_counter()))
                    # expire requests that outlived their deadline while
                    # queued — across ALL queues, not just the winner
                    expired = self._sweep_expired_locked(time.perf_counter())
                    batch = [q.popleft() for _ in range(min(len(q), self.config.max_batch))]

            for pending in expired:
                if not pending.future.done():
                    pending.future.set_exception(
                        TimeoutError("request expired in batch queue")
                    )
            if not batch:
                self._slots.release()
                continue
            family, egress = key[0], key[3]
            imgs = np.stack([p.canvas for p in batch], axis=0)
            valid_hw = np.stack([p.valid_hw for p in batch], axis=0)
            is_jpeg = np.asarray([p.is_jpeg for p in batch], dtype=np.float32)
            try:
                # stage + launch WITHOUT waiting: the fetch happens on the
                # collector thread while this thread forms the next batch
                fetch = self.engine.restore_batch_async(
                    imgs, valid_hw, is_jpeg, family, egress, trace_ids=tuple(p.trace_id for p in batch)
                )
            except Exception as error:  # noqa: BLE001 - batch failure isolation
                self.logger.error("Batch dispatch failed", {"family": family, "error": str(error)})
                self._slots.release()
                for pending in batch:
                    if not pending.future.done():
                        pending.future.set_exception(error)
                continue
            with self._inflight_lock:
                self._inflight_count += 1
                self.max_inflight_observed = max(self.max_inflight_observed, self._inflight_count)
            self._inflight.put((batch, fetch, family))

    # ----------------------------------------------------------- collector

    def _collect_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, fetch, family = item
            try:
                outs, scores, meta = fetch()
                counters = get_counters()
                counters.inc("images_restored_total", len(batch))
                counters.inc("device_seconds_total", meta.get("deviceSeconds", 0.0))
                counters.gauge("last_batch_size", len(batch))
                for i, pending in enumerate(batch):
                    if isinstance(outs, tuple):  # yuv420 plane egress
                        out_i = (outs[0][i], outs[1][i], outs[2][i])
                    else:
                        out_i = outs[i]
                    pending.future.set_result((out_i, scores[i], dict(meta)))
            except Exception as error:  # noqa: BLE001 - batch failure isolation
                self.logger.error("Batch fetch failed", {"family": family, "error": str(error)})
                for pending in batch:
                    if not pending.future.done():
                        pending.future.set_exception(error)
            finally:
                with self._inflight_lock:
                    self._inflight_count -= 1
                self._slots.release()
