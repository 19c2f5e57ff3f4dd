"""PyTorch port: the micro-batcher's pipeline behaviour (serve/batcher.py).

Counterparts of the 4 tests of tests/test_batcher_pipeline.py against the
port's ``MicroBatcher`` with a fake engine, so timing is deterministic and
device-free: two batches in flight (double-buffering), strictly serialised
dispatch at depth one, a cold bucket not starved by a hot flood, and
deadline expiry swept while the pipeline is full."""

import threading
import time

import numpy as np
import torch

from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.serve.batcher import MicroBatcher


class FakeEngine:
    """Mimics RestorationEngine.restore_batch_async: dispatch returns
    immediately; fetch() blocks for exec_time (or on an Event)."""

    device = torch.device("cpu")

    def __init__(self, exec_time=0.005, gate: threading.Event | None = None):
        self.exec_time = exec_time
        self.gate = gate
        self.dispatches: list[tuple[float, str, int]] = []
        self._lock = threading.Lock()

    def restore_batch_async(self, imgs, valid_hw, is_jpeg, family, egress="rgb"):
        with self._lock:
            self.dispatches.append((time.perf_counter(), family, imgs.shape[0]))
        n = imgs.shape[0]

        def fetch():
            if self.gate is not None:
                assert self.gate.wait(timeout=30)
            time.sleep(self.exec_time)
            scores = np.zeros((n, 7), np.float32)
            meta = {"deviceSeconds": self.exec_time, "batchBucket": n, "family": family}
            return imgs.copy(), scores, meta

        return fetch


def _batcher(engine, **cfg):
    return MicroBatcher(engine, ServingConfig(size_buckets=(16,), **cfg), device="cpu")


def _submit_async(batcher, family, tag=0):
    result = {}

    def call():
        canvas = np.full((16, 16, 3), tag % 255, np.uint8)
        try:
            result["value"] = batcher.submit(canvas, (16, 16), False, family)
        except Exception as error:  # noqa: BLE001
            result["error"] = error

    t = threading.Thread(target=call, daemon=True)
    t.start()
    return t, result


def test_two_batches_in_flight():
    """Batch N+1 is staged while batch N is still executing: with the
    collector's fetch gated shut, a second batch still gets dispatched."""
    gate = threading.Event()
    engine = FakeEngine(gate=gate)
    batcher = _batcher(engine, max_batch=1, max_wait_ms=1.0, pipeline_depth=2, request_deadline_s=30.0)
    try:
        threads = [_submit_async(batcher, "fam", i)[0] for i in range(3)]
        deadline = time.time() + 5
        while time.time() < deadline and len(engine.dispatches) < 2:
            time.sleep(0.005)
        assert len(engine.dispatches) >= 2, "no overlap: second batch not dispatched while first executes"
        assert batcher.max_inflight_observed >= 2
        gate.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        gate.set()
        batcher.shutdown()


def test_serialized_when_depth_one():
    """pipeline_depth=1: the second batch is not dispatched while the first
    is unfetched (the slot is taken before the engine launch)."""
    gate = threading.Event()
    engine = FakeEngine(gate=gate)
    batcher = _batcher(engine, max_batch=1, max_wait_ms=1.0, pipeline_depth=1, request_deadline_s=30.0)
    try:
        threads = [_submit_async(batcher, "fam", i)[0] for i in range(3)]
        time.sleep(0.3)
        assert len(engine.dispatches) == 1
        assert batcher.max_inflight_observed <= 1
        gate.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        gate.set()
        batcher.shutdown()


def test_cold_bucket_not_starved_by_hot_flood():
    """With fairness_age_ms=30 a cold bucket's lone request completes while
    a hot bucket's flood is still running."""
    engine = FakeEngine(exec_time=0.01)
    batcher = _batcher(engine, max_batch=4, max_wait_ms=1.0, pipeline_depth=2, fairness_age_ms=30.0,
                       request_deadline_s=30.0)
    stop_flood = threading.Event()
    try:
        def flood():
            i = 0
            while not stop_flood.is_set():
                try:
                    batcher.submit(np.full((16, 16, 3), i % 255, np.uint8), (16, 16), False, "hot")
                except Exception:
                    return
                i += 1

        flooders = [threading.Thread(target=flood, daemon=True) for _ in range(6)]
        for t in flooders:
            t.start()
        time.sleep(0.2)  # flood established, hot queue continuously deep

        t0 = time.perf_counter()
        out, scores, meta = batcher.submit(np.zeros((16, 16, 3), np.uint8), (16, 16), False, "cold")
        cold_latency = time.perf_counter() - t0
        assert meta["family"] == "cold"
        # solo latency ~exec_time + linger; fairness adds at most
        # fairness_age_ms + one in-flight hot batch; without it the request
        # waits for its 30 s deadline
        assert cold_latency < 1.0, f"cold request took {cold_latency:.3f}s under hot flood"
        assert any(f == "cold" for _, f, _ in engine.dispatches)
    finally:
        stop_flood.set()
        batcher.shutdown()


def test_expiry_swept_while_pipeline_full():
    """Deadline expiry keeps running while the device pipeline is full and
    dispatch is stalled."""
    gate = threading.Event()  # holds the one in-flight batch on the device
    engine = FakeEngine(gate=gate)
    batcher = _batcher(engine, max_batch=1, max_wait_ms=1.0, pipeline_depth=1, fairness_age_ms=10_000.0,
                       request_deadline_s=0.3)
    try:
        t_busy, r_busy = _submit_async(batcher, "busy", 0)
        deadline = time.time() + 5
        while time.time() < deadline and not engine.dispatches:
            time.sleep(0.005)
        assert len(engine.dispatches) == 1

        # the second request can never dispatch while the slot is held; the
        # sweep expires it with the batcher's own TimeoutError
        t, result = _submit_async(batcher, "doomed", 1)
        t.join(timeout=10)
        assert "error" in result, result
        assert "expired in batch queue" in str(result["error"])
        assert len(engine.dispatches) == 1
        gate.set()
        # the busy caller timed out at its deadline through the caller-side
        # Future timeout, not the sweep
        t_busy.join(timeout=10)
        assert "expired in batch queue" not in str(r_busy.get("error", ""))
    finally:
        gate.set()
        batcher.shutdown()
