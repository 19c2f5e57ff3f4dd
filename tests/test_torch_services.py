"""PyTorch port: the host services of the HTTP API against the JAX package's.

The port keeps its own copies of the store, rate limiter, idempotency,
credits (with the SQLite durable tier), job store and queue, blobs and
moderation. Each scripted sequence below runs once through each package on
the same inputs; the outcomes, with ids and clock stamps replaced by
placeholders, must be identical. The store sequence also runs against the
Redis store over tests/fake_redis.py."""

import importlib
import re
import threading
import time

import numpy as np
import pytest

from fake_redis import FakeRedisServer

PKGS = ("image_restoration_platform_tpu", "image_restoration_platform_tpu_torch")
_ID = re.compile(r"^[0-9a-f]{32}$|^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _norm(obj, ids=None):
    """Ids become ID<n> in order of first appearance, epoch stamps become T."""
    ids = {} if ids is None else ids
    if isinstance(obj, dict):
        return {k: _norm(v, ids) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_norm(v, ids) for v in obj]
    if isinstance(obj, str) and _ID.match(obj):
        return ids.setdefault(obj, f"ID{len(ids)}")
    if isinstance(obj, float) and obj > 1e9:
        return "T"
    if hasattr(obj, "value") and hasattr(obj, "name"):  # enums
        return obj.value
    return obj


def _problem(p):
    return None if p is None else {"status": p.status, "title": p.title, "type": p.type, "detail": p.detail}


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# ------------------------------------------------------------- sequences


def store_ratelimit_idempotency(pkg, store):
    config = _mod(pkg, "config")
    RateLimiter = _mod(pkg, "serve.ratelimit").RateLimiter
    IdempotencyService = _mod(pkg, "serve.idempotency").IdempotencyService
    out = []
    store.set("k", {"a": 1, "body": b"\x00\xff"}, ttl_seconds=60)
    out += [store.get("k"), store.get("missing"), store.set_if_absent("k", 2), store.set_if_absent("n", 3)]
    out += [store.incr("c"), store.incr_by("c", 4), store.decr("c")]
    out += [store.incr_with_limit("lim", 2, 60) for _ in range(3)]
    out += [store.check_and_decrement("bal", 1, 60)]
    store.set("bal", 2)
    out += [store.check_and_decrement("bal", 1, 60) for _ in range(3)]
    store.delete("k")
    out += [store.get("k")]

    limiter = RateLimiter(store, config.RateLimitConfig(user_limit=3, user_interval_s=60, ip_limit=4,
                                                        ip_interval_s=60))
    for user, ip in (("alice", "1.2.3.4"),) * 5 + (("bob", "1.2.3.4"), (None, "5.6.7.8")):
        headers, problem = limiter.check(user, ip)
        out.append(({k: v for k, v in headers.items() if k != "RateLimit-Reset"}, _problem(problem)))

    idem = IdempotencyService(store)
    key = "123e4567-e89b-42d3-a456-426614174000"
    out += [_problem(idem.validate_key(None)), _problem(idem.validate_key("nope")), _problem(idem.validate_key(key))]
    out += [idem.lookup(key, "fp1")]
    idem.record(key, "fp1", 202, {"Location": "/v1/jobs/x", "Content-Length": "9"}, b'{"id":1}', "application/json")
    cached, conflict = idem.lookup(key, "fp1")
    out += [(cached.status, cached.headers, cached.body, cached.content_type, conflict)]
    out += [_problem(idem.lookup(key, "fp2")[1])]
    other = "123e4567-e89b-42d3-a456-426614174001"
    idem.record(other, "fp", 503, {}, b"", "application/json")  # 5xx stays retryable
    out += [idem.lookup(other, "fp")]
    return out


def credits(pkg, tmp_path):
    config = _mod(pkg, "config")
    durable = _mod(pkg, "serve.durable")
    CreditsService = _mod(pkg, "serve.credits").CreditsService
    MemoryStore = _mod(pkg, "serve.store").MemoryStore
    user_store, ledger = durable.create_durable_tier(str(tmp_path / f"{pkg}.db"))
    svc = CreditsService(store=MemoryStore(), user_store=user_store, ledger=ledger,
                         config=config.CreditsConfig(daily_free_limit=2))
    out = [svc.get_balance("bob")]
    out += [svc.check_and_deduct("bob", 1, f"job{i}") for i in range(3)]  # two free, then refused
    out += [user_store.grant("bob", 2)]
    svc.store.delete("credits:bob")
    out += [svc.check_and_deduct("bob", 1, "job3"), svc.get_balance("bob")]
    out += [svc.refund("bob", "job3", 1, "failed"), svc.refund("bob", "job0"), svc.refund("bob", "nojob")]
    out += [svc.get_balance("bob")]
    out += [[{k: e.get(k) for k in ("userId", "jobId", "amount", "type", "reason")} for e in ledger.entries()]]
    # the durable tier survives a restart
    users2, ledger2 = durable.create_durable_tier(str(tmp_path / f"{pkg}.db"))
    out += [users2.get_credits("bob"), len(ledger2.entries())]
    return out


def jobs_queue(pkg, tmp_path):
    """Retry with backoff, dead letter after the last attempt with the refund
    hook, replay, and crash recovery from the SQLite job store."""
    config = _mod(pkg, "config")
    durable = _mod(pkg, "serve.durable")
    JobQueue = _mod(pkg, "serve.queue").JobQueue
    JobState = _mod(pkg, "serve.jobs").JobState
    store = durable.create_job_store(str(tmp_path / f"{pkg}-jobs.db"))
    calls: dict[str, int] = {}
    refunds: list[str] = []
    lock = threading.Lock()

    def handler(job):
        with lock:
            calls[job.payload["name"]] = calls.get(job.payload["name"], 0) + 1
            n = calls[job.payload["name"]]
        if job.payload["name"] == "flaky" and n < 2:
            raise RuntimeError("transient")
        if job.payload["name"] == "broken" and not job.payload.get("fixed"):
            raise RuntimeError("always")
        return {"success": True, "n": n}

    queue = JobQueue(store, handler, config.QueueConfig(attempts=3, backoff_base_ms=1, backoff_jitter=0.0),
                     workers=2, on_exhausted=lambda job: refunds.append(job.payload["name"]))
    try:
        jobs = {name: store.create("carol", {"name": name}) for name in ("ok", "flaky", "broken")}
        for job in jobs.values():
            queue.enqueue(job)
        done = (JobState.SUCCEEDED, JobState.DEAD_LETTER)
        assert _wait(lambda: all(store.get(j.id).state in done for j in jobs.values()))
        out = [{name: (store.get(j.id).state, store.get(j.id).attempts, store.get(j.id).result, calls[name])
                for name, j in jobs.items()}, sorted(refunds), [j.payload["name"] for j in store.dead_letter_jobs()]]
        with pytest.raises(ValueError):
            queue.replay_dead_letter(jobs["ok"].id)
        store.get(jobs["broken"].id).payload["fixed"] = True
        out.append(queue.replay_dead_letter(jobs["broken"].id).state)
        assert _wait(lambda: store.get(jobs["broken"].id).state is JobState.SUCCEEDED)
        out.append((store.get(jobs["broken"].id).attempts, [j.user_id for j in store.list_for_user("carol")]))
    finally:
        queue.shutdown(timeout=5.0)

    # a process that died with one job queued and one mid-attempt
    path = str(tmp_path / f"{pkg}-crash.db")
    crashed = durable.create_job_store(path)
    a = crashed.create("dave", {"name": "a"})
    b = crashed.create("dave", {"name": "b"})
    crashed.transition(b.id, JobState.RUNNING, attempts=1)
    c = crashed.create("dave", {"name": "c"})
    crashed.transition(c.id, JobState.RUNNING, attempts=1)
    crashed.transition(c.id, JobState.SUCCEEDED, result={"success": True})
    restarted = durable.create_job_store(path)
    recovered = restarted.recover_incomplete()
    out.append(sorted((j.payload["name"], j.state, j.attempts) for j in recovered))
    out.append([restarted.get(x.id).state for x in (a, b, c)])
    return out


def blobs(pkg, tmp_path):
    blob_mod = _mod(pkg, "serve.blobs")
    MemoryStore = _mod(pkg, "serve.store").MemoryStore
    out = []
    clock = [1_000.0]
    for store in (
        blob_mod.create_blob_store(MemoryStore()),
        blob_mod.DiskBlobStore(str(tmp_path / f"{pkg}-blobs"), retention_seconds={"originals": 100.0,
                                                                                  "restored": 1000.0},
                               slot_ttl_seconds=900, clock=lambda: clock[0]),
    ):
        store.put("tok1", b"jpeg-bytes", user_id="erin")
        store.put_result("job1", b"restored", user_id="erin")
        out += [type(store).__name__, store.ttl_seconds, store.get("tok1"), store.get("nothing"),
                {k: v for k, v in (store.get_meta("tok1") or {}).items() if k != "createdAt"},
                store.get_result("job1"), (store.get_result_meta("job1") or {}).get("userId")]
        with pytest.raises(ValueError):
            store.put("../escape", b"x")
        if isinstance(store, blob_mod.DiskBlobStore):
            out.append(store.stats())
            clock[0] = time.time() + 500.0  # originals expire, results stay
            out += [store.sweep(), store.get("tok1"), store.get_result("job1"), store.stats()]
    return out


def moderation(pkg, _tmp_path):
    ModerationService = _mod(pkg, "serve.moderation").ModerationService
    vision = _mod(pkg, "serve.vision")
    svc = ModerationService(vision_client=vision.create_vision_client())
    assert svc.use_mock  # no key set: the deterministic mock
    rng = np.random.default_rng(0)
    out = []
    for size in (10, 120, 185, 190, 196, 199, 250, 1000):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        res = svc.moderate(data, {"userId": "frank"})
        out.append({k: v for k, v in res.items() if k != "timestamp"})
    out.append([{k: v for k, v in e.items() if k not in ("timestamp", "id")} for e in svc.audit.entries()])
    out.append(svc.get_moderation_policy())
    return out


SEQUENCES = {"credits": credits, "jobs_queue": jobs_queue, "blobs": blobs, "moderation": moderation}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sequence_matches_reference(name, tmp_path, monkeypatch):
    for var in ("DURABLE_DB_PATH", "BLOB_STORE_PATH", "REDIS_URL", "VISION_API_KEY", "VISION_ACCESS_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    ref, port = (_norm(SEQUENCES[name](pkg, tmp_path)) for pkg in PKGS)
    assert ref and port == ref


@pytest.mark.parametrize("backend", ["memory", "redis"])
def test_store_sequence_matches_reference(backend):
    outcomes = []
    for pkg in PKGS:
        if backend == "memory":
            outcomes.append(_norm(store_ratelimit_idempotency(pkg, _mod(pkg, "serve.store").MemoryStore())))
            continue
        server = FakeRedisServer()
        try:
            redis = _mod(pkg, "serve.redis_store")
            store = redis.RedisStore(client=redis.RespClient("127.0.0.1", server.port, timeout=2.0))
            assert store.ping() and store.get_mode() == "redis"
            outcomes.append(_norm(store_ratelimit_idempotency(pkg, store)))
        finally:
            server.stop()
    assert outcomes[0] and outcomes[1] == outcomes[0]
