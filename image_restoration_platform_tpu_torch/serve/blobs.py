"""Durable disk-backed blob tier with per-prefix retention (the GCS analog).

The reference stores originals and restored results in a GCS bucket with
lifecycle rules — delete ``originals/`` after 30 days and ``restored/`` after
90 days (gcsClient.js:26-42, env ``GCS_ORIGINAL_RETENTION_DAYS`` /
``GCS_RESTORED_RETENTION_DAYS``) — and hands out 15-minute V4 signed upload
URLs whose *object* then persists for the prefix retention
(gcsClient.js:44-67, env ``GCS_UPLOAD_TTL_SECONDS``). This module is the
self-hosted equivalent: blobs live as files under ``BLOB_STORE_PATH`` with a
tiny JSON sidecar (owner, content type, creation time), expiry is enforced by
file age per prefix, and uploads can be streamed straight from a spooled
request body into place with an atomic rename (no full-body memory copy).

When ``BLOB_STORE_PATH`` is unset the :class:`MemoryBlobStore` fallback keeps
the round-3 behavior (KV-store blobs, TTL only), mirroring how every other
external client here degrades to a local fake.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import uuid

from ..utils.logging import get_logger

_log = get_logger("blobs")

ORIGINALS = "originals"
RESULTS = "restored"  # reference prefix name, gcsClient.js:37

_TOKEN_SAFE = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_")


def _safe_token(token: str) -> str:
    """Blob names become file names: reject anything path-like."""
    token = str(token)
    if not token or len(token) > 128 or any(c not in _TOKEN_SAFE for c in token):
        raise ValueError(f"invalid blob token: {token!r}")
    return token


class DiskBlobStore:
    """Filesystem blob tier: ``<root>/<prefix>/<token>`` + ``<token>.meta``.

    Retention is evaluated lazily on read and by :meth:`sweep` (called
    opportunistically from :meth:`put` at most once per
    ``sweep_interval_seconds``), so no background thread is needed and the
    policy survives restarts — file mtimes are the clock.
    """

    def __init__(
        self,
        root: str,
        *,
        retention_seconds: dict[str, float] | None = None,
        slot_ttl_seconds: int | None = None,
        sweep_interval_seconds: float = 3600.0,
        clock=time.time,
    ):
        self.root = os.path.abspath(root)
        days = 24 * 3600.0
        self.retention_seconds = retention_seconds or {
            ORIGINALS: float(os.environ.get("GCS_ORIGINAL_RETENTION_DAYS", 30)) * days,
            RESULTS: float(os.environ.get("GCS_RESTORED_RETENTION_DAYS", 90)) * days,
        }
        self.ttl_seconds = (
            int(os.environ.get("GCS_UPLOAD_TTL_SECONDS", 900))
            if slot_ttl_seconds is None
            else slot_ttl_seconds
        )
        self._sweep_interval = sweep_interval_seconds
        self._last_sweep = 0.0
        self._clock = clock
        self._lock = threading.Lock()
        for prefix in self.retention_seconds:
            os.makedirs(os.path.join(self.root, prefix), exist_ok=True)

    # ------------------------------------------------------------- internals

    def _path(self, prefix: str, token: str) -> str:
        return os.path.join(self.root, prefix, _safe_token(token))

    def _expired(self, path: str, prefix: str, now: float | None = None) -> bool:
        try:
            age = (now if now is not None else self._clock()) - os.path.getmtime(path)
        except OSError:
            return True
        return age > self.retention_seconds.get(prefix, float("inf"))

    # ------------------------------------------------------------------ API

    def put(
        self,
        token: str,
        data,
        *,
        prefix: str = ORIGINALS,
        user_id: str | None = None,
        content_type: str = "image/jpeg",
    ) -> None:
        """Store bytes or a readable binary file object (spooled upload body)
        atomically: write/copy to a temp file in the same directory, fsync-free
        rename into place. The sidecar carries ownership for later
        authorization (GCS stores userId in object metadata, gcsClient.js:58)."""
        path = self._path(prefix, token)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        meta_tmp = tmp + ".m"
        try:
            with os.fdopen(fd, "wb") as out:
                if isinstance(data, (bytes, bytearray, memoryview)):
                    out.write(data)
                else:
                    data.seek(0)
                    shutil.copyfileobj(data, out, length=1 << 20)
            meta = {
                "userId": user_id,
                "contentType": content_type,
                "createdAt": self._clock(),
            }
            # both files land atomically (tmp + rename), data first: a crash
            # between the renames leaves new data with the previous sidecar,
            # and ownership checks FAIL CLOSED on mismatch/absence
            with open(meta_tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, path)
            os.replace(meta_tmp, path + ".meta")
            # age is judged by mtime; stamp it from the store clock so tests
            # with an injected clock control retention deterministically
            os.utime(path, (meta["createdAt"], meta["createdAt"]))
        except BaseException:
            for victim in (tmp, meta_tmp):
                try:
                    os.unlink(victim)
                except OSError:
                    pass
            raise
        self._maybe_sweep()

    def get(self, token: str, *, prefix: str = ORIGINALS) -> bytes | None:
        path = self._path(prefix, token)
        if not os.path.exists(path) or self._expired(path, prefix):
            return None
        with open(path, "rb") as f:
            return f.read()

    def get_meta(self, token: str, *, prefix: str = ORIGINALS) -> dict | None:
        path = self._path(prefix, token)
        if not os.path.exists(path) or self._expired(path, prefix):
            return None
        try:
            with open(path + ".meta") as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    # Result-blob convenience wrappers (restored/<jobId>, 90-day retention).
    def put_result(self, job_id: str, data: bytes, *, user_id: str | None = None) -> None:
        self.put(job_id, data, prefix=RESULTS, user_id=user_id)

    def get_result(self, job_id: str) -> bytes | None:
        return self.get(job_id, prefix=RESULTS)

    def get_result_meta(self, job_id: str) -> dict | None:
        return self.get_meta(job_id, prefix=RESULTS)

    # -------------------------------------------------------------- sweeping

    def _maybe_sweep(self) -> None:
        now = self._clock()
        with self._lock:
            if now - self._last_sweep < self._sweep_interval:
                return
            self._last_sweep = now
        self.sweep(now=now)

    def sweep(self, now: float | None = None) -> int:
        """Delete blobs past their prefix retention; returns count removed."""
        removed = 0
        now = self._clock() if now is None else now
        for prefix in self.retention_seconds:
            directory = os.path.join(self.root, prefix)
            try:
                names = os.listdir(directory)
            except OSError:
                continue
            data_names = {n for n in names if not n.endswith((".meta", ".tmp", ".tmp.m"))}
            for name in names:
                path = os.path.join(directory, name)
                if name.endswith(".meta"):
                    # orphan sidecars (crash between unlinks / failed put)
                    if name[: -len(".meta")] not in data_names:
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                    continue
                if name.endswith((".tmp", ".tmp.m")):
                    continue
                if self._expired(path, prefix, now):
                    for victim in (path, path + ".meta"):
                        try:
                            os.unlink(victim)
                        except OSError:
                            pass
                    removed += 1
        if removed:
            _log.info("Blob retention sweep", {"removed": removed})
        return removed

    def stats(self) -> dict:
        out = {}
        for prefix in self.retention_seconds:
            directory = os.path.join(self.root, prefix)
            try:
                names = [
                    n
                    for n in os.listdir(directory)
                    if not n.endswith((".meta", ".tmp", ".tmp.m"))
                ]
            except OSError:
                names = []
            out[prefix] = len(names)
        return out


class MemoryBlobStore:
    """KV-backed fallback (the round-3 ``BlobStore``): short-lived originals,
    retention-TTL'd results. Used when ``BLOB_STORE_PATH`` is unset — the
    same degrade-to-local-fake policy as every other client tier."""

    MAX_RESULTS = 256  # memory mode cannot honor 90-day retention unbounded

    def __init__(self, store, ttl_seconds: int | None = None):
        self.store = store
        self.ttl_seconds = (
            int(os.environ.get("GCS_UPLOAD_TTL_SECONDS", 900))
            if ttl_seconds is None
            else ttl_seconds
        )
        # memory fallback bounds the result tier two ways: a short TTL (1 day,
        # not the disk tier's 90) and an eviction ring of MAX_RESULTS job ids —
        # the KV store only expires lazily on read, so without the ring every
        # restored image ever produced would accumulate until OOM
        self._result_ttl = 24 * 3600
        self._result_ring: list[str] = []

    def put(self, token: str, data, *, prefix: str = ORIGINALS, user_id=None, content_type=None) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data.seek(0)
            data = data.read()
        ttl = self._result_ttl if prefix == RESULTS else self.ttl_seconds
        token = _safe_token(token)
        self.store.set(f"blob:{prefix}:{token}", bytes(data), ttl)
        if user_id is not None:
            self.store.set(f"blobmeta:{prefix}:{token}", json.dumps({"userId": user_id}), ttl)
        if prefix == RESULTS:
            self._result_ring.append(token)
            while len(self._result_ring) > self.MAX_RESULTS:
                victim = self._result_ring.pop(0)
                self.store.delete(f"blob:{prefix}:{victim}")
                self.store.delete(f"blobmeta:{prefix}:{victim}")

    def get(self, token: str, *, prefix: str = ORIGINALS) -> bytes | None:
        return self.store.get(f"blob:{prefix}:{_safe_token(token)}")

    def get_meta(self, token: str, *, prefix: str = ORIGINALS) -> dict | None:
        raw = self.store.get(f"blobmeta:{prefix}:{_safe_token(token)}")
        if raw is None:
            return None if self.get(token, prefix=prefix) is None else {}
        return json.loads(raw)

    def put_result(self, job_id: str, data: bytes, *, user_id=None) -> None:
        self.put(job_id, data, prefix=RESULTS, user_id=user_id)

    def get_result(self, job_id: str) -> bytes | None:
        return self.get(job_id, prefix=RESULTS)

    def get_result_meta(self, job_id: str) -> dict | None:
        return self.get_meta(job_id, prefix=RESULTS)

    def sweep(self, now=None) -> int:
        return 0

    def stats(self) -> dict:
        return {}


def create_blob_store(store, path: str | None = None):
    """Durable disk tier when ``BLOB_STORE_PATH`` is set (same selection rule
    as ``DURABLE_DB_PATH`` for the SQLite tier), else the in-memory fake."""
    path = path or os.environ.get("BLOB_STORE_PATH")
    if path:
        _log.info("Blob store: disk", {"path": path})
        return DiskBlobStore(path)
    return MemoryBlobStore(store)


def new_token() -> str:
    return uuid.uuid4().hex
