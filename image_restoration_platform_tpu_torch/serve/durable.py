"""Durable user/ledger tier backed by SQLite.

The reference persists balances in Firestore ``users/<uid>.credits`` with
write-behind sync (credits.js:459-469) and audits every movement to a
``credit_ledger`` collection (credits.js:471-509). This is the pluggable
durable analog: the same ``DurableUserStore``/``Ledger`` interfaces
(serve/credits.py) over a single SQLite file, so balances and audit history
survive process restarts. WAL mode keeps ledger appends non-blocking for
readers; a process-wide lock serializes writers (SQLite's own locking is
per-connection; the serving process is the single writer).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid

from ..utils.logging import get_logger
from .jobs import Job, JobState, JobStore

_log = get_logger("durable")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    user_id TEXT PRIMARY KEY,
    credits INTEGER NOT NULL DEFAULT 0,
    last_updated REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS credit_ledger (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL,
    job_id TEXT,
    amount INTEGER NOT NULL,
    type TEXT NOT NULL,
    reason TEXT,
    original_transaction_id TEXT,
    extras TEXT,
    timestamp REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_ledger_job ON credit_ledger(job_id);
CREATE INDEX IF NOT EXISTS idx_ledger_user ON credit_ledger(user_id);
CREATE TABLE IF NOT EXISTS jobs (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL,
    state TEXT NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    attempts INTEGER NOT NULL,
    version INTEGER NOT NULL,
    payload TEXT,
    result TEXT,
    error TEXT,
    timings TEXT,
    traceparent TEXT,
    request_id TEXT
);
CREATE INDEX IF NOT EXISTS idx_jobs_user ON jobs(user_id);
CREATE INDEX IF NOT EXISTS idx_jobs_state ON jobs(state);
"""

_LEDGER_COLUMNS = ("userId", "jobId", "amount", "type", "reason", "originalTransactionId")


class SqliteBackend:
    """Shared connection + lock for the user store / ledger / job store."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.lock = threading.RLock()
        self.closed = False
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self) -> None:
        with self.lock:
            self.closed = True
            self.conn.close()


_BACKENDS: dict[str, SqliteBackend] = {}
_BACKENDS_LOCK = threading.Lock()


def get_backend(path: str) -> SqliteBackend:
    """Per-path backend singleton: the user store, ledger, and job store share
    one connection + writer lock, matching SQLite's single-writer model."""
    key = os.path.abspath(path)
    with _BACKENDS_LOCK:
        backend = _BACKENDS.get(key)
        if backend is None or backend.closed:
            backend = SqliteBackend(path)
            _BACKENDS[key] = backend
        return backend


class SqliteUserStore:
    """users.credits durable tier; drop-in for DurableUserStore."""

    def __init__(self, backend: SqliteBackend):
        self._b = backend

    def get_credits(self, user_id: str) -> int:
        with self._b.lock:
            row = self._b.conn.execute(
                "SELECT credits FROM users WHERE user_id = ?", (user_id,)
            ).fetchone()
        return int(row[0]) if row else 0

    def set_credits(self, user_id: str, balance: int) -> None:
        with self._b.lock:
            self._b.conn.execute(
                "INSERT INTO users (user_id, credits, last_updated) VALUES (?, ?, ?) "
                "ON CONFLICT(user_id) DO UPDATE SET credits = excluded.credits, "
                "last_updated = excluded.last_updated",
                (user_id, int(balance), time.time()),
            )
            self._b.conn.commit()

    def grant(self, user_id: str, amount: int) -> int:
        with self._b.lock:
            self._b.conn.execute(
                "INSERT INTO users (user_id, credits, last_updated) VALUES (?, ?, ?) "
                "ON CONFLICT(user_id) DO UPDATE SET credits = users.credits + ?, "
                "last_updated = excluded.last_updated",
                (user_id, int(amount), time.time(), int(amount)),
            )
            self._b.conn.commit()
            row = self._b.conn.execute(
                "SELECT credits FROM users WHERE user_id = ?", (user_id,)
            ).fetchone()
        return int(row[0])


class SqliteLedger:
    """credit_ledger audit trail; drop-in for Ledger."""

    def __init__(self, backend: SqliteBackend):
        self._b = backend

    def add(self, entry: dict) -> str:
        entry = dict(entry)
        entry_id = uuid.uuid4().hex
        extras = {k: v for k, v in entry.items() if k not in _LEDGER_COLUMNS}
        with self._b.lock:
            self._b.conn.execute(
                "INSERT INTO credit_ledger (id, user_id, job_id, amount, type, reason, "
                "original_transaction_id, extras, timestamp) VALUES (?,?,?,?,?,?,?,?,?)",
                (
                    entry_id,
                    entry.get("userId"),
                    entry.get("jobId"),
                    int(entry.get("amount", 0)),
                    entry.get("type", ""),
                    entry.get("reason"),
                    entry.get("originalTransactionId"),
                    json.dumps(extras) if extras else None,
                    time.time(),
                ),
            )
            self._b.conn.commit()
        return entry_id

    @staticmethod
    def _row_to_entry(row) -> dict:
        entry = {
            "id": row[0],
            "userId": row[1],
            "jobId": row[2],
            "amount": int(row[3]),
            "type": row[4],
            "reason": row[5],
            "timestamp": row[8],
        }
        if row[6]:
            entry["originalTransactionId"] = row[6]
        if row[7]:
            entry.update(json.loads(row[7]))
        return entry

    def find_deduction_by_job(self, job_id: str) -> dict | None:
        with self._b.lock:
            row = self._b.conn.execute(
                "SELECT * FROM credit_ledger WHERE job_id = ? AND amount < 0 "
                "ORDER BY timestamp LIMIT 1",
                (job_id,),
            ).fetchone()
        return self._row_to_entry(row) if row else None

    def entries(self) -> list[dict]:
        with self._b.lock:
            rows = self._b.conn.execute(
                "SELECT * FROM credit_ledger ORDER BY timestamp"
            ).fetchall()
        return [self._row_to_entry(r) for r in rows]


class SqliteJobStore(JobStore):
    """Durable job state machine over SQLite; drop-in for JobStore.

    The reference's spec persists the job record + state machine in a
    Firestore ``jobs`` collection (design.md:912-933, submit flow
    design.md:114-129). Here every mutation writes through to the shared
    SQLite file under the in-memory store's own lock, so a server restart
    preserves queued/running/completed jobs, billed credits stay attached to
    a recoverable job, and DLQ replay works across restarts. Reads, watcher
    wakeups (SSE), and the transition rules all stay in-process — the rows
    are the recovery source, loaded once at construction."""

    _COLUMNS = (
        "id, user_id, state, created_at, updated_at, attempts, version, "
        "payload, result, error, timings, traceparent, request_id"
    )

    def __init__(self, backend: SqliteBackend, **kwargs):
        self._b = backend
        super().__init__(**kwargs)
        self._load()

    def _load(self) -> None:
        with self._b.lock:
            rows = self._b.conn.execute(
                f"SELECT {self._COLUMNS} FROM jobs ORDER BY created_at, rowid"
            ).fetchall()
        with self._lock:
            for row in rows:
                job = self._row_to_job(row)
                self._jobs[job.id] = job
                self._order.append(job.id)

    @staticmethod
    def _row_to_job(row) -> Job:
        load = lambda v, default: json.loads(v) if v else default
        return Job(
            id=row[0],
            user_id=row[1],
            state=JobState(row[2]),
            created_at=row[3],
            updated_at=row[4],
            attempts=int(row[5]),
            version=int(row[6]),
            payload=load(row[7], {}),
            result=load(row[8], None),
            error=load(row[9], None),
            timings=load(row[10], {}),
            traceparent=row[11],
            request_id=row[12],
        )

    def _persist_locked(self, job: Job) -> None:
        dump = lambda v: json.dumps(v) if v else None
        with self._b.lock:
            self._b.conn.execute(
                f"INSERT OR REPLACE INTO jobs ({self._COLUMNS}) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    job.id,
                    job.user_id,
                    job.state.value,
                    job.created_at,
                    job.updated_at,
                    job.attempts,
                    job.version,
                    dump(job.payload),
                    dump(job.result),
                    dump(job.error),
                    dump(job.timings),
                    job.traceparent,
                    job.request_id,
                ),
            )
            self._b.conn.commit()

    def _delete_locked(self, job_id: str) -> None:
        with self._b.lock:
            self._b.conn.execute("DELETE FROM jobs WHERE id = ?", (job_id,))
            self._b.conn.commit()


def create_durable_tier(path: str | None = None):
    """(user_store, ledger) pair: SQLite when a path is configured
    (DURABLE_DB_PATH), otherwise the in-memory defaults."""
    path = path or os.environ.get("DURABLE_DB_PATH")
    if path:
        backend = get_backend(path)
        _log.info("Durable tier: sqlite", {"path": path})
        return SqliteUserStore(backend), SqliteLedger(backend)
    from .credits import DurableUserStore, Ledger

    return DurableUserStore(), Ledger()


def create_job_store(path: str | None = None, **kwargs) -> JobStore:
    """Job store on the same selection rule as the user/ledger tier: SQLite
    (durable, crash-recoverable) when DURABLE_DB_PATH is set, else in-memory."""
    path = path or os.environ.get("DURABLE_DB_PATH")
    if path:
        _log.info("Job store: sqlite", {"path": path})
        return SqliteJobStore(get_backend(path), **kwargs)
    return JobStore(**kwargs)
