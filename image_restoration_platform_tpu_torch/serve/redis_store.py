"""Networked Redis store backend.

Implements the MemoryStore interface (serve/store.py) over a real Redis
server, with the compound atomics as server-side Lua — the same scripts the
reference runs (token bucket redisClient.js:152-177, free-credit
INCR-with-limit credits.js:291-309, paid check-and-decrement
credits.js:346-366) — and the reference's *runtime degradation*: on a
connection error the store flips to an in-process MemoryStore replica and
``/health/ready`` reports the degraded mode (redisClient.js:228-232).

No third-party client library is assumed: a minimal RESP2 protocol client
over a TCP socket is provided (``RespClient``). It is intentionally small —
exactly the command surface the store uses.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
import time
from typing import Any
from urllib.parse import urlparse

from ..utils.logging import get_logger
from .store import MemoryStore, TakeResult

_log = get_logger("redis")


# --------------------------------------------------------------- RESP client


class RespError(Exception):
    """Server-side Redis error reply (-ERR ...)."""


class RespClient:
    """Minimal RESP2 client: inline pipelining-free request/response over one
    socket, thread-safe via a lock. Reconnects once per command on a dead
    socket; raises ConnectionError when the server is unreachable."""

    def __init__(self, host: str, port: int, db: int = 0, timeout: float = 2.0,
                 password: str | None = None):
        self.host = host
        self.port = port
        self.db = db
        self.timeout = timeout
        self.password = password
        self._lock = threading.RLock()
        self._sock: socket.socket | None = None
        self._buf = b""

    # ---- connection

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._buf = b""
        if self.password:
            self._roundtrip("AUTH", self.password)
        if self.db:
            self._roundtrip("SELECT", str(self.db))

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    # ---- wire format

    @staticmethod
    def _encode_command(args: tuple) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for arg in args:
            if isinstance(arg, bytes):
                data = arg
            elif isinstance(arg, (int, float)):
                data = repr(arg).encode()
            else:
                data = str(arg).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(data), data))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self) -> Any:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply() for _ in range(n)]
        raise ConnectionError(f"malformed RESP reply: {line!r}")

    def _roundtrip(self, *args) -> Any:
        self._sock.sendall(self._encode_command(args))
        return self._read_reply()

    # ---- public

    def command(self, *args) -> Any:
        """Issue one command. RespError (server-side) propagates; transport
        failures retry once on a fresh connection, then raise ConnectionError."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    return self._roundtrip(*args)
                except RespError:
                    raise
                except (OSError, ConnectionError) as error:
                    self.close()
                    if attempt:
                        raise ConnectionError(str(error)) from error


# ------------------------------------------------------------- Lua scripts
# Marker comments let lightweight test servers dispatch by script content,
# exactly how the reference's in-memory fallback emulates its Lua
# (redisClient.js:59-91).

TAKE_LUA = """-- irp:take
local tokens = redis.call('HGET', KEYS[1], 'tokens')
local reset = redis.call('HGET', KEYS[1], 'reset')
local limit = tonumber(ARGV[1])
local interval_ms = tonumber(ARGV[2])
local now_ms = tonumber(ARGV[3])
if (not reset) or tonumber(reset) <= now_ms then
  tokens = limit
  reset = now_ms + interval_ms
end
tokens = tonumber(tokens)
reset = tonumber(reset)
local allowed = 0
if tokens > 0 then
  allowed = 1
  tokens = tokens - 1
end
redis.call('HSET', KEYS[1], 'tokens', tokens, 'reset', reset)
redis.call('PEXPIRE', KEYS[1], reset - now_ms)
return {allowed, tokens, reset}
"""

INCR_WITH_LIMIT_LUA = """-- irp:incr_with_limit
local current = tonumber(redis.call('GET', KEYS[1]) or '0')
if current >= tonumber(ARGV[1]) then
  return 0
end
local new = redis.call('INCR', KEYS[1])
redis.call('EXPIRE', KEYS[1], ARGV[2])
return new
"""

CHECK_AND_DECREMENT_LUA = """-- irp:check_and_decrement
local current = tonumber(redis.call('GET', KEYS[1]) or '0')
local amount = tonumber(ARGV[1])
if current < amount then
  return {0, current}
end
local new = current - amount
redis.call('SET', KEYS[1], new, 'EX', ARGV[2])
return {1, new}
"""


# ---------------------------------------------------------- value encoding
# Redis stores byte strings; the MemoryStore interface stores arbitrary
# Python values. Integers are stored as plain ASCII digits so INCRBY and the
# Lua scripts operate on them natively; everything else is tagged.

_JSON_TAG = b"\x00j\x00"
_BYTES_TAG = b"\x00b\x00"


def _json_default(value):
    if isinstance(value, bytes):
        return {"__bytes_b64__": base64.b64encode(value).decode("ascii")}
    raise TypeError(f"unserializable value of type {type(value)!r}")


def _json_object_hook(obj):
    if "__bytes_b64__" in obj and len(obj) == 1:
        return base64.b64decode(obj["__bytes_b64__"])
    return obj


def encode_value(value: Any) -> bytes:
    if isinstance(value, bool):
        return _JSON_TAG + json.dumps(value).encode()
    if isinstance(value, int):
        return str(value).encode()
    if isinstance(value, bytes):
        return _BYTES_TAG + value
    return _JSON_TAG + json.dumps(value, default=_json_default).encode()


def decode_value(raw: bytes | None) -> Any:
    if raw is None:
        return None
    if raw.startswith(_BYTES_TAG):
        return raw[len(_BYTES_TAG):]
    if raw.startswith(_JSON_TAG):
        return json.loads(raw[len(_JSON_TAG):].decode(), object_hook=_json_object_hook)
    try:
        return int(raw)
    except ValueError:
        return raw.decode("utf-8", "replace")


# ----------------------------------------------------------------- store


class RedisStore:
    """MemoryStore-compatible store over Redis with runtime memory fallback.

    On the first transport failure every subsequent operation is served by an
    in-process MemoryStore replica (the reference's degradation flip,
    redisClient.js:228-232); ``get_mode()`` reports ``redis`` or
    ``memory-fallback`` so readiness can surface the degradation.
    """

    def __init__(self, url: str = "redis://localhost:6379/0", *,
                 client: RespClient | None = None,
                 clock=time.time, timeout: float = 2.0):
        if client is None:
            parsed = urlparse(url)
            db = int((parsed.path or "/0").lstrip("/") or 0)
            client = RespClient(
                parsed.hostname or "localhost",
                parsed.port or 6379,
                db=db,
                timeout=timeout,
                password=parsed.password,
            )
        self._client = client
        self._clock = clock
        self._fallback = MemoryStore(clock=clock)
        self._mode = "redis"
        self._lock = threading.Lock()

    # ---- degradation plumbing

    def _flip_to_fallback(self, error: Exception) -> None:
        with self._lock:
            if self._mode != "memory-fallback":
                self._mode = "memory-fallback"
                _log.error(
                    "Redis unavailable; degrading to in-memory store",
                    {"error": str(error)},
                )

    def _call(self, redis_op, fallback_op):
        if self._mode == "redis":
            try:
                return redis_op()
            except RespError:
                raise
            except (ConnectionError, OSError) as error:
                self._flip_to_fallback(error)
        return fallback_op()

    # ---- kv

    def get(self, key: str) -> Any:
        return self._call(
            lambda: decode_value(self._client.command("GET", key)),
            lambda: self._fallback.get(key),
        )

    def set(self, key: str, value: Any, ttl_seconds: float | None = None) -> None:
        def op():
            if ttl_seconds:
                self._client.command("SET", key, encode_value(value), "PX", int(ttl_seconds * 1000))
            else:
                self._client.command("SET", key, encode_value(value))
        return self._call(op, lambda: self._fallback.set(key, value, ttl_seconds))

    def set_if_absent(self, key: str, value: Any, ttl_seconds: float | None = None) -> bool:
        def op():
            args = ["SET", key, encode_value(value), "NX"]
            if ttl_seconds:
                args += ["PX", int(ttl_seconds * 1000)]
            return self._client.command(*args) == "OK"
        return self._call(op, lambda: self._fallback.set_if_absent(key, value, ttl_seconds))

    def delete(self, key: str) -> None:
        return self._call(
            lambda: self._client.command("DEL", key) and None,
            lambda: self._fallback.delete(key),
        )

    def incr(self, key: str) -> int:
        return self.incr_by(key, 1)

    def decr(self, key: str) -> int:
        return self.incr_by(key, -1)

    def incr_by(self, key: str, amount: int) -> int:
        return self._call(
            lambda: int(self._client.command("INCRBY", key, amount)),
            lambda: self._fallback.incr_by(key, amount),
        )

    def expire(self, key: str, ttl_seconds: float) -> None:
        return self._call(
            lambda: self._client.command("PEXPIRE", key, int(ttl_seconds * 1000)) and None,
            lambda: self._fallback.expire(key, ttl_seconds),
        )

    # ---- compound atomics (server-side Lua)

    def incr_with_limit(self, key: str, limit: int, ttl_seconds: float) -> int:
        return self._call(
            lambda: int(
                self._client.command(
                    "EVAL", INCR_WITH_LIMIT_LUA, 1, key, limit, int(ttl_seconds)
                )
            ),
            lambda: self._fallback.incr_with_limit(key, limit, ttl_seconds),
        )

    def check_and_decrement(self, key: str, amount: int, ttl_seconds: float) -> tuple[bool, int]:
        def op():
            ok, balance = self._client.command(
                "EVAL", CHECK_AND_DECREMENT_LUA, 1, key, amount, int(ttl_seconds)
            )
            return bool(ok), int(balance)
        return self._call(op, lambda: self._fallback.check_and_decrement(key, amount, ttl_seconds))

    # ---- token bucket

    def take(self, key: str, limit: int, interval_seconds: float) -> TakeResult:
        def op():
            now_ms = int(self._clock() * 1000)
            allowed, remaining, reset_ms = self._client.command(
                "EVAL", TAKE_LUA, 1, key, limit, int(interval_seconds * 1000), now_ms
            )
            return TakeResult(bool(allowed), int(remaining), float(reset_ms))
        return self._call(op, lambda: self._fallback.take(key, limit, interval_seconds))

    # ---- idempotency

    def set_idempotency(self, key: str, record: dict, ttl_seconds: float) -> None:
        self.set(f"idem:{key}", record, ttl_seconds)

    def get_idempotency(self, key: str) -> dict | None:
        return self.get(f"idem:{key}")

    # ---- health

    def ping(self) -> bool:
        try:
            return self._mode == "redis" and self._client.command("PING") == "PONG"
        except (ConnectionError, OSError, RespError) as error:
            self._flip_to_fallback(error)
            return False

    def get_mode(self) -> str:
        return self._mode

    def is_fallback(self) -> bool:
        return self._mode == "memory-fallback"
