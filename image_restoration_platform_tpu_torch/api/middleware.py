"""aiohttp middleware chain: the reference's Express pipeline, same order and
semantics (server.js:27-58): request context -> timing -> security headers ->
auth -> rate limit -> idempotency -> problem+json error envelope.
"""

from __future__ import annotations

import time
import uuid

from aiohttp import web

from ..obs.metrics import record_request_duration
from ..problem import Problem, internal_error, not_found, unauthorized
from ..utils.logging import get_logger
from .context import AppContext

_log = get_logger("http")


def problem_response(problem: Problem, request_id: str | None) -> web.Response:
    body = problem.to_body(request_id)
    headers = {
        "X-Request-Id": request_id or body["instance"],
        "Cache-Control": "no-store",
        **problem.headers,
    }
    return web.json_response(
        body, status=problem.status, headers=headers, content_type="application/problem+json"
    )


@web.middleware
async def request_context_middleware(request: web.Request, handler):
    """X-Request-Id generate/echo + W3C traceparent/tracestate passthrough
    (requestContext.js:7-32)."""
    header_id = (request.headers.get("X-Request-Id") or "").strip()
    request_id = header_id or str(uuid.uuid4())
    request["requestId"] = request_id
    request["traceparent"] = request.headers.get("traceparent")
    request["tracestate"] = request.headers.get("tracestate")

    response = await handler(request)
    response.headers.setdefault("X-Request-Id", request_id)
    if request["traceparent"]:
        response.headers.setdefault("traceparent", request["traceparent"])
    if request["tracestate"]:
        response.headers.setdefault("tracestate", request["tracestate"])
    return response


@web.middleware
async def timing_middleware(request: web.Request, handler):
    """Wall-clock per request -> sampler + spec'd counters
    (http_requests_total / http_request_duration_ms, design.md:1583-1630)."""
    from ..obs.metrics import get_counters

    start = time.perf_counter()
    status = 500
    try:
        response = await handler(request)
        status = response.status
        return response
    finally:
        duration_ms = (time.perf_counter() - start) * 1000.0
        record_request_duration(duration_ms)
        counters = get_counters()
        counters.inc("http_requests_total")
        if status >= 500:
            counters.inc("http_requests_errors_total")
        counters.gauge("http_request_duration_ms", round(duration_ms, 3))


@web.middleware
async def security_headers_middleware(request: web.Request, handler):
    """Helmet-equivalent headers (securityHeaders.js:5-52); connect-src is
    extended by NEXT_PUBLIC_API_URL (securityHeaders.js:20-22) and CORS is
    granted to FRONTEND_URL (server.js:35-42)."""
    import os

    response = await handler(request)
    connect_src = "'self'"
    api_url = os.environ.get("NEXT_PUBLIC_API_URL")
    if api_url:
        connect_src += f" {api_url}"
    response.headers.setdefault(
        "Content-Security-Policy",
        f"default-src 'self'; img-src 'self' data: blob:; connect-src {connect_src}",
    )
    response.headers.setdefault("Strict-Transport-Security", "max-age=15552000; includeSubDomains")
    response.headers.setdefault("X-Content-Type-Options", "nosniff")
    response.headers.setdefault("X-Frame-Options", "DENY")
    response.headers.setdefault("Cross-Origin-Opener-Policy", "same-origin")
    response.headers.setdefault("Cross-Origin-Resource-Policy", "same-origin")

    origin = request.headers.get("Origin")
    allowed = os.environ.get("FRONTEND_URL")
    if origin and allowed and origin.rstrip("/") == allowed.rstrip("/"):
        response.headers["Access-Control-Allow-Origin"] = origin
        response.headers["Access-Control-Allow-Headers"] = (
            "Authorization, Content-Type, Idempotency-Key, X-Request-Id"
        )
        response.headers["Access-Control-Allow-Methods"] = "GET, POST, PUT, OPTIONS"
    return response


@web.middleware
async def error_middleware(request: web.Request, handler):
    """RFC 7807 envelope for every error path (utils/problem.js:48-73)."""
    request_id = request.get("requestId")
    try:
        return await handler(request)
    except Problem as problem:
        return problem_response(problem, request_id)
    except web.HTTPRequestEntityTooLarge:
        from ..problem import file_too_large

        return problem_response(file_too_large(10), request_id)
    except web.HTTPNotFound:
        return problem_response(not_found(), request_id)
    except web.HTTPMethodNotAllowed as error:
        # the catch-all OPTIONS preflight route makes unmatched paths resolve
        # with allowed={OPTIONS}; surface those as 404, real mismatches as 405
        allowed = {m.upper() for m in (error.allowed_methods or set())}
        if allowed <= {"OPTIONS"}:
            return problem_response(not_found(), request_id)
        return problem_response(
            Problem(
                title="Method Not Allowed",
                status=405,
                detail=f"Allowed methods: {', '.join(sorted(allowed))}.",
            ),
            request_id,
        )
    except web.HTTPException:
        raise
    except Exception as error:  # noqa: BLE001
        _log.error("Unhandled exception", {"requestId": request_id, "error": str(error)})
        return problem_response(internal_error(), request_id)


def auth_middleware_factory(ctx: AppContext, verifier=None, authorize=None):
    """Bearer auth with pluggable verification (firebaseAuth.js:57-134
    semantics: ``optional`` paths pass through, ``authorize`` hook gates with
    403). Without a real identity backend the mock token scheme applies:
    ``dev-user-<id>`` (firebaseAuth.js:43-55).

    ``verifier(token) -> user dict`` raises/returns None on invalid tokens;
    ``authorize(user, request) -> bool`` denies with a 403 problem.
    """

    def default_verifier(token: str):
        if token.startswith("dev-user-"):
            user_id = token.split("-", 2)[2] or "mock-user"
            return {
                "id": user_id,
                "email": f"{user_id}@example.dev",
                "tokenSource": "mock",
            }
        return None

    verify = verifier or default_verifier

    @web.middleware
    async def auth_middleware(request: web.Request, handler):
        if not (request.path.startswith("/v1") or request.path.startswith("/api")):
            return await handler(request)
        if request.method == "OPTIONS" or request.path.startswith("/v1/webhooks"):
            # webhooks authenticate by signature, not bearer token
            return await handler(request)

        header = request.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            raise unauthorized("Missing bearer token.")
        token = header[len("Bearer ") :].strip()
        try:
            user = verify(token)
        except Exception:
            user = None
        if user is None:
            raise unauthorized("Invalid or unverifiable token.")
        if authorize is not None and not authorize(user, request):
            from ..problem import forbidden

            raise forbidden()
        request["user"] = user
        return await handler(request)

    return auth_middleware


def rate_limit_middleware_factory(ctx: AppContext):
    @web.middleware
    async def rate_limit_middleware(request: web.Request, handler):
        if not request.path.startswith("/v1"):
            return await handler(request)
        user = request.get("user") or {}
        headers, problem = ctx.rate_limiter.check(user.get("id"), request.remote)
        if problem is not None:
            problem.headers.update(headers)
            raise problem
        response = await handler(request)
        for key, value in headers.items():
            response.headers.setdefault(key, value)
        return response

    return rate_limit_middleware


async def _request_fingerprint(request: web.Request) -> str:
    """sha256 over method + url + payload (idempotency.js:9-23).

    Multipart bodies are hashed over their *parsed* fields — the raw bytes
    contain a per-request random boundary, which would defeat replay.
    ``request.post()`` caches its result, so the downstream handler parses for
    free; file cursors are rewound after hashing.
    """
    import hashlib

    h = hashlib.sha256()
    h.update(request.method.encode())
    h.update(request.path_qs.encode())

    content_type = request.content_type or ""
    if content_type.startswith("multipart/") or content_type == "application/x-www-form-urlencoded":
        form = await request.post()
        for key in sorted(form.keys()):
            for value in form.getall(key):
                h.update(key.encode())
                if hasattr(value, "file"):
                    h.update(value.file.read())
                    value.file.seek(0)
                else:
                    h.update(str(value).encode())
    else:
        h.update(await request.read())
    return h.hexdigest()


def idempotency_middleware_factory(ctx: AppContext):
    """UUID Idempotency-Key gate + 24h replay on POST /v1 (idempotency.js)."""

    @web.middleware
    async def idempotency_middleware(request: web.Request, handler):
        if request.method != "POST" or not request.path.startswith("/v1"):
            return await handler(request)
        if request.path.startswith("/v1/webhooks"):
            # webhook providers retry with their own event ids, not our header
            return await handler(request)

        key = request.headers.get("Idempotency-Key")
        problem = ctx.idempotency.validate_key(key)
        if problem is not None:
            raise problem

        fingerprint = await _request_fingerprint(request)
        cached, conflict = ctx.idempotency.lookup(key, fingerprint)
        if conflict is not None:
            raise conflict
        if cached is not None:
            response = web.Response(
                status=cached.status, body=cached.body, content_type=cached.content_type
            )
            for header, value in cached.headers.items():
                if header.lower() not in ("content-type", "content-length"):
                    response.headers[header] = value
            response.headers["Idempotency-Replayed"] = "true"
            return response

        response = await handler(request)
        body_bytes = response.body if isinstance(response.body, bytes) else bytes(response.body or b"")
        ctx.idempotency.record(
            key,
            fingerprint,
            response.status,
            dict(response.headers),
            body_bytes,
            response.content_type or "application/json",
        )
        return response

    return idempotency_middleware
