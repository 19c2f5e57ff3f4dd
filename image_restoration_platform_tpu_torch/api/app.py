"""aiohttp application factory + server entry point.

Counterpart of image_restoration_platform_tpu/api/app.py: secrets gate ->
service graph -> middleware chain -> routes. ``main`` serves on the card
(``python -m image_restoration_platform_tpu_torch.api``); ``main(device="cpu")``
serves on the CPU.
"""

from __future__ import annotations

import asyncio

from aiohttp import web

from ..config import Config, assert_required_secrets, load_config
from ..utils.logging import get_logger
from .context import AppContext
from .middleware import (
    auth_middleware_factory,
    error_middleware,
    idempotency_middleware_factory,
    rate_limit_middleware_factory,
    request_context_middleware,
    security_headers_middleware,
    timing_middleware,
)
from .routes import setup_routes

_log = get_logger("server")


def _env_verifier():
    """Real JWT/JWKS verifier when AUTH_JWKS_* is configured; None keeps the
    dev mock token scheme (firebaseAuth.js fallback semantics)."""
    from .auth import create_verifier_from_env

    return create_verifier_from_env()


def create_app(ctx: AppContext | None = None, config: Config | None = None) -> web.Application:
    config = config or load_config()
    ctx = ctx or AppContext(config=config)

    app = web.Application(
        client_max_size=config.upload.max_file_size_bytes + 64 * 1024,
        middlewares=[
            request_context_middleware,
            timing_middleware,
            error_middleware,          # inside request-context so problems echo X-Request-Id
            security_headers_middleware,
            auth_middleware_factory(ctx, verifier=_env_verifier()),
            rate_limit_middleware_factory(ctx),
            idempotency_middleware_factory(ctx),
        ],
    )
    app["ctx"] = ctx
    setup_routes(app)

    async def on_shutdown(app: web.Application) -> None:
        # graceful queue drain on SIGTERM (SURVEY.md section 5)
        await asyncio.to_thread(ctx.shutdown)

    app.on_shutdown.append(on_shutdown)
    return app


def main(device: str = "cuda") -> None:
    import os

    config = load_config()
    assert_required_secrets()
    ctx = AppContext(config=config, device=device)
    warmup = os.environ.get("SERVE_WARMUP", "")
    if warmup:
        # SERVE_WARMUP=256,512 picks the size buckets to warm before accepting
        # traffic; SERVE_WARMUP_FAMILIES widens coverage beyond the flagship:
        # a comma list of family names plus the pseudo-surface "fusion", or
        # "all" for every registered family + fusion — so the first SR, tiled
        # SR, fusion, or diffusion request never pays the kernels' builds and
        # cuDNN's plan searches.
        sizes = tuple(int(s) for s in warmup.split(",") if s)
        fam_env = os.environ.get("SERVE_WARMUP_FAMILIES", "")
        if fam_env.strip().lower() == "all":
            from ..models import list_families

            families = tuple(list_families()) + ("fusion",)
        elif fam_env:
            families = tuple(f.strip() for f in fam_env.split(",") if f.strip())
        else:
            families = ("restore-unet",)
        _log.info(
            "Warming serving executables", {"buckets": list(sizes), "families": list(families)}
        )
        report = ctx.engine.warmup_serving(families=families, sizes=sizes)
        _log.info("Warmup report", {k: round(v, 2) for k, v in report.items()})
    app = create_app(ctx=ctx, config=config)
    _log.info("Starting server", {"port": config.port})
    web.run_app(app, port=config.port, print=None)


if __name__ == "__main__":
    main()
