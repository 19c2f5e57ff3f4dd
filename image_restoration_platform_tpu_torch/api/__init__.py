"""HTTP API of the port. ``AppContext`` (the service graph) imports without
aiohttp; ``create_app`` and ``main`` load the aiohttp layer when first used."""

from .context import AppContext

__all__ = ["AppContext", "create_app", "main"]


def __getattr__(name: str):
    if name in ("create_app", "main"):
        from . import app

        return getattr(app, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
