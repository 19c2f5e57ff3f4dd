"""Structured component loggers.

The reference uses pino with ``[component]``-prefixed messages and context
objects (context/clients.js:12-16); here the same shape rides on stdlib logging
with a JSON-ish context suffix. One-time warning latches (classifier.js:27-28)
are provided via ``warn_once``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_configured = False
_lock = threading.Lock()


def _configure_root() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
        root = logging.getLogger("irp")
        root.addHandler(handler)
        root.setLevel(_LEVELS.get(os.environ.get("LOG_LEVEL", "info").lower(), logging.INFO))
        root.propagate = False
        _configured = True


class ComponentLogger:
    """Logger with pino-style structured context: ``[component] msg {ctx}``."""

    def __init__(self, component: str):
        _configure_root()
        self.component = component
        self._logger = logging.getLogger(f"irp.{component}")
        self._warned: set[str] = set()

    def _fmt(self, message: str, ctx: dict | None) -> str:
        prefix = f"[{self.component}] {message}"
        if not ctx:
            return prefix
        try:
            return f"{prefix} {json.dumps(ctx, default=str)}"
        except (TypeError, ValueError):
            return f"{prefix} {ctx!r}"

    def debug(self, message: str, ctx: dict | None = None) -> None:
        self._logger.debug(self._fmt(message, ctx))

    def info(self, message: str, ctx: dict | None = None) -> None:
        self._logger.info(self._fmt(message, ctx))

    def warn(self, message: str, ctx: dict | None = None) -> None:
        self._logger.warning(self._fmt(message, ctx))

    warning = warn

    def error(self, message: str, ctx: dict | None = None) -> None:
        self._logger.error(self._fmt(message, ctx))

    def warn_once(self, key: str, message: str, ctx: dict | None = None) -> None:
        if key in self._warned:
            return
        self._warned.add(key)
        self.warn(message, ctx)


def get_logger(component: str) -> ComponentLogger:
    return ComponentLogger(component)
