"""Serving layer of the port: engine, micro-batcher, restorator."""

from .batcher import MicroBatcher
from .engine import RestorationEngine, resolve_device
from .restorator import RestoratorService

__all__ = ["MicroBatcher", "RestorationEngine", "RestoratorService", "resolve_device"]
