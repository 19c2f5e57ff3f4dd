"""Degradation classification of the port (masked, batched, on the device)."""

from .classifier import DEGRADATION_ORDER, DEGRADATION_TYPES

__all__ = ["DEGRADATION_ORDER", "DEGRADATION_TYPES"]
