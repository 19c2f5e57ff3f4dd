"""Degradation classification of the port: the host-facing service and the
masked, batched classification of the restore program."""

from .classifier import DEGRADATION_ORDER, DEGRADATION_TYPES, ClassifierService, classify_scores

__all__ = ["ClassifierService", "DEGRADATION_ORDER", "DEGRADATION_TYPES", "classify_scores"]
