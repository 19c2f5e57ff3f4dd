"""Degradation classification of the port: the host-facing service and the
masked, batched classification of the restore program."""

from .classifier import (
    DEGRADATION_ORDER,
    DEGRADATION_TYPES,
    ClassifierService,
    classify_scores,
    create_classifier_service,
    scores_to_vector,
)

__all__ = [
    "ClassifierService",
    "DEGRADATION_ORDER",
    "DEGRADATION_TYPES",
    "classify_scores",
    "create_classifier_service",
    "scores_to_vector",
]
