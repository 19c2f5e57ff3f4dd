"""Prompt text and host conditioning for the restore response."""

from .enhancer import (
    COND_DIM,
    DEGRADATION_TEMPLATES,
    PromptEnhancerService,
    conditioning_vector,
    create_prompt_enhancer_service,
    validate_degradation,
)

__all__ = [
    "COND_DIM",
    "DEGRADATION_TEMPLATES",
    "PromptEnhancerService",
    "conditioning_vector",
    "create_prompt_enhancer_service",
    "validate_degradation",
]
