"""Prompt text for the restore response (host)."""

from .enhancer import PromptEnhancerService

__all__ = ["PromptEnhancerService"]
