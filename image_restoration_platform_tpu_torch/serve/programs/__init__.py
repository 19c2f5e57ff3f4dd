"""Device programs of the serving engine."""

from .egress import to_yuv420, to_yuv420_s2d
from .restore import build_restore_program

__all__ = ["build_restore_program", "to_yuv420", "to_yuv420_s2d"]
