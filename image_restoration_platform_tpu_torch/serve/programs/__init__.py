"""Device programs of the serving engine."""

from .egress import to_yuv420, to_yuv420_s2d
from .fusion import build_fusion_program
from .restore import build_hdr_deblur_program, build_restore_program
from .segments import Piece, Program, Segment
from .sr import build_sr_spatial_program, build_sr_tiled_mesh_program, build_sr_tiled_program

__all__ = [
    "Piece", "Program", "Segment", "build_fusion_program", "build_hdr_deblur_program", "build_restore_program",
    "build_sr_spatial_program", "build_sr_tiled_mesh_program", "build_sr_tiled_program", "to_yuv420",
    "to_yuv420_s2d",
]
