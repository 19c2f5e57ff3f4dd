"""Host resize math of the serving edge (copied from
image_restoration_platform_tpu/ops/resize.py; the device resizes are not
on the restore path)."""

from __future__ import annotations


def fit_inside(width: int, height: int, max_dim: int) -> tuple[int, int]:
    """`fit: inside, withoutEnlargement` resize math."""
    if width <= 0 or height <= 0:
        return width, height
    scale = max_dim / max(width, height)
    if scale >= 1.0:
        return width, height
    return max(1, round(width * scale)), max(1, round(height * scale))
