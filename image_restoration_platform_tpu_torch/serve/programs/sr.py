"""Tiled super-resolution program.

Counterpart of the single-device program of
image_restoration_platform_tpu/serve/programs/sr.py
(``build_sr_tiled_program``): tile extraction, batched SRNet calls over tile
chunks and the windowed fold all run on the device, with no host round trip
between tiles. The residual limiter runs per tile, inside the model, as in
the reference. The mesh and row-sharded programs of that file belong to the
multi-device serving surfaces and are not part of this module yet.
"""

from __future__ import annotations

import torch

from ...models import get_family
from ...ops.tile import tiled_apply
from .egress import to_yuv420


def build_sr_tiled_program(
    family_name: str, *, dtype: torch.dtype, tile: int, overlap: int, tile_batch: int, output: str,
):
    """``fn(model, canvas [H,W,3] u8)`` -> the RGB u8 canvas at
    ``[H*scale, W*scale, 3]``, or with ``output="yuv420"`` its (Y, Cb, Cr)
    u8 planes."""
    if output not in ("rgb", "yuv420"):
        raise ValueError(f"unknown output {output!r}")
    scale = get_family(family_name).config.scale

    def program(model, canvas):
        def per_tiles(tiles):
            # the limiter's f32 output goes straight to the 255 scaling
            return model(tiles.to(dtype) / 255.0).float() * 255.0

        with torch.inference_mode():
            out = tiled_apply(
                canvas.float(), per_tiles, tile=tile, overlap=overlap, scale=scale, tile_batch=tile_batch,
            )
            if output == "yuv420":
                return tuple(p[0] for p in to_yuv420(out[None]))
            return torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)

    return program
