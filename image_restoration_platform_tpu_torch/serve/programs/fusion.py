"""Multi-image fusion program: restore K aligned exposures and composite
them in one device program.

Counterpart of image_restoration_platform_tpu/serve/programs/fusion.py. It
has no deblock, deblur or space-to-depth stage, as in the reference."""

from __future__ import annotations

import torch

from ...classify.fused import batch_classify_and_condition
from .restore import check_layout
from .segments import Piece, Program


def build_fusion_program(family_name: str, *, dtype: torch.dtype, use_folded: bool = False):
    """``fn(model, canvas [K,B,B,3] u8, valid_hw, is_jpeg_f)`` ->
    (fused [B,B,3] u8, scores [K,7]).

    Each image is classified and restored, then blended with per-image
    weights from its degradation scores: cleaner inputs (low blur, noise and
    lowLight) dominate the composite. One segment (no stage decision).
    ``use_folded``: the program runs a W-folded model (models/folded.py)."""

    def pieces(model, shapes):
        check_layout(model, use_folded)

        def run(s):
            scores, cond = batch_classify_and_condition(s["canvas"].float(), s["valid_hw"], s["is_jpeg"])
            x = s["canvas"].to(dtype) / 255.0
            restored = torch.clamp(model(x, cond.to(dtype)).float(), 0.0, 1.0)
            quality = 1.0 - (scores[:, 0] + scores[:, 1] + scores[:, 2]) / 3.0
            weights = torch.softmax(4.0 * quality.float(), dim=0)
            fused = (weights[:, None, None, None] * restored).sum(dim=0)
            return {"fused": torch.round(torch.clamp(fused, 0.0, 1.0) * 255.0).to(torch.uint8), "scores": scores}

        return [Piece(run)]

    return Program(("canvas", "valid_hw", "is_jpeg"), pieces, ("fused", "scores"))
