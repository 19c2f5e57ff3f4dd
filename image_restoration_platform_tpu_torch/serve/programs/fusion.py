"""Multi-image fusion program: restore K aligned exposures and composite
them in one device program.

Counterpart of image_restoration_platform_tpu/serve/programs/fusion.py. It
has no deblock, deblur or space-to-depth stage, as in the reference."""

from __future__ import annotations

import torch

from ...classify.fused import batch_classify_and_condition


def build_fusion_program(family_name: str, *, dtype: torch.dtype):
    """``fn(model, canvas [K,B,B,3] u8, valid_hw, is_jpeg_f)`` ->
    (fused [B,B,3] u8, scores [K,7]).

    Each image is classified and restored, then blended with per-image
    weights from its degradation scores: cleaner inputs (low blur, noise and
    lowLight) dominate the composite."""

    def program(model, canvas, valid_hw, is_jpeg_f):
        with torch.inference_mode():
            scores, cond = batch_classify_and_condition(canvas.float(), valid_hw, is_jpeg_f)
            x = canvas.to(dtype) / 255.0
            restored = torch.clamp(model(x, cond.to(dtype)).float(), 0.0, 1.0)
            quality = 1.0 - (scores[:, 0] + scores[:, 1] + scores[:, 2]) / 3.0
            weights = torch.softmax(4.0 * quality.float(), dim=0)
            fused = (weights[:, None, None, None] * restored).sum(dim=0)
            fused_u8 = torch.round(torch.clamp(fused, 0.0, 1.0) * 255.0).to(torch.uint8)
            return fused_u8, scores

    return program
