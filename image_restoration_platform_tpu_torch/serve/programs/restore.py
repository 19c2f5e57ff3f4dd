"""The restore program: masked classify -> conditioning -> gated deblock and
deblur -> backbone -> byte or YCbCr-plane egress.

Counterpart of image_restoration_platform_tpu/serve/programs/restore.py, run
eagerly under ``torch.inference_mode()`` (no ``torch.compile``, no CUDA
graphs). The SR families take the plain ``fn(model, imgs_u8)`` shape (no
conditioning); the diffusion family takes the unit-normal noise of its
sampler as a fifth argument and has RGB egress only. A program given a
``fires`` dict leaves the stages' per-image fire masks in it.
"""

from __future__ import annotations

import torch

from ...classify.fused import batch_classify_and_condition
from ...models import diffusion, get_family
from ...models import nn as mnn
from ...ops.deblock import deblock_and_recondition
from ...ops.deblur import deblur_and_recondition
from .egress import to_yuv420, to_yuv420_s2d

# the stages' fire masks a program reports, in the order the engine counts them
STAGE_FIRES = ("deblock", "deblur_veto", "deblur")


def build_restore_program(
    family_name: str,
    *,
    dtype: torch.dtype,
    use_s2d_io: bool,
    use_deblur: bool,
    use_deblock: bool,
    egress: str = "rgb",
):
    """``fn(model, canvas_u8 [N,B,B,3] u8, valid_hw [N,2] int32,
    is_jpeg_f [N] f32[, noise]) -> (out, scores [N,7])``, all tensors on the
    model's device. ``out`` is the RGB u8 canvas, or with ``egress="yuv420"``
    (standard restore families only) the (Y, Cb, Cr) u8 planes, or with
    ``egress="f32"`` (standard restore families only) the RGB output clipped
    to [0, 1] before its byte rounding, which the quality gates read. The
    keyword ``fires`` (a dict) receives the stages' [N] bool fire masks under
    ``STAGE_FIRES``' names. For an SR family: ``fn(model, imgs_u8
    [N,H,W,3]) -> [N,H*scale,W*scale,3] u8``."""
    if egress not in ("rgb", "yuv420", "f32"):
        raise ValueError(f"unknown egress {egress!r}")

    def stages(canvas_u8, valid_hw, is_jpeg_f, scores, cond, fires):
        stage_scores = scores
        if use_deblock:
            canvas_u8, stage_scores, cond = deblock_and_recondition(
                canvas_u8, valid_hw, is_jpeg_f, scores, cond, fires
            )
        if use_deblur:
            canvas_u8, cond = deblur_and_recondition(
                canvas_u8, valid_hw, is_jpeg_f, stage_scores, cond, fires
            )
        return canvas_u8, cond

    cfg = get_family(family_name).config

    if family_name.startswith("sr-"):

        def sr_program(model, imgs_u8):
            with torch.inference_mode():
                out = model(imgs_u8.to(dtype) / 255.0)
                return torch.clamp(torch.round(out.float() * 255.0), 0, 255).to(torch.uint8)

        return sr_program

    if family_name == "diffusion-restore":

        def diffusion_program(model, canvas_u8, valid_hw, is_jpeg_f, noise, fires=None):
            with torch.inference_mode():
                scores, cond = batch_classify_and_condition(canvas_u8.float(), valid_hw, is_jpeg_f)
                canvas_u8, cond = stages(canvas_u8, valid_hw, is_jpeg_f, scores, cond, fires)
                x = canvas_u8.to(dtype) / 255.0
                out = diffusion.restore(model, x, cond.to(dtype), noise, cfg)
                return torch.clamp(torch.round(out.float() * 255.0), 0, 255).to(torch.uint8), scores

        return diffusion_program

    s2d_scale = cfg.input_scale

    def program(model, canvas_u8, valid_hw, is_jpeg_f, fires=None):
        with torch.inference_mode():
            scores, cond = batch_classify_and_condition(canvas_u8.float(), valid_hw, is_jpeg_f)
            canvas_u8, cond = stages(canvas_u8, valid_hw, is_jpeg_f, scores, cond, fires)
            if use_s2d_io:
                x = mnn.space_to_depth(canvas_u8, s2d_scale).to(dtype) / 255.0
                out = model(x, cond.to(dtype), s2d_io=True)
                if egress == "yuv420":
                    return to_yuv420_s2d(out), scores
                if egress == "f32":
                    return mnn.pixel_shuffle(torch.clamp(out.float(), 0.0, 1.0), s2d_scale), scores
                out_u8 = torch.round(torch.clamp(out.float(), 0.0, 1.0) * 255.0).to(torch.uint8)
                return mnn.pixel_shuffle(out_u8, s2d_scale), scores
            x = canvas_u8.to(dtype) / 255.0
            out = torch.clamp(model(x, cond.to(dtype)).float(), 0.0, 1.0)
            if egress == "yuv420":
                return to_yuv420(out * 255.0), scores
            if egress == "f32":
                return out, scores
            return torch.round(out * 255.0).to(torch.uint8), scores

    return program
