"""The restore program: masked classify -> conditioning -> gated deblock and
deblur -> backbone -> byte or YCbCr-plane egress.

Counterpart of image_restoration_platform_tpu/serve/programs/restore.py. The
program is a chain of segments (serve/programs/segments.py), each of the
three stage decisions closing one:

- S0: classify, conditioning, and the deblock threshold and fire mask;
- S1: deblock apply-and-reclassify (or its pass-through), then the deblur
  evidence up to the veto's gate ``mot_ok``;
- S2: the directional-gradient veto (or its zeros), then the hypothesis
  choice up to ``fire_pre``;
- S3: the Wiener apply-and-reclassify (or its pass-through), then the
  backbone and the egress, and the stages' fire flags.

A stage that is off, or does not apply at the canvas size, has no piece, so
its segment joins the one before. Calling the program runs the segments
eagerly under ``torch.inference_mode()``; the engine's executable tier
(serve/exec_cache.py) captures each segment and branch as a CUDA graph.

The SR families take the plain ``fn(model, imgs_u8)`` shape (no
conditioning); the diffusion family takes the unit-normal noise of its
sampler as a fifth argument and has RGB egress only. A program given a
``fires`` dict leaves the stages' per-image fire masks in it.
``build_hdr_deblur_program`` is the 16-bit HDR pre-pass (ops/deblur.py
``deblur_canvas_f32``) in the same form, one decision (the veto) in it.
"""

from __future__ import annotations

import torch

from ...classify.fused import batch_classify_and_condition
from ...models import diffusion, get_family, is_sr_family
from ...models import nn as mnn
from ...models.folded import is_folded
from ...ops import deblock, deblur
from .egress import to_yuv420, to_yuv420_s2d
from .segments import Piece, Program

# the stages' fire masks a program reports, in the order the engine counts them
STAGE_FIRES = ("deblock", "deblur_veto", "deblur")
PLANES = ("out.y", "out.cb", "out.cr")


def fire_flags(fires: dict, rows: int, device: torch.device) -> torch.Tensor:
    """[rows, len(STAGE_FIRES)] u8 of the stages' fire masks (0 where a
    stage did not run)."""
    zeros = torch.zeros(rows, dtype=torch.bool, device=device)
    return torch.stack([fires.get(name, zeros) for name in STAGE_FIRES], dim=1).to(torch.uint8)


def _evidence(s: dict) -> dict:
    return {k[3:]: v for k, v in s.items() if k.startswith("ev.")}


def _hypothesis_pieces(gray_of, compression_of, enable_disk: bool) -> list[Piece]:
    """The deblur estimator as pieces: the evidence up to ``mot_ok``, the
    veto (a decision), and the choice up to ``fire_pre``."""

    def evidence(s):
        ev = deblur.hypothesis_evidence(gray_of(s), s["valid_hw"], compression_of(s), enable_disk=enable_disk)
        return {**{f"ev.{k}": v for k, v in ev.items()}, "fires.deblur_veto": ev["mot_ok"],
                "any.deblur_veto": ev["mot_ok"].any()}

    def veto(s):
        return {"ratio": deblur.veto_ratio(s["ev.crops"], s["ev.best_mot"])}

    def no_veto(s):
        crops = s["ev.crops"]
        return {"ratio": torch.zeros(crops.shape[0], dtype=crops.dtype, device=crops.device)}

    def choice(s):
        best, fire_pre = deblur.hypothesis_choice(_evidence(s), s["ratio"])
        return {"best": best, "fire_pre": fire_pre, "any.deblur": fire_pre.any()}

    return [Piece(evidence), Piece(veto, "deblur_veto", no_veto), Piece(choice)]


def stage_pieces(shape, *, use_deblock: bool, use_deblur: bool) -> list[Piece]:
    """Classify, conditioning and the gated stages on a ``canvas`` of
    ``shape``; they leave ``scores`` (the original classification),
    ``cond`` and ``canvas`` (after the stages) and the ``fires.*`` masks."""

    def classify(s):
        scores, cond = batch_classify_and_condition(s["canvas"].float(), s["valid_hw"], s["is_jpeg"])
        return {"scores": scores, "cond": cond}

    pieces = [Piece(classify)]
    if use_deblock and deblock.applies(shape):

        def decision(s):
            lam, fire = deblock.deblock_decision(s["canvas"], s["valid_hw"])
            return {"lam": lam, "fires.deblock": fire, "any.deblock": fire.any()}

        def apply(s):
            canvas, scores, cond = deblock.deblock_apply(
                s["canvas"], s["valid_hw"], s["is_jpeg"], s["scores"], s["cond"], s["lam"], s["fires.deblock"]
            )
            return {"canvas": canvas, "stage_scores": scores, "cond": cond}

        def keep(s):
            return {"canvas": s["canvas"], "stage_scores": s["scores"], "cond": s["cond"]}

        pieces += [Piece(decision), Piece(apply, "deblock", keep)]
    if use_deblur and deblur.applies(shape):

        def stage_scores(s):
            return s.get("stage_scores", s["scores"])

        def apply(s):
            canvas, cond, fire = deblur.deblur_apply(
                s["canvas"], s["valid_hw"], s["is_jpeg"], stage_scores(s), s["cond"], s["best"], s["fire_pre"]
            )
            return {"canvas": canvas, "cond": cond, "fires.deblur": fire}

        def keep(s):
            return {"canvas": s["canvas"], "cond": s["cond"], "fires.deblur": s["fire_pre"]}

        pieces += _hypothesis_pieces(
            lambda s: (s["canvas"].float() / 255.0).mean(dim=-1), lambda s: stage_scores(s)[:, 3], False
        )
        pieces.append(Piece(apply, "deblur", keep))
    return pieces


def check_layout(model, use_folded: bool) -> None:
    """Refuse a model (or list of replicas) whose layout is not the one the
    program was built for: a program's executable key carries the fold."""
    if is_folded(model) != use_folded:
        raise ValueError(f"the program was built for a {'folded' if use_folded else 'unfolded'} model")


def _flags(s: dict) -> dict:
    fires = {k.split(".", 1)[1]: v for k, v in s.items() if k.startswith("fires.")}
    return {"flags": fire_flags(fires, s["scores"].shape[0], s["scores"].device)}


def build_restore_program(
    family_name: str,
    *,
    dtype: torch.dtype,
    use_s2d_io: bool,
    use_deblur: bool,
    use_deblock: bool,
    egress: str = "rgb",
    use_folded: bool = False,
) -> Program:
    """``fn(model, canvas_u8 [N,B,B,3] u8, valid_hw [N,2] int32,
    is_jpeg_f [N] f32[, noise]) -> (out, scores [N,7])``, all tensors on the
    model's device. ``out`` is the RGB u8 canvas, or with ``egress="yuv420"``
    (standard restore families only) the (Y, Cb, Cr) u8 planes, or with
    ``egress="f32"`` (standard restore families only) the RGB output clipped
    to [0, 1] before its byte rounding, which the quality gates read. The
    keyword ``fires`` (a dict) receives the stages' [N] bool fire masks under
    ``STAGE_FIRES``' names. For an SR family: ``fn(model, imgs_u8
    [N,H,W,3]) -> [N,H*scale,W*scale,3] u8``. The flat outputs
    (``Program.outputs``) are the output tensors, ``scores`` and ``flags``
    ([N, 3] u8 of the fire masks). ``use_folded``: the program runs a W-folded
    model (models/folded.py), which has no space-to-depth IO, so its
    YCbCr planes come from the RGB output."""
    if egress not in ("rgb", "yuv420", "f32"):
        raise ValueError(f"unknown egress {egress!r}")
    if use_folded and use_s2d_io:
        raise ValueError("a folded model has no space-to-depth IO")
    cfg = get_family(family_name).config

    if is_sr_family(family_name):

        def sr_pieces(model, shapes):
            check_layout(model, use_folded)

            def sr(s):
                out = model(s["imgs"].to(dtype) / 255.0)
                return {"out": torch.clamp(torch.round(out.float() * 255.0), 0, 255).to(torch.uint8)}

            return [Piece(sr)]

        return Program(("imgs",), sr_pieces, ("out",))

    def result(outs):
        return (outs[0] if len(outs) == 3 else tuple(outs[:3])), outs[-2]

    if family_name == "diffusion-restore":

        def diffusion_pieces(model, shapes):
            check_layout(model, use_folded)

            def backbone(s):
                x = s["canvas"].to(dtype) / 255.0
                out = diffusion.restore(model, x, s["cond"].to(dtype), s["noise"], cfg)
                return {"out": torch.clamp(torch.round(out.float() * 255.0), 0, 255).to(torch.uint8)}

            stages = stage_pieces(shapes[0], use_deblock=use_deblock, use_deblur=use_deblur)
            return [*stages, Piece(backbone), Piece(_flags)]

        return Program(("canvas", "valid_hw", "is_jpeg", "noise"), diffusion_pieces, ("out", "scores", "flags"),
                       result)

    s2d_scale = cfg.input_scale

    def backbone(model, s):
        if use_s2d_io:
            x = mnn.space_to_depth(s["canvas"], s2d_scale).to(dtype) / 255.0
            out = model(x, s["cond"].to(dtype), s2d_io=True)
            if egress == "yuv420":
                return dict(zip(PLANES, to_yuv420_s2d(out)))
            if egress == "f32":
                return {"out": mnn.pixel_shuffle(torch.clamp(out.float(), 0.0, 1.0), s2d_scale)}
            out_u8 = torch.round(torch.clamp(out.float(), 0.0, 1.0) * 255.0).to(torch.uint8)
            return {"out": mnn.pixel_shuffle(out_u8, s2d_scale)}
        x = s["canvas"].to(dtype) / 255.0
        out = torch.clamp(model(x, s["cond"].to(dtype)).float(), 0.0, 1.0)
        if egress == "yuv420":
            return dict(zip(PLANES, to_yuv420(out * 255.0)))
        if egress == "f32":
            return {"out": out}
        return {"out": torch.round(out * 255.0).to(torch.uint8)}

    def restore_pieces(model, shapes):
        check_layout(model, use_folded)
        stages = stage_pieces(shapes[0], use_deblock=use_deblock, use_deblur=use_deblur)
        return [*stages, Piece(lambda s: backbone(model, s)), Piece(_flags)]

    outputs = (*PLANES, "scores", "flags") if egress == "yuv420" else ("out", "scores", "flags")
    return Program(("canvas", "valid_hw", "is_jpeg"), restore_pieces, outputs, result)


def build_hdr_deblur_program() -> Program:
    """``fn(None, x [N,B,B,3] f32 in [0, 1], valid_hw [N,2] int32,
    compression [N] f32)`` -> the deblurred canvases (ops/deblur.py
    ``deblur_canvas_f32`` with the disk channel on), as S0 (the evidence up
    to the veto's gate) and S1 (the veto or its zeros, the choice, the
    Wiener inversion and its backstop)."""

    def pieces(model, shapes):
        if not deblur.applies(shapes[0]):
            return [Piece(lambda s: {"out": s["x"]})]

        def wiener(s):
            return {"out": deblur.deblur_f32_apply(s["x"], s["valid_hw"], s["compression"], s["best"], s["fire_pre"])}

        hypothesis = _hypothesis_pieces(lambda s: s["x"].mean(dim=-1), lambda s: s["compression"], True)
        return [*hypothesis, Piece(wiener)]

    return Program(("x", "valid_hw", "compression"), pieces, ("out",))
