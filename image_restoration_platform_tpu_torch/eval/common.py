"""Helpers of the eval tools, copied from scripts/eval_quality.py and the
serving fixture of tests/test_quality_ood.py.

``psnr``, ``per_image_psnr``, ``gain_stats`` (damage rows are those with an
input PSNR under 48 dB) and ``smooth_batch`` are the scripts' own, on numpy
arrays (tensors are copied to the host first). ``serving_forward`` is the
engine's restore program, which the OOD gates read: round to a u8 canvas,
classify, deblock, deblur, re-condition, then the backbone in the compute
type, clipped to [0, 1] in f32. ``load_model`` builds a family with its
shipped weights on a device, conv and dense weights in the compute type, as
the engine does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..classify.fused import batch_classify_and_condition
from ..config import ServingConfig
from ..models import get_family
from ..models import weights as W
from ..models.folded import is_folded
from ..models.nn import cast_for_compute
from ..serve.engine import resolve_device, uses_s2d_io
from ..serve.programs import build_restore_program

DAMAGE_PSNR_MAX = 48.0  # rows above this are identity rows, not damage

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def host(a) -> np.ndarray:
    """``a`` as a host f32 array (a tensor on any device, or an array)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def psnr(a, b) -> float:
    mse = float(np.mean(np.square(host(a) - host(b))))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-10)))


def per_image_psnr(a, b) -> np.ndarray:
    mse = np.maximum(np.mean(np.square(host(a) - host(b)), axis=(1, 2, 3)), 1e-10)
    return 10.0 * np.log10(1.0 / mse)


def gain_stats(pin_rows, pout_rows, damage_only=True):
    """(mean per-image gain over damage rows, aggregate-equivalent gain,
    number of rows used)."""
    pin_rows = np.concatenate(pin_rows)
    pout_rows = np.concatenate(pout_rows)
    sel = pin_rows < DAMAGE_PSNR_MAX if damage_only else np.ones_like(pin_rows, bool)
    used = int(sel.sum())
    mean_gain = float(np.mean(pout_rows[sel] - pin_rows[sel])) if used else 0.0
    # aggregate over every row (the legacy metric), from per-image mse means
    mse_in = np.mean(10.0 ** (-pin_rows / 10.0))
    mse_out = np.mean(10.0 ** (-pout_rows / 10.0))
    agg = 10.0 * np.log10(max(mse_in, 1e-10) / max(mse_out, 1e-10))
    return mean_gain, float(agg), used


def smooth_batch(seed, n, size) -> np.ndarray:
    """Low-frequency-only surfaces (cosine gratings + ramp; no legitimate
    texture): the anti-hallucination axis of the quality table."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        for _ in range(4):
            fx, fy = rng.uniform(-2.5, 2.5, 2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.04, 0.18)
            g = amp * np.cos(2 * np.pi * (fx * xx + fy * yy) + ph)
            img += g[..., None] * rng.uniform(0.3, 1.0, 3)
        a, b = rng.uniform(-0.3, 0.3, 2)
        img += (a * xx + b * yy)[..., None] * rng.uniform(0.5, 1.0, 3)
        out[i] = np.clip(img + 0.35, 0.0, 1.0)
    return out


def tensor(a, device) -> torch.Tensor:
    """``a`` (a tensor, or an array, which is copied) as f32 on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


def load_model(family_name: str, device, dtype: torch.dtype, weights_dir: str | None = None) -> torch.nn.Module:
    """The family's module with its weights from ``weights_dir`` (default:
    IRP_WEIGHTS_DIR, else weights/) on ``device``; raises when the weights
    file is missing (an eval of random weights says nothing)."""
    device = resolve_device(device)
    path = W.weights_path(family_name, weights_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shipped weights for {family_name} at {path}")
    model = get_family(family_name).build()
    model.load_state_dict(W.load_state_dict(path), strict=True)
    model = cast_for_compute(model, dtype, channels_last=device.type == "cuda")
    return model.to(device).eval()


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def serving_forward(family, model, degraded_f32, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The engine's own restore program (serve/programs/restore.py, with the
    deblock and deblur stages and the default engine's space-to-depth IO, or
    none for a W-folded ``model``) on
    [N, S, S, 3] f32 inputs in [0, 1] rounded to a u8 canvas: classify ->
    deblock -> spectral deblur -> re-condition -> backbone in ``dtype``. It
    reads the program's ``f32`` egress, the output clipped to [0, 1] before
    its byte rounding, as the reference's OOD gates read theirs; rounded to
    bytes it is the engine's served output."""
    name = getattr(family, "name", family)
    if name.startswith("sr-") or name == "diffusion-restore":
        raise ValueError(f"serving_forward runs the restore UNet families, not {name}")
    folded = is_folded(model)
    program = build_restore_program(name, dtype=dtype, use_folded=folded,
                                    use_s2d_io=not folded and uses_s2d_io(name, ServingConfig()),
                                    use_deblur=True, use_deblock=True, egress="f32")
    device = model_device(model)
    x = tensor(degraded_f32, device)
    n, s = x.shape[0], x.shape[1]
    valid = torch.tensor([[s, s]], dtype=torch.int32, device=device).repeat(n, 1)
    is_jpeg = torch.ones((n,), dtype=torch.float32, device=device)
    canvas_u8 = torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)
    return program(model, canvas_u8, valid, is_jpeg)[0]


def classified_forward(model, x_f32, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The backbone conditioned by the classifier on the unrounded input
    (the near-clean and real-photo gates' path: no stages)."""
    device = model_device(model)
    x = tensor(x_f32, device)
    n, s = x.shape[0], x.shape[1]
    valid = torch.tensor([[s, s]], dtype=torch.int32, device=device).repeat(n, 1)
    with torch.inference_mode():
        _scores, cond = batch_classify_and_condition(x * 255.0, valid, torch.ones((n,), device=device))
        pred = model(x.to(dtype), cond.to(dtype))
        return torch.clamp(pred.float(), 0.0, 1.0)


def device_args(parser: argparse.ArgumentParser) -> None:
    """``--device`` (default cuda: no card raises unless ``--device cpu``),
    ``--dtype`` (default bfloat16, the serving type) and ``--weights-dir``
    (default: IRP_WEIGHTS_DIR, else weights/)."""
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--weights-dir", default=None, help="directory of <family>.npz (default: IRP_WEIGHTS_DIR, "
                        "else weights/)")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
