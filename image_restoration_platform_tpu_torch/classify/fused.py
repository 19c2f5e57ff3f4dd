"""Masked classification + conditioning on the device, batched.

Counterpart of image_restoration_platform_tpu/classify/fused.py: the seven
degradation scores over each canvas's valid (unpadded) region, and the
28-dim conditioning vector (threshold 0.3, top-3 by confidence, severity
low/medium/high). ``vmap`` there is a leading batch axis here.
"""

from __future__ import annotations

import torch

from ..ops.stencil import (
    K_HIGHPASS9,
    K_LAPLACIAN4,
    K_LAPLACIAN8,
    conv3x3_clamped_u8,
    gaussian_blur,
    grayscale,
)

N_TYPES = 7
_SCRATCH_THRESHOLD = 200.0
# photometric rows (lowLight, fade, colorShift) of the score vector
PHOTOMETRIC = (0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 1.0)

_photometric: dict = {}


def photometric_on(device: torch.device) -> torch.Tensor:
    """PHOTOMETRIC as an f32 tensor on ``device``, uploaded on first use: a
    program captured as a CUDA graph may not copy from the host, and
    outside a capture the copy would be a hidden synchronisation."""
    key = str(device)
    if key not in _photometric:
        _photometric[key] = torch.tensor(PHOTOMETRIC).to(device)
    return _photometric[key]


def _valid_mask(b: int, h: int, w: int, valid_hw: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(h, device=valid_hw.device)[None, :, None]
    cols = torch.arange(w, device=valid_hw.device)[None, None, :]
    return ((rows < valid_hw[:, 0, None, None]) & (cols < valid_hw[:, 1, None, None])).float()


def _masked_var(x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    mean = (x * mask).sum(dim=(1, 2)) / count
    return ((x - mean[:, None, None]) ** 2 * mask).sum(dim=(1, 2)) / count


def masked_classify_scores(
    img: torch.Tensor,       # [B, H, W, 3] f32 in byte range (edge-padded canvas)
    valid_hw: torch.Tensor,  # [B, 2] int
    is_jpeg: torch.Tensor,   # [B] f32 (0/1)
) -> torch.Tensor:
    """[B, 7] scores over the valid region, DEGRADATION_ORDER layout."""
    b, h, w, _ = img.shape
    gray = grayscale(img)
    mask = _valid_mask(b, h, w, valid_hw)
    count = (valid_hw[:, 0] * valid_hw[:, 1]).float()

    lap8 = conv3x3_clamped_u8(gray, K_LAPLACIAN8)
    hp9 = conv3x3_clamped_u8(gray, K_HIGHPASS9)
    lap4 = conv3x3_clamped_u8(gray, K_LAPLACIAN4)

    blur = torch.clamp(1.0 - torch.clamp(_masked_var(lap8, mask, count) / 1000.0, max=1.0), min=0.0)
    noise = torch.clamp(torch.sqrt(_masked_var(hp9, mask, count)) / 50.0, max=1.0)

    mask3 = mask[..., None]
    ch_mean = (img * mask3).sum(dim=(1, 2)) / count[:, None]
    ch_var = ((img - ch_mean[:, None, None, :]) ** 2 * mask3).sum(dim=(1, 2)) / count[:, None]
    ch_std = torch.sqrt(ch_var)

    brightness = ch_mean.mean(dim=-1) / 255.0
    low_light = torch.where(
        brightness < 0.3, torch.clamp((0.3 - brightness) * 2.0, max=1.0), torch.zeros_like(brightness)
    )

    blurred = torch.clamp(torch.round(gaussian_blur(img, 1.0)), 0.0, 255.0)
    count3 = count * 3.0

    def var3(a):
        mean = (a * mask3).sum(dim=(1, 2, 3)) / count3
        return ((a - mean[:, None, None, None]) ** 2 * mask3).sum(dim=(1, 2, 3)) / count3

    compression = torch.clamp(torch.clamp(var3(img) - var3(blurred), min=0.0) / 500.0, max=1.0) * is_jpeg

    over = (lap4 > _SCRATCH_THRESHOLD) & (mask > 0)
    right = torch.zeros_like(over)
    right[:, :, :-1] = over[:, :, 1:]
    down = torch.zeros_like(over)
    down[:, :-1, :] = over[:, 1:, :]
    pairs = (over & right)[:, ::4, ::4].float().sum(dim=(1, 2)) + (over & down)[:, ::4, ::4].float().sum(
        dim=(1, 2)
    )
    scratch = torch.clamp(pairs / 1000.0, max=1.0)

    colorfulness = torch.clamp(torch.sqrt((ch_std[:, :3] ** 2).sum(dim=-1)) / 255.0, max=1.0)
    contrast = torch.clamp(ch_std.mean(dim=-1) / 64.0, max=1.0)
    fade = torch.clamp((1.0 - colorfulness) * 0.6 + (1.0 - contrast) * 0.4, max=1.0)

    avg_mean = ch_mean[:, :3].mean(dim=-1)
    deviation = torch.where(
        avg_mean > 0.0,
        (ch_mean[:, :3] - avg_mean[:, None]).abs().amax(dim=-1) / avg_mean,
        torch.zeros_like(avg_mean),
    )
    color_shift = torch.clamp(deviation * 2.0, max=1.0)

    return torch.stack([blur, noise, low_light, compression, scratch, fade, color_shift], dim=-1)


def conditioning_from_scores(scores: torch.Tensor) -> torch.Tensor:
    """[B, 7] scores -> [B, 28]: the raw scores, then a (type, severity)
    one-hot scaled by the score for the top-3 eligible types."""
    eligible = scores > 0.3
    ranked = torch.where(eligible, scores, torch.full_like(scores, -1.0))
    order = torch.argsort(-ranked, dim=-1, stable=True)  # descending; ineligible sink
    selected = torch.zeros_like(eligible).scatter(-1, order[:, :3], True) & eligible
    sev_idx = torch.where(
        scores >= 0.7,
        torch.full_like(scores, 2, dtype=torch.long),
        torch.where(scores >= 0.5, torch.ones_like(scores, dtype=torch.long), torch.zeros_like(scores, dtype=torch.long)),
    )
    sev_onehot = torch.nn.functional.one_hot(sev_idx, 3).float()  # [B, 7, 3]
    onehot = sev_onehot * (scores * selected.float())[..., None]
    return torch.cat([scores, onehot.reshape(scores.shape[0], -1)], dim=-1)


def batch_classify_and_condition(canvas_f32, valid_hw, is_jpeg_f):
    """[B,H,W,3], [B,2] int, [B] f32 -> (scores [B,7], cond [B,28])."""
    scores = masked_classify_scores(canvas_f32, valid_hw, is_jpeg_f)
    return scores, conditioning_from_scores(scores)
