"""3x3 stencils, separable gaussian blur and luma, byte-clamped like libvips.

Counterpart of image_restoration_platform_tpu/ops/stencil.py. Stencils are
shift-and-add over an edge-replicated pad, summed in the reference's term
order; outputs are rounded (half to even) and clamped to [0, 255], which the
classifier's score normalisations are calibrated to. Every function takes a
leading batch axis.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

K_LAPLACIAN8 = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], dtype=np.float32)
K_HIGHPASS9 = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], dtype=np.float32)
K_LAPLACIAN4 = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=np.float32)


def _shifted_stencil(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """3x3 stencil of [B, H, W] f32, edge-replicated."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    out = None
    for dy in range(3):
        for dx in range(3):
            kv = float(kernel[dy][dx])
            if kv == 0.0:
                continue
            term = kv * xp[..., dy : dy + h, dx : dx + w]
            out = term if out is None else out + term
    return out


def conv3x3_clamped_u8(gray: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    return torch.clamp(torch.round(_shifted_stencil(gray.float(), kernel)), 0.0, 255.0)


@lru_cache(maxsize=16)
def _gaussian_kernel_1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _blur_planes(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable blur of [B, C, H, W] planes, edge-replicated."""
    radius = (len(k) - 1) // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, radius, radius), mode="replicate")
    out = None
    for i, kv in enumerate(k):
        term = float(kv) * xp[..., i : i + h, :]
        out = term if out is None else out + term
    xp = F.pad(out, (radius, radius, 0, 0), mode="replicate")
    out = None
    for i, kv in enumerate(k):
        term = float(kv) * xp[..., i : i + w]
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of [B, H, W, C] f32, edge-replicated."""
    k = _gaussian_kernel_1d(float(sigma))
    x = img.float().permute(0, 3, 1, 2)
    return _blur_planes(x, k).permute(0, 2, 3, 1)


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma of [B, H, W, 3] byte-range images, rounded to bytes."""
    x = img.float()
    y = x[..., 0] * 0.2126 + x[..., 1] * 0.7152 + x[..., 2] * 0.0722
    return torch.clamp(torch.round(y), 0.0, 255.0)
