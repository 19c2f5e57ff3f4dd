"""Separable resize as two f32 matrix products on the device (Lanczos3,
Lanczos2, Mitchell / bicubic, triangle, box).

Counterpart of image_restoration_platform_tpu/ops/resize.py: the 1-D
sampling operators W_h [out_h, in_h] and W_w [out_w, in_w] are built on the
host (numpy, cached; the filter support widens when minifying), then

    out[oh, ow, c] = sum_ih sum_iw  W_h[oh, ih] * img[ih, iw, c] * W_w[ow, iw]

runs as two ``torch.matmul``s, rows first, on the device the caller names.
The reference pins these products to full f32 (``precision=HIGHEST``); on
the card TF32 stays off for them. Also ``fit_inside``, the serving edge's
`fit: inside, withoutEnlargement` resize math.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _lanczos(x: np.ndarray, a: int) -> np.ndarray:
    x = np.abs(x)
    out = np.where(
        x < 1e-8,
        1.0,
        np.where(x < a, a * np.sin(np.pi * x) * np.sin(np.pi * x / a) / (np.pi * np.pi * x * x), 0.0),
    )
    return out


def _mitchell(x: np.ndarray, b: float = 1 / 3, c: float = 1 / 3) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    out = np.where(
        x < 1,
        ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)) / 6,
        np.where(
            x < 2,
            ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6,
            0.0,
        ),
    )
    return out


def _triangle(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.clip(1.0 - x, 0.0, None)


def _box(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


_FILTERS: dict[str, tuple] = {
    "lanczos3": (lambda x: _lanczos(x, 3), 3.0),
    "lanczos2": (lambda x: _lanczos(x, 2), 2.0),
    "bicubic": (_mitchell, 2.0),
    "mitchell": (_mitchell, 2.0),
    "bilinear": (_triangle, 1.0),
    "box": (_box, 0.5),
}


@lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, method: str = "lanczos3") -> np.ndarray:
    """Dense 1-D resampling operator [out_size, in_size], rows sum to 1."""
    if method not in _FILTERS:
        raise ValueError(f"unknown resize method: {method}")
    kernel, support = _FILTERS[method]

    scale = in_size / out_size
    # widen the filter when minifying (anti-aliasing)
    filter_scale = max(scale, 1.0)
    sup = support * filter_scale

    out_centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    in_coords = np.arange(in_size, dtype=np.float64)
    # [out, in] distances in filter units
    dist = (out_centers[:, None] - in_coords[None, :]) / filter_scale
    weights = np.where(np.abs(out_centers[:, None] - in_coords[None, :]) <= sup, kernel(dist), 0.0)
    norm = weights.sum(axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    weights = weights / norm
    return weights.astype(np.float32)


def resize(
    img,
    out_hw: tuple[int, int],
    method: str = "lanczos3",
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Resize an [H, W] / [H, W, C] / [N, H, W, C] array or tensor to
    ``out_hw`` on ``device``; returns f32 on that device."""
    from ..serve.engine import resolve_device

    device = resolve_device(device)
    out_h, out_w = out_hw
    # copy in the input's own type (u8 is a quarter of f32), convert on the device
    x = (img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))).to(device)
    x = x.to(torch.float32)
    batched = x.ndim == 4
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    if not batched:
        x = x[None]

    n, in_h, in_w, c = x.shape
    if (in_h, in_w) != (out_h, out_w):
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, as the reference pins
        wh = torch.from_numpy(resize_matrix(in_h, out_h, method)).to(device)
        ww = torch.from_numpy(resize_matrix(in_w, out_w, method)).to(device)
        # rows first: [n,H,W,c] -> [n,out_h,W,c], then columns -> [n,out_h,out_w,c]
        x = torch.matmul(wh, x.reshape(n, in_h, in_w * c)).reshape(n, out_h, in_w, c)
        x = torch.matmul(ww, x.permute(0, 2, 1, 3).reshape(n, in_w, out_h * c))
        x = x.reshape(n, out_w, out_h, c).permute(0, 2, 1, 3)

    if not batched:
        x = x[0]
    if squeeze:
        x = x[:, :, 0]
    return x


def fit_inside(width: int, height: int, max_dim: int) -> tuple[int, int]:
    """`fit: inside, withoutEnlargement` resize math."""
    if width <= 0 or height <= 0:
        return width, height
    scale = max_dim / max(width, height)
    if scale >= 1.0:
        return width, height
    return max(1, round(width * scale)), max(1, round(height * scale))


def resize_u8(img, out_hw: tuple[int, int], method: str = "lanczos3", device: str | torch.device = "cuda") -> torch.Tensor:
    """Resize and clamp back to byte range (f32 values 0..255 on ``device``)."""
    return torch.clamp(torch.round(resize(img, out_hw, method, device=device)), 0.0, 255.0)
