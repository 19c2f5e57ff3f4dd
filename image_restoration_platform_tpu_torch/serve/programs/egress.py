"""Device-side egress: RGB model output -> JPEG-ready YCbCr 4:2:0 u8 planes.

Counterpart of image_restoration_platform_tpu/serve/programs/egress.py:
full-range BT.601 with 2x2 box chroma subsampling, rounded half to even
after the clip. The planes are 1.5 B/px device->host instead of 3 B/px RGB.
"""

from __future__ import annotations

import torch


def _u8(v: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(v, 0.0, 255.0)).to(torch.uint8)


def to_yuv420_s2d(out_s2d: torch.Tensor):
    """Space-to-depth model output [N,h,w,12] in [0,1] -> (Y [N,2h,2w],
    Cb [N,h,w], Cr [N,h,w]) u8. One s2d pixel's four (ph, pw) phase groups
    are the 2x2 chroma block, so chroma is the transform of their mean."""
    n, h, w, _ = out_s2d.shape
    p = torch.clamp(out_s2d.float(), 0.0, 1.0).reshape(n, h, w, 4, 3) * 255.0
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y_ph = 0.299 * r + 0.587 * g + 0.114 * b  # [N,h,w,4] (ph, pw) order
    y = y_ph.reshape(n, h, w, 2, 2).permute(0, 1, 3, 2, 4).reshape(n, 2 * h, 2 * w)
    rm, gm, bm = r.mean(dim=3), g.mean(dim=3), b.mean(dim=3)
    cb = 128.0 - 0.168735892 * rm - 0.331264108 * gm + 0.5 * bm
    cr = 128.0 + 0.5 * rm - 0.418687589 * gm - 0.081312411 * bm
    return _u8(y), _u8(cb), _u8(cr)


def to_yuv420(out_f32: torch.Tensor):
    """[N,H,W,3] float RGB in [0,255] -> (Y [N,H,W], Cb, Cr [N,H/2,W/2]) u8."""
    r, g, b = out_f32[..., 0], out_f32[..., 1], out_f32[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    n, h, w = y.shape
    cbs = cb.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    crs = cr.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    return _u8(y), _u8(cbs), _u8(crs)
