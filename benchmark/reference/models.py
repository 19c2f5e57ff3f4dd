"""The plain float32 reference of the served SR network, read from the
shipped npz weights with NumPy: SRNet with its residual spectral limiter,
tiled and Hann-blended as the 2K -> 4K path serves it.

``Precision`` selects the type the network computes in: float32 for the
reference, or float8 (e4m3 with a per-tensor scale on every convolution's
input and weight) for the control. Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    """``net``: "f32" or "fp8" (emulated: every tensor the network reads or
    returns rounded to float8 e4m3 after a per-tensor scale to its range,
    products summed in f32). ``aux``: the type of the float32 work around
    the network (the residual limiter)."""

    net: str = "f32"
    aux: torch.dtype = torch.float32

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.net == "f32":
            return t
        if self.net != "fp8":
            raise ValueError(f"unknown precision {self.net!r}")
        amax = t.abs().amax().clamp(min=1e-12)
        scale = FP8_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def load_npz(path: str, device) -> dict[str, torch.Tensor]:
    """The npz's '/'-keyed arrays as f32 tensors: conv kernels HWIO -> OIHW."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            arr = np.asarray(data[key], dtype=np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def _pads(size, kernel, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, prec: Precision, stride=1):
    """SAME conv (XLA's padding) of NHWC x with OIHW w."""
    xc = prec.q(x).permute(0, 3, 1, 2)
    ph, pw = _pads(xc.shape[2], w.shape[2], stride), _pads(xc.shape[3], w.shape[3], stride)
    xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    out = F.conv2d(xc, prec.q(w), None, stride).permute(0, 2, 3, 1)
    return out if b is None else out + b


def pixel_shuffle(x, r):
    n, h, w, c = x.shape
    return x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


def upsample_nearest(x, r):
    return x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)


def _pad_edge(x, dim, before, after):
    parts = [x.narrow(dim, 0, 1).expand(*[before if d == dim else -1 for d in range(x.dim())])] if before else []
    parts.append(x)
    if after:
        parts.append(x.narrow(dim, x.shape[dim] - 1, 1).expand(*[after if d == dim else -1 for d in range(x.dim())]))
    return torch.cat(parts, dim=dim)


def _filter_axis(x, taps, dim):
    r = (len(taps) - 1) // 2
    size = x.shape[dim]
    p = _pad_edge(x, dim, r, r)
    out = taps[0] * p.narrow(dim, 0, size)
    for i in range(1, len(taps)):
        out = out + taps[i] * p.narrow(dim, i, size)
    return out


def upsample_tent(x, s):
    taps = [t / float(s * s) for t in list(range(1, s + 1)) + list(range(s - 1, 0, -1))]
    return _filter_axis(_filter_axis(upsample_nearest(x, s), taps, 1), taps, 2)


def local_detail(x, kappa):
    luma = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    h, w = luma.shape[1], luma.shape[2]
    p = _pad_edge(_pad_edge(luma, 1, 1, 1), 2, 1, 1)
    up, down, left, right = p[:, :-2, 1:-1], p[:, 2:, 1:-1], p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    lap = torch.abs(4.0 * luma - up - down - left - right)
    if kappa > 0.0:
        lap = torch.clamp(lap - kappa * (torch.abs(right - left) * 0.5 + torch.abs(down - up) * 0.5), min=0.0)
    p = _pad_edge(_pad_edge(lap, 1, 1, 1), 2, 1, 1)
    d = None
    for i in range(3):
        for j in range(3):
            piece = p[:, i : i + h, j : j + w]
            d = piece if d is None else d + piece
    return (d / 9.0)[..., None]


def _lowpass(r, pool):
    n, h, w, c = r.shape
    ph, pw = (-h) % pool, (-w) % pool
    rp = _pad_edge(_pad_edge(r, 1, 0, ph), 2, 0, pw)
    lo = rp.reshape(n, (h + ph) // pool, pool, (w + pw) // pool, pool, c).mean(dim=(2, 4))
    s = pool
    while s > 1:
        lo = upsample_tent(lo, 2)
        s //= 2
    return lo[:, :h, :w]


def residual_limit(x, out, arch):
    s = arch["scale"]
    tent = upsample_tent(x, s)
    r = out - tent
    r_lf = _lowpass(r, arch["limit_pool"])
    r_hf = r - r_lf
    t = arch["limit_deadband"] / 255.0
    r_lf = torch.sign(r_lf) * torch.clamp(r_lf.abs() - t, min=0.0)
    d_l = upsample_tent(local_detail(x, arch["limit_kappa"]), s) * 255.0
    m = (arch["limit_floor"] + arch["limit_quad"] * d_l * d_l) / 255.0
    return tent + r_lf + torch.maximum(torch.minimum(r_hf, m), -m)


def srnet(p: dict, arch: dict, x: torch.Tensor, prec: Precision = Precision()) -> torch.Tensor:
    """x [N,h,w,3] in [0,1] -> [N,h*s,w*s,3], the limiter applied."""
    x = prec.q(x)
    h = conv(x, p["stem/w"], p["stem/b"], prec)
    feat = h
    for i in range(arch["num_blocks"]):
        r = conv(F.silu(conv(feat, p[f"blocks/{i}/conv1/w"], p[f"blocks/{i}/conv1/b"], prec)),
                 p[f"blocks/{i}/conv2/w"], p[f"blocks/{i}/conv2/b"], prec)
        feat = feat + 0.2 * r
    feat = conv(feat, p["pre_up/w"], p["pre_up/b"], prec) + h
    out = prec.q(pixel_shuffle(conv(feat, p["up/w"], p["up/b"], prec), arch["scale"]) + upsample_nearest(x, arch["scale"]))
    if arch["limit_pool"] <= 0:
        return out
    return residual_limit(x.to(prec.aux), out.to(prec.aux), arch).float()


def tile_starts(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, stride)) + [size - tile]
    return list(dict.fromkeys(starts))


def hann_window(t: int) -> np.ndarray:
    n = np.arange(t, dtype=np.float64)
    w = np.maximum(0.5 - 0.5 * np.cos(2.0 * np.pi * (n + 0.5) / t), 1e-3)
    return (w[:, None] * w[None, :]).astype(np.float32)


def sr_tiled(p: dict, arch: dict, canvas: torch.Tensor, prec: Precision = Precision(), chunk: int = 8) -> torch.Tensor:
    """One u8 canvas [H,W,3] -> the f32 [H*s,W*s,3] canvas in byte range:
    overlapping tiles through SRNet, composited under a Hann window
    normalised by the summed window."""
    tile, overlap, s = arch["tile"], arch["overlap"], arch["scale"]
    h, w, _ = canvas.shape
    ys, xs = tile_starts(h, tile, tile - overlap), tile_starts(w, tile, tile - overlap)
    x = canvas.float() / 255.0
    win = torch.from_numpy(hann_window(tile * s)).to(canvas.device)[:, :, None]
    acc = torch.zeros((h * s, w * s, 3), device=canvas.device)
    wacc = torch.zeros((h * s, w * s, 1), device=canvas.device)
    starts = [(y, xx) for y in ys for xx in xs]
    for i in range(0, len(starts), chunk):
        part = starts[i : i + chunk]
        out = srnet(p, arch, torch.stack([x[y : y + tile, xx : xx + tile] for y, xx in part]), prec) * 255.0
        for (y, xx), o in zip(part, out):
            acc[y * s : (y + tile) * s, xx * s : (xx + tile) * s] += o * win
            wacc[y * s : (y + tile) * s, xx * s : (xx + tile) * s] += win
    return acc / wacc
