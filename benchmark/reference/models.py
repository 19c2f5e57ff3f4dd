"""What every tiled reference network shares: the precision it computes
in, SAME convolutions in XLA's padding, the pixel shuffle, the shipped npz
weights read into float32 tensors, and the tiled upscale that runs a
configuration's network over overlapping tiles and blends them under a
Hann window as the 2K -> 4K path serves it.

The network itself is the configuration's own module
(``benchmark/reference/<name>.py``, found by ``spec.load_reference``).
``Precision`` selects the type it computes in: float32 for the reference,
or float8 (e4m3 with a per-tensor scale on every product's input and
weight) for the control. Nothing here imports the program.
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


def tile_starts(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, stride)) + [size - tile]
    return list(dict.fromkeys(starts))


def hann_window(t: int) -> np.ndarray:
    n = np.arange(t, dtype=np.float64)
    w = np.maximum(0.5 - 0.5 * np.cos(2.0 * np.pi * (n + 0.5) / t), 1e-3)
    return (w[:, None] * w[None, :]).astype(np.float32)


def sr_tiled(network, p: dict, arch: dict, canvas: torch.Tensor, prec: Precision = Precision(),
             chunk: int = 8) -> torch.Tensor:
    """One u8 canvas [H,W,3] -> the f32 [H*s,W*s,3] canvas in byte range:
    overlapping tiles through ``network`` (a reference module's
    ``network(p, arch, x, prec)``), composited under a Hann window
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
        out = network(p, arch, torch.stack([x[y : y + tile, xx : xx + tile] for y, xx in part]), prec) * 255.0
        for (y, xx), o in zip(part, out):
            acc[y * s : (y + tile) * s, xx * s : (xx + tile) * s] += o * win
            wacc[y * s : (y + tile) * s, xx * s : (xx + tile) * s] += win
    return acc / wacc
