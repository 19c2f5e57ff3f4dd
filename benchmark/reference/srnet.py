"""The plain float32 reference of SRNet, the repository's EDSR-style SR
network, read from the shipped npz weights: its convolutions, pixel shuffle
and nearest-upsampled global skip, then the residual spectral limiter the
served program applies after the network. Nothing here imports the program.

A configuration names this module with ``"reference": "srnet"``
(``benchmark/spec.py:load_reference`` has the contract it keeps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.flops import conv_flops
from benchmark.reference.models import Precision, conv, pixel_shuffle


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


def network(p: dict, arch: dict, x: torch.Tensor, prec: Precision = Precision()) -> torch.Tensor:
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


def tile_flops(arch: dict, tile: int) -> int:
    """Operations of the network over one ``tile``-square input tile (the
    limiter is not counted)."""
    c, s = arch["channels"], arch["scale"]
    total = conv_flops(tile, tile, arch["in_channels"], c)
    total += arch["num_blocks"] * 2 * conv_flops(tile, tile, c, c)
    total += conv_flops(tile, tile, c, c)
    total += conv_flops(tile, tile, c, arch["in_channels"] * s * s)
    return total
