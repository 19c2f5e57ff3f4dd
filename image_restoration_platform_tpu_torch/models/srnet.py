"""SRNet — super-resolution backbone of the tiled 2K -> 4K path.

Counterpart of image_restoration_platform_tpu/models/srnet.py: conv stem ->
K residual blocks (conv-SiLU-conv, 0.2-scaled residuals) -> ``pre_up`` plus
the stem skip -> depth-to-space x``scale`` head, plus a global skip of the
nearest-upsampled input, then the residual spectral limiter. Module and
parameter names follow the JAX parameter tree (``stem``, ``blocks/<i>/conv1``,
``blocks/<i>/conv2``, ``pre_up``, ``up``), so a state dict from
``weights.params_from_jax`` loads with ``strict=True``.

The limiter and its parts (``upsample_tent``, ``local_detail``, ``_lowpass``,
``residual_limit``) are plain functions on NHWC tensors. Edge padding is
written as a concat of the repeated border, since ``F.pad`` has no replicate
mode for single axes of a channels-last 4-D tensor. ``apply_rowsharded`` is
the network on row blocks over the mesh's spatial slots
(``serve/programs/sr.py:build_sr_spatial_program``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from . import nn as L


@dataclass(frozen=True)
class SRNetConfig:
    scale: int = 2
    channels: int = 64
    num_blocks: int = 8
    in_channels: int = 3
    # Residual spectral limiter (``residual_limit``): the network's
    # correction over a tent (half-pel linear) upsample is split at a coarse
    # spatial cutoff of ``limit_pool`` output pixels. The low-frequency part
    # passes a soft-shrink deadband of ``limit_deadband`` levels; the
    # high-frequency part is clamped to +-(limit_floor + limit_quad * d^2)
    # levels, d = excess curvature of the input luma (``local_detail`` with
    # ``limit_kappa``), in levels. limit_pool = 0 disables the limiter.
    limit_pool: int = 32
    limit_deadband: float = 5.0  # levels (1/255)
    limit_floor: float = 1.0  # levels
    limit_quad: float = 0.2  # levels per squared level of excess curvature
    limit_kappa: float = 0.7  # gradient discount in the curvature statistic


def _tent_kernel(scale: int) -> list[float]:
    """Triangle taps that turn a nearest (repeat) upsample into exact
    half-pel linear interpolation: [1..s..1] / s^2."""
    taps = list(range(1, scale + 1)) + list(range(scale - 1, 0, -1))
    return [tap / float(scale * scale) for tap in taps]


def _pad_edge(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """Replicate-pad one axis of ``x`` by (before, after)."""
    parts = []
    if before:
        parts.append(x.narrow(dim, 0, 1).expand(*[before if d == dim else -1 for d in range(x.dim())]))
    parts.append(x)
    if after:
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        parts.append(last.expand(*[after if d == dim else -1 for d in range(x.dim())]))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


def _filter_axis(x: torch.Tensor, taps: list[float], dim: int) -> torch.Tensor:
    """Edge-replicated 1-D filter along ``dim`` by shifted adds, taps summed
    in order."""
    r = (len(taps) - 1) // 2
    size = x.shape[dim]
    p = _pad_edge(x, dim, r, r)
    out = taps[0] * p.narrow(dim, 0, size)
    for i in range(1, len(taps)):
        out = out + taps[i] * p.narrow(dim, i, size)
    return out


def upsample_tent(x: torch.Tensor, scale: int) -> torch.Tensor:
    """[N,H,W,C] -> [N,H*s,W*s,C] linear (tent) upsample, edge-replicated:
    repeat, then the separable tent filter along rows and along columns."""
    up = x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
    taps = _tent_kernel(scale)
    return _filter_axis(_filter_axis(up, taps, 1), taps, 2)


def local_detail(x: torch.Tensor, kappa: float = 0.0) -> torch.Tensor:
    """Per-pixel texture evidence of ``x`` [N,h,w,C] in [0,1] -> [N,h,w,1]:
    the 3x3 mean of the excess curvature of luma (edge-replicated),
    max(|Laplacian| - kappa * |central gradient|, 0), in f32. The luma is an
    f32 weighted sum, never a reduced-precision matrix product."""
    xf = x.float()
    luma = 0.299 * xf[..., 0] + 0.587 * xf[..., 1] + 0.114 * xf[..., 2]
    h, w = luma.shape[1], luma.shape[2]
    p = _pad_edge(_pad_edge(luma, 1, 1, 1), 2, 1, 1)
    up, down = p[:, :-2, 1:-1], p[:, 2:, 1:-1]
    left, right = p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    lap = torch.abs(4.0 * luma - up - down - left - right)
    if kappa > 0.0:
        gx = torch.abs(right - left) * 0.5
        gy = torch.abs(down - up) * 0.5
        lap = torch.clamp(lap - kappa * (gx + gy), min=0.0)
    p = _pad_edge(_pad_edge(lap, 1, 1, 1), 2, 1, 1)
    d = None
    for i in range(3):
        for j in range(3):
            piece = p[:, i : i + h, j : j + w]
            d = piece if d is None else d + piece
    return (d / 9.0)[..., None]


def _lowpass(r: torch.Tensor, pool: int) -> torch.Tensor:
    """Coarse low-pass at a ``pool``-pixel cutoff: one box pool (the input
    edge-padded at the bottom and right to a multiple of ``pool``), then
    log2(pool) iterated x2 tent upsamples, cropped back. The pyramid is the
    same filter as one ``upsample_tent(lo, pool)`` up to round-off, in
    3-tap stages at growing sizes instead of (2 * pool - 1) taps at full
    resolution."""
    if pool & (pool - 1) != 0:
        raise ValueError(f"limit_pool must be a power of 2, got {pool}")
    n, h, w, c = r.shape
    ph, pw = (-h) % pool, (-w) % pool
    rp = _pad_edge(_pad_edge(r, 1, 0, ph), 2, 0, pw)
    lo = rp.reshape(n, (h + ph) // pool, pool, (w + pw) // pool, pool, c).mean(dim=(2, 4))
    s = pool
    while s > 1:
        lo = upsample_tent(lo, 2)
        s //= 2
    return lo[:, :h, :w]


def residual_limit(x: torch.Tensor, out: torch.Tensor, config: SRNetConfig) -> torch.Tensor:
    """Spectral residual limiter over the tent-upsample baseline:

    ``out -> tent + softshrink(LF(out - tent), deadband)
            + clamp(HF(out - tent), +-(floor + quad * d^2))``

    f32 throughout and f32 out, whatever the type of ``x`` and ``out``:
    bf16's half-level step at mid-gray would re-quantize the bounded
    residual envelope. The caller multiplies the f32 result by 255 without
    casting back. With ``limit_pool <= 0`` it returns ``out`` unchanged."""
    c = config
    if c.limit_pool <= 0:
        return out
    tent = upsample_tent(x.float(), c.scale)
    r = out.float() - tent
    r_lf = _lowpass(r, c.limit_pool)
    r_hf = r - r_lf
    t = c.limit_deadband / 255.0
    r_lf = torch.sign(r_lf) * torch.clamp(r_lf.abs() - t, min=0.0)
    d_l = upsample_tent(local_detail(x, c.limit_kappa), c.scale) * 255.0
    m = (c.limit_floor + c.limit_quad * d_l * d_l) * (1.0 / 255.0)
    return tent + r_lf + torch.maximum(torch.minimum(r_hf, m), -m)


def receptive_halo(config: SRNetConfig = SRNetConfig()) -> int:
    """Receptive-field radius in input rows: stem (1) + num_blocks x two 3x3
    convs (2 each) + pre_up (1) + up (1)."""
    return 2 * config.num_blocks + 3


def apply_rowsharded(models: list["SRNet"], blocks: list[torch.Tensor]) -> list[torch.Tensor]:
    """The network WITHOUT the limiter on row blocks: [N, H_loc, W, 3] in
    [0, 1] on each spatial slot, ``models`` the network's copy on each slot
    -> [N, H_loc * scale, W * scale, 3] per slot. Every convolution
    exchanges its own one-row halo (``parallel.halo.conv2d_rowsharded``),
    so the stitched rows equal the unlimited forward of the whole image.
    The limiter is local in (input, output), so the spatial program applies
    ``residual_limit`` once to the gathered canvas instead."""
    from ..parallel.halo import conv2d_rowsharded

    c = models[0].config

    def conv(name, xs):
        return conv2d_rowsharded([m.get_submodule(name) for m in models], xs)

    h = conv("stem", blocks)
    feat = h
    for i in range(c.num_blocks):
        r = conv(f"blocks.{i}.conv2", [L.silu(a) for a in conv(f"blocks.{i}.conv1", feat)])
        feat = [f + 0.2 * b for f, b in zip(feat, r)]
    feat = [a + b for a, b in zip(conv("pre_up", feat), h)]
    up = conv("up", feat)
    return [L.pixel_shuffle(u, c.scale) + L.upsample_nearest(x, c.scale) for u, x in zip(up, blocks)]


class SRBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = L.Conv(ch, ch)
        self.conv2 = L.Conv(ch, ch)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return feat + 0.2 * self.conv2(L.silu(self.conv1(feat)))


class SRNet(nn.Module):
    def __init__(self, config: SRNetConfig = SRNetConfig()):
        super().__init__()
        c = self.config = config
        self.stem = L.Conv(c.in_channels, c.channels)
        self.blocks = nn.ModuleList(SRBlock(c.channels) for _ in range(c.num_blocks))
        self.pre_up = L.Conv(c.channels, c.channels)
        self.up = L.Conv(c.channels, c.in_channels * c.scale * c.scale)

    def init_(self, gen: torch.Generator) -> "SRNet":
        """Random weights from ``gen`` with the JAX package's scales; the
        zero upsampler head makes the untrained network nearest-neighbour SR."""
        self.stem.init_(gen)
        for block in self.blocks:
            block.conv1.init_(gen)
            block.conv2.init_(gen, scale=0.1)
        self.pre_up.init_(gen)
        with torch.no_grad():
            self.up.w.zero_()
            self.up.b.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] in [0,1] -> [N,H*scale,W*scale,3]; f32 when the limiter
        runs (``limit_pool > 0``), else x's type."""
        c = self.config
        h = self.stem(x)
        feat = h
        for block in self.blocks:
            feat = block(feat)
        feat = self.pre_up(feat) + h
        up = L.pixel_shuffle(self.up(feat), c.scale)
        out = up + L.upsample_nearest(x, c.scale)
        return residual_limit(x, out, c)
