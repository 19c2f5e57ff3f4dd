"""Synthetic degradation training data, generated on the device.

Counterpart of image_restoration_platform_tpu/train/data.py. Clean procedural
images are degraded by simulable analogs of the classifier's seven
degradation types (blur / noise / lowLight / compression / scratch / fade /
colorShift), and the conditioning vector comes from running the *serving
classifier* (classify/fused.py) on the degraded result, because at serving
time the model only sees classifier-estimated scores.

Randomness comes from one ``torch.Generator`` on the device, consumed in a
fixed order, in place of the reference's split JAX keys: the distributions
are the same, the numbers differ. ``jax.random.dirichlet(ones(4))`` is
normalised Exp(1) draws, ``jax.image.resize(..., "linear")`` upsampling is
``F.interpolate(mode="bilinear", align_corners=False)`` (both sample at half
pixel centres and clamp at the edges), and ``jnp.round`` / ``torch.round``
both round half to even. ``_degrade`` draws everything it needs first
(``_degrade_draws``) and then applies the degradations deterministically
(``_apply_degradations``), so a test can hand it the reference's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..classify.fused import batch_classify_and_condition
from ..ops.stencil import gaussian_blur


@dataclass(frozen=True)
class DataConfig:
    """The reference's DataConfig, field for field (the history of each
    field is in its comments there)."""

    size: int = 128
    channels: int = 3
    max_blur_sigma: float = 3.0
    max_noise_std: float = 0.15
    max_dark_gain: float = 0.75  # brightness multiplier reduction
    max_fade: float = 0.7
    max_shift: float = 0.25
    # rich natural-statistics cleans (fractal, shapes, gratings, strokes)
    rich: bool = True
    # fraction of examples kept fully clean (identity / no-harm training)
    clean_fraction: float = 0.15
    # photographic-physics distribution: flat/saturated content families and
    # PSF blur, signal-dependent noise, DCT compression, vignette low light
    photo: bool = False
    # deconvolution emphasis (needs photo): strong-tail blur/compression
    # strengths, full PSF convolution from strength 0.6, the dense PSF bank,
    # the DCT analog at 75 %
    deconv: bool = False
    # aperiodic micro-texture cleans in the photo mix
    grain: bool = False
    # texture-free smooth cleans in the photo mix, with their share
    smooth: bool = False
    smooth_share: float = 0.10
    # fraction of examples forced to a compression-only active mask
    compression_solo: float = 0.0
    # fraction of examples forced to a lowLight-only active mask
    lowlight_solo: float = 0.0


# ------------------------------------------------------------------ draws


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _dirichlet_ones(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """Dirichlet(1, ..., 1) rows: normalised Exp(1) draws."""
    e = -torch.log1p(-torch.rand((n, k), generator=gen, device=gen.device))
    return e / e.sum(dim=-1, keepdim=True)


def upsample_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N,h,w,C] -> [N,size,size,C], linear with half-pixel centres and
    edge clamping: ``jax.image.resize(x, ..., "linear")`` for upsampling."""
    up = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


# ---------------------------------------------------------- clean images


def _random_clean(gen, n, size, channels):
    """Procedural 'natural-ish' clean images: mixtures of smooth gradients,
    gaussian blobs and a little texture, in [0, 1]."""
    dev = gen.device
    yy = torch.linspace(0.0, 1.0, size, device=dev)[None, :, None, None]
    xx = torch.linspace(0.0, 1.0, size, device=dev)[None, None, :, None]
    a = _uniform(gen, (n, 1, 1, channels))
    b = _uniform(gen, (n, 1, 1, channels))
    base = a * yy + b * xx

    # gaussian blobs
    centers = _uniform(gen, (n, 4, 2))
    amps = _uniform(gen, (n, 4, channels), -0.5, 0.8)
    widths = _uniform(gen, (n, 4, 1), 0.05, 0.3)
    yy_b = torch.linspace(0.0, 1.0, size, device=dev)[None, None, :, None]
    xx_b = torch.linspace(0.0, 1.0, size, device=dev)[None, None, None, :]
    d2 = (yy_b - centers[:, :, 0:1, None]) ** 2 + (xx_b - centers[:, :, 1:2, None]) ** 2
    blobs = torch.einsum("nbhw,nbc->nhwc", torch.exp(-d2 / (2 * widths[:, :, :, None] ** 2 + 1e-4)), amps)
    img = base * 0.5 + 0.4 + blobs * 0.4
    # faint texture: a clean image must not saturate the classifier's noise score
    texture = _uniform(gen, (n, size, size, channels), -0.025, 0.025)
    return torch.clamp(img + texture, 0.0, 1.0)


def _fractal_noise(gen, n, size, channels):
    """Multi-octave value noise with a random per-image spectral slope (the
    1/f^beta power spectrum of natural photographs)."""
    beta = _uniform(gen, (n, 1, 1, 1), 1.0, 1.6)
    total = None
    octave = 4
    # stop at size/2: the finest octave would be pixel-level white noise
    while octave <= size // 2:
        up = upsample_linear(_normal(gen, (n, octave, octave, channels)), size)
        amp = (4.0 / octave) ** beta
        total = up * amp if total is None else total + up * amp
        octave *= 2
    return total


def _soft_shapes(gen, n, size, channels, k=4):
    """Random soft-edged rectangles/ellipses: flat regions bounded by edges."""
    dev = gen.device
    yy = torch.linspace(0.0, 1.0, size, device=dev)[None, None, :, None]
    xx = torch.linspace(0.0, 1.0, size, device=dev)[None, None, None, :]
    cy = _uniform(gen, (n, k, 1, 1), 0.1, 0.9)
    cx = _uniform(gen, (n, k, 1, 1), 0.1, 0.9)
    hh = _uniform(gen, (n, k, 1, 1), 0.05, 0.35)
    ww = _uniform(gen, (n, k, 1, 1), 0.05, 0.35)
    sharp = 80.0
    rect = torch.sigmoid((hh - (yy - cy).abs()) * sharp) * torch.sigmoid((ww - (xx - cx).abs()) * sharp)
    ell = torch.sigmoid((1.0 - ((yy - cy) / hh) ** 2 - ((xx - cx) / ww) ** 2) * 10.0)
    is_ellipse = _bernoulli(gen, 0.5, (n, k, 1, 1))
    mask = torch.where(is_ellipse, ell, rect)  # [n, k, h, w]
    colors = _uniform(gen, (n, k, 1, 1, channels), -0.6, 0.6)
    return torch.sum(mask[..., None] * colors, dim=1)


def _gratings(gen, n, size):
    """Localized oriented sinusoid (fabric/wood-grain texture)."""
    dev = gen.device
    theta = _uniform(gen, (n, 1, 1, 1), 0.0, math.pi)
    freq = _uniform(gen, (n, 1, 1, 1), 2.0, 24.0)
    phase = _uniform(gen, (n, 1, 1, 1), 0.0, 2.0 * math.pi)
    amp = _uniform(gen, (n, 1, 1, 1), 0.0, 0.18)
    yy = torch.linspace(0.0, 1.0, size, device=dev)[None, :, None, None]
    xx = torch.linspace(0.0, 1.0, size, device=dev)[None, None, :, None]
    wave = torch.sin(2.0 * math.pi * freq * (xx * torch.cos(theta) + yy * torch.sin(theta)) + phase)
    cy = _uniform(gen, (n, 1, 1, 1))
    cx = _uniform(gen, (n, 1, 1, 1))
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    return wave * amp * torch.exp(-d2 / 0.12)


def _strokes(gen, n, size, m=6):
    """Thin high-contrast segments: text/wire-like content."""
    dev = gen.device
    rows = torch.arange(size, dtype=torch.float32, device=dev)[None, None, :, None]
    cols = torch.arange(size, dtype=torch.float32, device=dev)[None, None, None, :]
    x0 = _uniform(gen, (n, m, 1, 1), 0.0, float(size))
    y0 = _uniform(gen, (n, m, 1, 1), 0.0, float(size))
    ang = _uniform(gen, (n, m, 1, 1), 0.0, math.pi)
    length = _uniform(gen, (n, m, 1, 1), size * 0.05, size * 0.3)
    amp = _uniform(gen, (n, m, 1, 1), -0.5, 0.5)
    dx = cols - x0
    dy = rows - y0
    t = dx * torch.cos(ang) + dy * torch.sin(ang)
    dperp = -dx * torch.sin(ang) + dy * torch.cos(ang)
    line = torch.exp(-dperp.abs() * 1.5) * torch.sigmoid(t * 2.0) * torch.sigmoid((length - t) * 2.0)
    return torch.sum(line * amp, dim=1)[..., None]


def _random_clean_rich(gen, n, size, channels):
    """Natural-statistics cleans: gradients+blobs backbone, 1/f fractal
    texture, soft shapes, localized gratings, strokes, occasional mirror
    symmetry, finished with random gamma and white balance."""
    base = _random_clean(gen, n, size, channels)
    fract = _fractal_noise(gen, n, size, channels)
    shapes = _soft_shapes(gen, n, size, channels)
    grat = _gratings(gen, n, size)
    strokes = _strokes(gen, n, size)
    w = _uniform(gen, (n, 4, 1, 1, 1))
    img = base + 0.16 * w[:, 0] * fract + 0.8 * w[:, 1] * shapes + w[:, 2] * grat + w[:, 3] * strokes
    sym = _bernoulli(gen, 0.2, (n, 1, 1, 1))
    img = torch.where(sym, 0.5 * img + 0.5 * torch.flip(img, dims=[2]), img)
    gamma = _uniform(gen, (n, 1, 1, 1), 0.7, 1.4)
    wb = _uniform(gen, (n, 1, 1, channels), 0.92, 1.08)
    img = torch.pow(torch.clamp(img, 0.0, 1.0), gamma) * wb
    return torch.clamp(img, 0.0, 1.0)


def _flat_scene(gen, n, size, channels):
    """Opaque layered rectangles/ellipses with flat saturated colours over a
    two-colour ramp: large constant regions meeting at sharp boundaries."""
    dev = gen.device
    yy = torch.linspace(0.0, 1.0, size, device=dev)[None, :, None, None]
    xx = torch.linspace(0.0, 1.0, size, device=dev)[None, None, :, None]
    c0 = _uniform(gen, (n, 1, 1, channels), 0.05, 0.95)
    c1 = _uniform(gen, (n, 1, 1, channels), 0.05, 0.95)
    img = c0 * (1.0 - yy) + c1 * yy
    sharp = 60.0  # ~half-pixel anti-aliased edge at 128 px
    for _ in range(6):
        p = _uniform(gen, (n, 9))
        cy, cx = (0.1 + 0.8 * p[:, 0])[:, None, None, None], (0.1 + 0.8 * p[:, 1])[:, None, None, None]
        hh, ww = (0.05 + 0.3 * p[:, 2])[:, None, None, None], (0.05 + 0.3 * p[:, 3])[:, None, None, None]
        rect = torch.sigmoid((hh - (yy - cy).abs()) * sharp) * torch.sigmoid((ww - (xx - cx).abs()) * sharp)
        ell = torch.sigmoid((1.0 - ((yy - cy) / hh) ** 2 - ((xx - cx) / ww) ** 2) * 14.0)
        mask = torch.where(p[:, 4][:, None, None, None] < 0.5, ell, rect)
        color = p[:, 5:8][:, None, None, :] * 0.9 + 0.05
        alpha = (0.6 + 0.4 * p[:, 8])[:, None, None, None]
        img = img * (1.0 - mask * alpha) + color * mask * alpha
    return torch.clamp(img, 0.0, 1.0)


def _soft_cells(gen, n, size, channels, k=10):
    """Soft nearest-centre cell mosaic (softmax membership over k centres)
    with a coherent saturated palette."""
    dev = gen.device
    centers = _uniform(gen, (n, k, 2))
    # palette along a smooth random curve in RGB (coherent colour scheme)
    base = _uniform(gen, (n, 1, 3), 0.15, 0.85)
    direction = _normal(gen, (n, 1, 3))
    direction = direction / (torch.linalg.vector_norm(direction, dim=-1, keepdim=True) + 1e-9)
    t = torch.linspace(-0.5, 0.5, k, device=dev)[None, :, None]
    wobble = 0.1 * _normal(gen, (n, k, 3))
    colors = torch.clamp(base + t * direction * 0.7 + wobble, 0.03, 0.97)
    yy = torch.linspace(0.0, 1.0, size, device=dev)[None, None, :, None]
    xx = torch.linspace(0.0, 1.0, size, device=dev)[None, None, None, :]
    d2 = (yy - centers[:, :, 0:1, None]) ** 2 + (xx - centers[:, :, 1:2, None]) ** 2  # [n, k, h, w]
    w = torch.softmax(-d2 * 220.0, dim=1)  # sharp-but-anti-aliased boundaries
    img = torch.einsum("nkhw,nkc->nhwc", w, colors)
    shade = 1.0 - 0.2 * torch.sqrt(torch.sum(w * d2, dim=1))[..., None]
    return torch.clamp(img * shade, 0.0, 1.0)


def _periodic_texture(gen, n, size, channels):
    """Dense periodic texture: oriented dot lattices and square-wave weaves
    (fabric / halftone / brick statistics), sometimes over part of a frame."""
    dev = gen.device
    yy = torch.linspace(0.0, 1.0, size, device=dev)[None, :, None, None] * size
    xx = torch.linspace(0.0, 1.0, size, device=dev)[None, None, :, None] * size
    ang = _uniform(gen, (n, 1, 1, 1), 0.0, math.pi)
    period = _uniform(gen, (n, 1, 1, 1), 3.0, 9.0)
    u = (xx * torch.cos(ang) + yy * torch.sin(ang)) / period
    v = (-xx * torch.sin(ang) + yy * torch.cos(ang)) / period
    soft = _uniform(gen, (n, 1, 1, 1), 4.0, 12.0)
    duty = _uniform(gen, (n, 1, 1, 1), -0.3, 0.3)
    # two phase-offset cosines -> dots; one cosine -> stripes; per image
    dots = torch.tanh((torch.cos(2 * math.pi * u) * torch.cos(2 * math.pi * v) + duty) * soft)
    stripes = torch.tanh((torch.cos(2 * math.pi * u) + duty) * soft)
    w_dot = _uniform(gen, (n, 1, 1, 1))
    field = torch.where(w_dot < 0.5, dots, stripes) * 0.5 + 0.5  # [0, 1]
    c0 = _uniform(gen, (n, 1, 1, channels), 0.05, 0.95)
    c1 = _uniform(gen, (n, 1, 1, channels), 0.05, 0.95)
    img = c0 * field + c1 * (1.0 - field)
    # slow illumination ramp, and a large-scale mask so texture appears as a
    # region of a photo, not always full-frame
    gdir = _normal(gen, (n, 2, 1, 1, 1))
    ramp = (yy * gdir[:, 0] + xx * gdir[:, 1]) / size
    img = img * (1.0 + 0.25 * torch.tanh(ramp))
    partial = _bernoulli(gen, 0.4, (n, 1, 1, 1))
    cy = _uniform(gen, (n, 1, 1, 1))
    mask = torch.sigmoid((yy / size - cy) * 30.0)
    base = _random_clean(gen, n, size, channels)
    img = torch.where(partial, img * mask + base * (1.0 - mask), img)
    return torch.clamp(img, 0.0, 1.0)


def _grain_texture(gen, n, size, channels):
    """Aperiodic photographic micro-texture: anisotropically correlated
    band-pass noise over a smooth base (grass, fabric, stone grain). White
    noise is correlated by a per-image Dirichlet blend of four directional
    3x3 smoothing kernels and band-passed by subtracting a 3x3 box; a
    half-resolution octave adds clumping."""
    dev = gen.device
    base = _random_clean(gen, n, size, channels)
    consts = _constants(dev)
    bank, box = consts["grain_bank"], consts["grain_box"]  # [4, 1, 3, 3], [1, 1, 3, 3]

    def correlated(s):
        noise = _normal(gen, (n, 1, s, s))
        smooth4 = F.conv2d(noise, bank, padding=1)  # [n, 4, s, s], zero padding like SAME
        w = _dirichlet_ones(gen, n, 4)
        smooth = torch.einsum("nkhw,nk->nhw", smooth4, w)[:, None]
        wide = F.conv2d(smooth, box, padding=1)
        return (smooth - wide).permute(0, 2, 3, 1)  # [n, s, s, 1]

    fine = correlated(size)
    coarse = correlated((size + 1) // 2)
    coarse = coarse.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :size, :size]
    octave_w = _uniform(gen, (n, 1, 1, 1), 0.2, 0.8)
    g = fine * (1.0 - octave_w) + coarse * octave_w
    g = g / (torch.std(g, dim=(1, 2, 3), keepdim=True, correction=0) + 1e-6)
    amp = _uniform(gen, (n, 1, 1, 1), 0.02, 0.12)
    # mostly-luma grain with a small chroma part, coupled to luminance
    chroma = 0.25 * _normal(gen, (n, size, size, channels)) * g.abs()
    lum_couple = 0.3 + 0.7 * base
    img = base + (g + chroma) * amp * lum_couple
    partial = _bernoulli(gen, 0.3, (n, 1, 1, 1))
    yy = torch.linspace(0.0, 1.0, size, device=dev)[None, :, None, None]
    cy = _uniform(gen, (n, 1, 1, 1))
    mask = torch.sigmoid((yy - cy) * 25.0)
    img = torch.where(partial, img * mask + base * (1.0 - mask), img)
    return torch.clamp(img, 0.0, 1.0)


def _smooth_scene(gen, n, size, channels):
    """Sky/bokeh-like smooth surfaces: 4x4 and 8x8 random control grids,
    linearly upsampled, blended with a linear two-colour ramp at a random
    angle (nothing above ~4 cycles per image)."""
    dev = gen.device
    g4 = _uniform(gen, (n, 4, 4, channels))
    g8 = _uniform(gen, (n, 8, 8, channels))
    w = _uniform(gen, (n, 1, 1, 1))
    grid = upsample_linear(g4, size) * w + upsample_linear(g8, size) * (1.0 - w)
    c0 = _uniform(gen, (n, 1, 1, channels))
    c1 = _uniform(gen, (n, 1, 1, channels))
    theta = _uniform(gen, (n, 1, 1, 1), 0.0, 2.0 * math.pi)
    yy, xx = torch.meshgrid(torch.arange(size, device=dev), torch.arange(size, device=dev), indexing="ij")
    coord = (xx[None, :, :, None] * torch.cos(theta) + yy[None, :, :, None] * torch.sin(theta)) / size
    t = torch.clamp((coord + 1.0) * 0.5, 0.0, 1.0)
    ramp = c0 + (c1 - c0) * t
    mix = _uniform(gen, (n, 1, 1, 1), 0.35, 0.85)
    return torch.clamp(grid * mix + ramp * (1.0 - mix), 0.0, 1.0)


def _clean_photo_mix(gen, n, size, channels, grain=False, smooth=False, smooth_share=0.10):
    """The photo clean distribution: rich images plus flat scenes, cell
    mosaics and periodic texture (optionally grain and smooth scenes carved
    from the rich slice), then creative grades with identity targets.

    Returns ``(img, aug)``, ``aug`` [n, 1] float marking graded images. The
    grades stay distinguishable from damage: exposure is a shadow-crushing
    tone curve with y(1) = 1, matte lifts the black point, desaturation
    mutes colour; ``_degrade`` gates the ambiguous degradations off them."""
    rich = _random_clean_rich(gen, n, size, channels)
    flat = _flat_scene(gen, n, size, channels)
    cells = _soft_cells(gen, n, size, channels)
    tex = _periodic_texture(gen, n, size, channels)
    u = _uniform(gen, (n, 1, 1, 1))
    # the grades' draws come before the optional families', so switching a
    # family on changes its own slice only
    one, zero = torch.ones((), device=gen.device), torch.zeros((), device=gen.device)
    on_e = _bernoulli(gen, 0.2, (n, 1, 1, 1))
    e = torch.where(on_e, _uniform(gen, (n, 1, 1, 1), 0.2, 0.75), one)
    on_m = _bernoulli(gen, 0.15, (n, 1, 1, 1))
    lo = torch.where(on_m, _uniform(gen, (n, 1, 1, 1), 0.0, 0.18), zero)
    on_d = _bernoulli(gen, 0.15, (n, 1, 1, 1))
    dfrac = torch.where(on_d, _uniform(gen, (n, 1, 1, 1), 0.2, 1.0), one)

    img = torch.where(u < 0.18, flat, torch.where(u < 0.33, cells, torch.where(u < 0.47, tex, rich)))
    if grain:
        gtex = _grain_texture(gen, n, size, channels)
        img = torch.where((u >= 0.47) & (u < 0.62), gtex, img)
    if smooth:
        share = min(max(float(smooth_share), 0.0), 0.28)
        sm = _smooth_scene(gen, n, size, channels)
        img = torch.where((u >= 0.62) & (u < 0.62 + share), sm, img)

    # low-key exposure: crush shadows and mids, keep true highlights
    img = img * (e + (1.0 - e) * img * img * img)
    # matte look: lifted black point, highlights intact
    img = lo + (1.0 - lo) * img
    # desaturation: muted palettes are a grade, not a cast
    gray = img.mean(dim=-1, keepdim=True)
    img = gray + (img - gray) * dfrac
    aug = (on_e | on_m | on_d).float()[:, 0, 0, :]
    return torch.clamp(img, 0.0, 1.0), aug


# ------------------------------------------------- photographic degradations


def _build_psf_bank(
    ksize: int = 15,
    radii=(1.5, 2.5, 3.5),
    lengths=(5.0, 9.0, 13.0),
    angles=(0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4),
) -> np.ndarray:
    """Static kernel bank: disk-defocus PSFs and motion-line PSFs."""
    kernels = []
    r0 = ksize // 2
    yy, xx = np.mgrid[-r0 : r0 + 1, -r0 : r0 + 1].astype(np.float32)
    for radius in radii:
        psf = np.clip(radius + 0.5 - np.sqrt(yy**2 + xx**2), 0.0, 1.0)
        kernels.append(psf / psf.sum())
    for length in lengths:
        for ang in angles:
            t = xx * np.cos(ang) + yy * np.sin(ang)
            dperp = -xx * np.sin(ang) + yy * np.cos(ang)
            psf = np.clip(1.0 - np.abs(dperp), 0, 1) * (np.abs(t) <= length / 2)
            kernels.append(psf / psf.sum())
    return np.stack(kernels).astype(np.float32)  # [len(radii) + len(lengths) * len(angles), k, k]


_PSF_BANK = _build_psf_bank()
# the dense bank of the deconv distribution: continuous eval kernels land
# close to some member
_PSF_BANK_RICH = _build_psf_bank(
    radii=(1.5, 2.0, 2.5, 3.0, 3.5),
    lengths=(5.0, 7.0, 9.0, 11.0, 13.0),
    angles=tuple(np.pi * i / 8 for i in range(8)),
)


def _psf_bank(rich: bool, device: torch.device) -> torch.Tensor:
    return _constants(device)["psf_bank_rich" if rich else "psf_bank"]


def _psf_blur(x, idx, strength, bank):
    """Per-image PSF blur from ``bank`` [K, k, k], mixed by strength. One
    grouped convolution over the edge-replicated batch: a real scene
    continues out of frame, and zero padding would darken a rim the model
    could learn to repair instead of deconvolving."""
    n, h, w, c = x.shape
    r = bank.shape[-1] // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (r, r, r, r), mode="replicate")
    weight = bank[idx][:, None].repeat_interleave(c, dim=0)  # [n*c, 1, k, k]: image i's kernel on its c planes
    out = F.conv2d(xp.reshape(1, n * c, h + 2 * r, w + 2 * r), weight, groups=n * c)
    blurred = out.reshape(n, c, h, w).permute(0, 2, 3, 1)
    s = strength[:, None, None, None]
    return x * (1.0 - s) + blurred * s


def _signal_noise(x, strength, normal):
    """Poisson-Gaussian sensor model (Gaussian approximation of shot noise)
    given its unit normal draw: variance = a * intensity + b."""
    a = ((strength * 0.13) ** 2)[:, None, None, None]
    b = ((strength * 0.04) ** 2)[:, None, None, None]
    std = torch.sqrt(a * torch.clamp(x, 0.0, 1.0) + b)
    return x + normal * std


def _vignette_dark(x, strength):
    """Radial vignette + gamma crush: spatially varying underexposure."""
    size = x.shape[1]
    yy = torch.linspace(-1.0, 1.0, size, device=x.device)[None, :, None, None]
    xx = torch.linspace(-1.0, 1.0, size, device=x.device)[None, None, :, None]
    r2 = yy * yy + xx * xx
    s = strength[:, None, None, None]
    vig = torch.clamp(1.0 - 0.45 * s * r2, 0.0, 1.0)
    gamma = 1.0 + 1.1 * s
    return torch.pow(torch.clamp(x * vig, 1e-6, 1.0), gamma)


# standard JPEG annex-K quantization tables
_JPEG_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
_JPEG_CHROMA = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def _dct8_matrix() -> np.ndarray:
    k = np.arange(8)[:, None].astype(np.float32)
    i = np.arange(8)[None, :].astype(np.float32)
    m = np.sqrt(2.0 / 8.0) * np.cos(np.pi * (2 * i + 1) * k / 16.0)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


_DCT8 = _dct8_matrix()

def _make_constants(device: torch.device) -> dict:
    """The data path's constant tensors on ``device``, made by the
    operations that once made them at every call; ``*_only`` and the other
    [1, 7] rows are masks over the seven degradations."""
    k_iso = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=torch.float32, device=device) / 16
    k_h = torch.tensor([[0, 0, 0], [1, 2, 1], [0, 0, 0]], dtype=torch.float32, device=device) / 4
    k_d = torch.eye(3, dtype=torch.float32, device=device) / 3
    mask = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)[None, :]  # noqa: E731
    return {
        "grain_bank": torch.stack([k_iso, k_h, k_h.T, k_d])[:, None],
        "grain_box": torch.full((1, 1, 3, 3), 1.0 / 9.0, device=device),
        "psf_bank": torch.from_numpy(_PSF_BANK).to(device),
        "psf_bank_rich": torch.from_numpy(_PSF_BANK_RICH).to(device),
        "dct8": torch.from_numpy(_DCT8).to(device),
        "jpeg_luma": torch.from_numpy(_JPEG_LUMA).to(device),
        "jpeg_chroma": torch.from_numpy(_JPEG_CHROMA).to(device),
        "compression_only": mask(0, 0, 0, 1, 0, 0, 0),
        "lowlight_only": mask(0, 0, 1, 0, 0, 0, 0),
        "blur_compression": mask(1, 0, 0, 1, 0, 0, 0),
        "wellposed": mask(1, 1, 0, 1, 1, 0, 0),
    }


_device_constants: dict = {}


def _constants(device: torch.device) -> dict:
    """``_make_constants(device)``, made once per device: a draw captured
    as a CUDA graph may not copy from the host, and outside a capture each
    copy would be a hidden synchronisation. Nothing writes them."""
    key = str(device)
    if key not in _device_constants:
        _device_constants[key] = _make_constants(device)
    return _device_constants[key]


def _quant_channel(v, table, qscale):
    """8x8 block DCT quantize/dequantize one channel. v [N,H,W] in
    [-128, 127]; ``table`` the [8, 8] table on v's device (``_constants``);
    qscale [N] the JPEG quality scale factor."""
    n, h, w = v.shape
    d = _constants(v.device)["dct8"]
    blocks = v.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    coef = d @ blocks @ d.T
    qt = torch.clamp(table * qscale[:, None, None, None, None], 1.0, 255.0)
    qc = torch.round(coef / qt) * qt
    rec = d.T @ qc @ d
    return rec.permute(0, 1, 3, 2, 4).reshape(n, h, w)


def _jpeg_analog(x, strength):
    """Real-DCT compression model: YCbCr, 2x2 chroma subsampling, annex-K
    table quantization at quality 92 -> 12 as strength rises."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + 0.5
    cr = (r - y) * 0.713 + 0.5

    q = 92.0 - 80.0 * strength  # JPEG quality in [12, 92]
    qscale = torch.where(q < 50.0, 50.0 / q, 2.0 - q / 50.0)

    consts = _constants(x.device)
    y_q = _quant_channel(y * 255.0 - 128.0, consts["jpeg_luma"], qscale)
    n, h, w = cb.shape

    def sub(ch):
        return ch.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def up(ch):
        return ch.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    cb_q = up(_quant_channel(sub(cb) * 255.0 - 128.0, consts["jpeg_chroma"], qscale))
    cr_q = up(_quant_channel(sub(cr) * 255.0 - 128.0, consts["jpeg_chroma"], qscale))

    y2 = (y_q + 128.0) / 255.0
    cb2 = (cb_q + 128.0) / 255.0 - 0.5
    cr2 = (cr_q + 128.0) / 255.0 - 0.5
    r2 = y2 + cr2 / 0.713
    b2 = y2 + cb2 / 0.564
    g2 = (y2 - 0.299 * r2 - 0.114 * b2) / 0.587
    return torch.clamp(torch.stack([r2, g2, b2], dim=-1), 0.0, 1.0)


def _degrade_draws(gen, n: int, size: int, channels: int, cfg: DataConfig) -> dict:
    """Every random draw of ``_degrade``, by name: booleans for the
    bernoulli draws, floats for uniform and normal draws, ``psf_idx`` long.
    The draws of the optional emphases (compression-solo, lowLight-solo,
    deconv) come last, so switching one off leaves the others' draws alone."""
    shape = (n, size, size, channels)
    d = {
        "active": _bernoulli(gen, 0.5, (n, 7)),
        "keep_clean": _bernoulli(gen, cfg.clean_fraction, (n, 1)),
        "near_clean": _bernoulli(gen, 0.15, (n, 1)),
        "strength": _uniform(gen, (n, 7)),
        "noise": _normal(gen, shape),
    }
    if cfg.photo:
        d["use_psf"] = _bernoulli(gen, 0.5, (n, 1, 1, 1))
        bank_size = (_PSF_BANK_RICH if cfg.deconv else _PSF_BANK).shape[0]
        d["psf_idx"] = torch.randint(0, bank_size, (n,), generator=gen, device=gen.device)
        d["use_sig"] = _bernoulli(gen, 0.5, (n, 1, 1, 1))
        d["sig_noise"] = _normal(gen, shape)
        d["use_vig"] = _bernoulli(gen, 0.5, (n, 1, 1, 1))
        d["dark_noise"] = _normal(gen, shape)
        d["use_dct"] = _bernoulli(gen, 0.75 if cfg.deconv else 0.5, (n, 1, 1, 1))
    d["pos"] = _uniform(gen, (n, 2))
    d["slope"] = _uniform(gen, (n,), -0.3, 0.3)
    d["shift"] = _uniform(gen, (n, 3), -1.0, 1.0)
    if cfg.compression_solo > 0.0:
        d["solo"] = _bernoulli(gen, cfg.compression_solo, (n, 1))
    if cfg.lowlight_solo > 0.0:
        d["lowlight"] = _bernoulli(gen, cfg.lowlight_solo, (n, 1))
    if cfg.deconv:
        d["hard"] = _bernoulli(gen, 0.4, (n, 7))
        d["tail"] = _uniform(gen, (n, 7), 0.7, 1.0)
    return d


def _apply_degradations(clean, cfg: DataConfig, draws: dict, protect=None):
    """The degradations of ``_degrade`` given its draws; returns
    (degraded, applied strengths [N, 7]).

    ``protect`` ([N, 1] float) marks creatively graded cleans: lowLight,
    fade and colorShift are gated off them (stacked on an intentionally dark
    target they would make the ground truth unrecoverable); blur, noise,
    compression and scratch stay."""
    d = draws
    n = clean.shape[0]
    dev = clean.device
    masks = _constants(dev)
    # which degradations are active (bernoulli 0.5 each)
    active = d["active"].float()
    solo = torch.zeros((n, 1), device=dev)
    if cfg.compression_solo > 0.0:
        # compression-only rows, so the jpeg-only regime is no 0.8 % tail
        solo = d["solo"].float()
        active = active * (1.0 - solo) + masks["compression_only"] * solo
    if cfg.lowlight_solo > 0.0:
        # lowLight-only rows; compression wins ties
        ll = d["lowlight"].float() * (1.0 - solo)
        active = active * (1.0 - ll) + masks["lowlight_only"] * ll
    keep_clean = d["keep_clean"].float()
    # a near-clean band (tiny strengths) densely covers the identity regime
    near_clean = d["near_clean"].float()
    scale = 1.0 - near_clean * 0.94
    strength = d["strength"] * active * (1.0 - keep_clean) * scale
    if cfg.deconv:
        # 40 % of active blur/compression draws move to [0.7, 1.0], outside
        # the near-clean band
        take = d["hard"].float() * masks["blur_compression"] * (strength > 0.0) * (1.0 - near_clean)
        strength = strength * (1.0 - take) + d["tail"] * take
    if protect is not None:
        wellposed = masks["wellposed"]
        strength = strength * (wellposed + (1.0 - wellposed) * (1.0 - protect))

    x = clean

    # blur: per-image sigma by interpolation between blur levels 0..3
    blurred = torch.stack([x] + [gaussian_blur(x, s) for s in (1.0, 2.0, 3.0)], dim=1)  # [N, 4, H, W, C]
    level = strength[:, 0] * 3.0
    low = torch.floor(level).long()
    frac = (level - low)[:, None, None, None]
    idx = torch.arange(n, device=dev)
    x_gauss = blurred[idx, low] * (1 - frac) + blurred[idx, torch.clamp(low + 1, max=3)] * frac
    if cfg.photo:
        # photographic optics: disk-defocus / motion-line PSF bank
        psf_s = strength[:, 0]
        if cfg.deconv:
            # full convolution from strength 0.6
            psf_s = torch.clamp(psf_s / 0.6, max=1.0) * (psf_s > 0.0)
        psf = _psf_blur(x, d["psf_idx"], psf_s, _psf_bank(cfg.deconv, dev))
        x = torch.where(d["use_psf"], psf, x_gauss)
    else:
        x = x_gauss

    # noise
    noisy = x + d["noise"] * (strength[:, 1] * cfg.max_noise_std)[:, None, None, None]
    if cfg.photo:
        # sensor variant: signal-dependent Poisson-Gaussian
        x = torch.where(d["use_sig"], _signal_noise(x, strength[:, 1], d["sig_noise"]), noisy)
    else:
        x = noisy

    # low light
    gain = 1.0 - strength[:, 2] * cfg.max_dark_gain
    x_gain = x * gain[:, None, None, None]
    if cfg.photo:
        x = torch.where(d["use_vig"], _vignette_dark(x, strength[:, 2]), x_gain)
        # underexposure damage always carries shot noise; a creatively dark
        # clean image is noiseless: the cue between the two
        x = _signal_noise(x, 0.55 * strength[:, 2], d["dark_noise"])
    else:
        x = x_gain

    # compression analog: 8x8 block-average mix (blocking artifacts)
    b = 8
    nh, nw = x.shape[1] // b, x.shape[2] // b
    inner = x[:, : nh * b, : nw * b]
    blocks = inner.reshape(n, nh, b, nw, b, -1).mean(dim=(2, 4))
    blocky = blocks.repeat_interleave(b, dim=1).repeat_interleave(b, dim=2)
    comp = strength[:, 3][:, None, None, None] * 0.7
    x_blocky = x.clone()
    x_blocky[:, : nh * b, : nw * b] = inner * (1 - comp) + blocky * comp
    if cfg.photo and x.shape[1] % 16 == 0 and x.shape[2] % 16 == 0:
        # real-DCT variant where the compression strength is non-zero;
        # compression-solo rows always take it (they model JPEG uploads)
        x_dct = _jpeg_analog(torch.clamp(x, 0.0, 1.0), strength[:, 3])
        s_on = (strength[:, 3] > 0.01)[:, None, None, None]
        use_dct = d["use_dct"] | (solo[:, :, None, None] > 0.0)
        x = torch.where(use_dct & s_on, x_dct, x_blocky)
    else:
        x = x_blocky

    # scratch: random thin bright line
    size = x.shape[1]
    cols = torch.arange(size, dtype=torch.float32, device=dev)[None, None, :]
    rows = torch.arange(size, dtype=torch.float32, device=dev)[None, :, None]
    line_x = d["pos"][:, 0][:, None, None] * size + d["slope"][:, None, None] * rows
    line = torch.exp(-(cols - line_x).abs() * 2.0)[..., None]
    x = x + line * strength[:, 4][:, None, None, None]

    # fade: pull towards mid-gray, reduce saturation
    fade = strength[:, 5][:, None, None, None] * cfg.max_fade
    gray = x.mean(dim=-1, keepdim=True)
    x = x * (1 - fade) + (0.5 * 0.6 + gray * 0.4) * fade

    # colour shift: per-channel gain imbalance
    shift = d["shift"] * (strength[:, 6] * cfg.max_shift)[:, None]
    x = x * (1.0 + shift[:, None, None, :])
    return torch.clamp(x, 0.0, 1.0), strength


def _degrade(gen, clean, cfg: DataConfig, protect=None):
    """Apply random degradations; returns (degraded, applied strengths [N, 7])."""
    n, size, _, channels = clean.shape
    return _apply_degradations(clean, cfg, _degrade_draws(gen, n, size, channels, cfg), protect)


@torch.no_grad()
def synthetic_batch(gen: torch.Generator, n: int, cfg: DataConfig = DataConfig(), with_masks: bool = False):
    """(degraded [N,S,S,3], clean [N,S,S,3], cond [N,28]) on ``gen``'s device.

    With ``with_masks=True`` a fourth output is appended: ``comp_only`` [N]
    in {0, 1}, the damage rows whose only active degradation is compression
    (the trainer's identity anchor, ``TrainConfig.anchor_comp``, keys on it).

    The conditioning vector comes from the serving classifier on the
    degraded image, not from the applied strengths; ``is_jpeg`` is drawn
    (p = 0.7) since serving traffic is mostly JPEG."""
    if cfg.photo:
        clean, aug = _clean_photo_mix(
            gen, n, cfg.size, cfg.channels, grain=cfg.grain, smooth=cfg.smooth, smooth_share=cfg.smooth_share
        )
    else:
        make = _random_clean_rich if cfg.rich else _random_clean
        clean, aug = make(gen, n, cfg.size, cfg.channels), None
    degraded, strength = _degrade(gen, clean, cfg, protect=aug)
    is_jpeg = _bernoulli(gen, 0.7, (n,)).float()
    valid = torch.full((n, 2), cfg.size, dtype=torch.int32, device=gen.device)
    _scores, cond = batch_classify_and_condition(degraded * 255.0, valid, is_jpeg)
    if with_masks:
        # from the strengths _degrade applied (after the resample)
        others = strength.sum(dim=1) - strength[:, 3]
        comp_only = ((strength[:, 3] > 0.0) & (others <= 0.0)).float()
        return degraded, clean, cond, comp_only
    return degraded, clean, cond
