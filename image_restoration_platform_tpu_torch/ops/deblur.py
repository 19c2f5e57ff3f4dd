"""Spectral blind deblur: PSF estimation + gated Wiener deconvolution.

Counterpart of the 8-bit serving parts of
image_restoration_platform_tpu/ops/deblur.py (see its module docstring for
the method, the thresholds' calibration and why the disk channel is off on
8-bit canvases). The hypothesis bank and analysis constants are numpy,
built once and copied to each device on first use.

Two decisions of the reference run as ``lax.cond`` on the device; here they
are host branches, each a device->host synchronisation per batch, counted
and timed by ``obs.metrics.host_flag``:

- ``deblur_veto``: the directional-gradient veto runs only when some image
  passed the spectral gates;
- ``deblur``: the Wiener inversion and the reclassification run only when
  some image fired.

Each image takes its own result by its flag (``torch.where``), so an image's
output does not depend on whether its batch-mates fire. The pieces between
the decisions are functions of their own (``hypothesis_evidence``,
``veto_ratio``, ``hypothesis_choice``, ``deblur_apply``), which the serving
programs run as separate segments (serve/programs/). Every constant they
read is copied to the device once (``_constants_on``), so none of them
uploads anything while it runs.

``deblur_canvas_f32`` is the float HDR pre-pass of 16-bit PNG uploads: the
same estimator, gates and backstop on [0, 1] f32 canvases, with the disk
channel on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..obs.metrics import host_flag

# ---------------------------------------------------------------------------
# Hypothesis bank (host, numpy, built once)
# ---------------------------------------------------------------------------

KSIZE = 17
DISK_RADII = tuple(float(r) for r in np.arange(1.25, 4.01, 0.125))
MOTION_LENGTHS = (4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0, 13.0, 14.0, 15.0)
N_ANGLES = 16

ANALYSIS_SIZE = 128
_N_BINS = 24

DISK_CHANNEL_ENABLED = False
CORR_DISK_MIN = 0.15
CORR_MOTION_MIN = 0.12
NC_DISK = 0.75
NC_MOTION = 0.9
NC_AXIS_MOTION = 2.6
NC_SHORT_MOTION_SLOPE = 0.25
NC_SHORT_MOTION_REF = 6.0
NC_COMPRESSION_SLOPE = 0.6
NOISE_RATIO_MAX = 0.25
DIR_RATIO_MAX = 0.75
K_DISK = 1e-3
K_MOTION = 3e-3
K_COMPRESSION_SLOPE = 12.0
TV_RATIO_MAX = 3.0


def disk_psf(radius: float, ksize: int = KSIZE) -> np.ndarray:
    """Soft-edged disk (half-pixel anti-aliasing): ideal defocus bokeh."""
    r0 = ksize // 2
    yy, xx = np.mgrid[-r0 : r0 + 1, -r0 : r0 + 1].astype(np.float32)
    psf = np.clip(radius + 0.5 - np.sqrt(yy**2 + xx**2), 0.0, 1.0)
    return psf / psf.sum()


def motion_psf(length: float, angle: float, ksize: int = KSIZE) -> np.ndarray:
    """Anti-aliased line segment: linear camera-shake motion blur."""
    r0 = ksize // 2
    yy, xx = np.mgrid[-r0 : r0 + 1, -r0 : r0 + 1].astype(np.float32)
    t = xx * np.cos(angle) + yy * np.sin(angle)
    dperp = -xx * np.sin(angle) + yy * np.cos(angle)
    psf = np.clip(1.0 - np.abs(dperp), 0.0, 1.0) * (np.abs(t) <= length / 2)
    s = psf.sum()
    return (psf / s if s > 0 else disk_psf(1.0, ksize)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def psf_bank():
    """(psfs [NH,K,K] f32, is_disk [NH] bool, is_axis [NH] bool, names)."""
    psfs, is_disk, is_axis, names = [], [], [], []
    for r in DISK_RADII:
        psfs.append(disk_psf(r))
        is_disk.append(True)
        is_axis.append(False)
        names.append(f"disk{r:.3f}")
    near = {0, 1, N_ANGLES - 1, N_ANGLES // 2 - 1, N_ANGLES // 2, N_ANGLES // 2 + 1}
    for length in MOTION_LENGTHS:
        for ia in range(N_ANGLES):
            ang = np.pi * ia / N_ANGLES
            psfs.append(motion_psf(length, ang))
            is_disk.append(False)
            is_axis.append(ia in near)
            names.append(f"mot{length:.0f}@{np.degrees(ang):.0f}")
    return np.stack(psfs).astype(np.float32), np.asarray(is_disk), np.asarray(is_axis), tuple(names)


@functools.lru_cache(maxsize=1)
def psf_bank_meta():
    """(angle [NH] f32 radians, nc_extra [NH] f32 short-motion surcharge)."""
    angles, nc_extra = [], []
    for _r in DISK_RADII:
        angles.append(0.0)
        nc_extra.append(0.0)
    for length in MOTION_LENGTHS:
        for ia in range(N_ANGLES):
            angles.append(np.pi * ia / N_ANGLES)
            nc_extra.append(NC_SHORT_MOTION_SLOPE * max(0.0, NC_SHORT_MOTION_REF - length))
    return np.asarray(angles, np.float32), np.asarray(nc_extra, np.float32)


def _otf(psf: np.ndarray, size_hw) -> np.ndarray:
    h, w = size_hw
    pad = np.zeros((h, w), np.float32)
    ph, pw = psf.shape
    pad[:ph, :pw] = psf
    pad = np.roll(pad, (-(ph // 2), -(pw // 2)), axis=(0, 1))
    return np.fft.rfft2(pad)


@functools.lru_cache(maxsize=4)
def analysis_constants(size: int = ANALYSIS_SIZE):
    """Spectral-domain constants of the estimator at ``size`` (numpy)."""
    psfs, is_disk, is_axis, _names = psf_bank()
    nh = psfs.shape[0]
    rw = size // 2 + 1

    log_t = np.empty((nh, size, rw), np.float32)
    for i in range(nh):
        log_t[i] = np.log(np.abs(_otf(psfs[i], (size, size))) ** 2 + 1e-8)

    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    fr = np.sqrt(fy**2 + fx**2)
    wmask = ((fr > 0.06) & (fr < 0.46)).astype(np.float32)
    noiseband = (fr >= 0.47).astype(np.float32)

    bins = np.minimum((fr / 0.5 * _N_BINS).astype(np.int32), _N_BINS - 1)
    binmat = np.zeros((_N_BINS, size * rw), np.float32)
    flat_b, flat_m = bins.ravel(), wmask.ravel()
    for k in range(_N_BINS):
        sel = (flat_b == k) * flat_m
        s = sel.sum()
        if s > 0:
            binmat[k] = sel / s

    def radial_residual(log_p: np.ndarray) -> np.ndarray:
        ring_means = binmat @ log_p.ravel()
        return (log_p - ring_means[bins]) * wmask

    t_res = np.stack([radial_residual(t) for t in log_t])
    t_norm = np.sqrt((t_res**2).sum(axis=(1, 2))) + 1e-8

    null_w = np.zeros_like(t_res)
    rest_w = np.zeros_like(t_res)
    for i in range(nh):
        vals = log_t[i][wmask > 0]
        null = (log_t[i] <= np.quantile(vals, 0.08)) & (wmask > 0)
        rest = (log_t[i] >= np.quantile(vals, 0.5)) & (wmask > 0)
        null_w[i] = null / max(1, null.sum())
        rest_w[i] = rest / max(1, rest.sum())

    hann = (np.hanning(size)[:, None] * np.hanning(size)[None, :]).astype(np.float32)
    angles, nc_extra = psf_bank_meta()
    # the recondition's mask: fade and colorShift zeroed on fire
    conservative = np.asarray([1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0], np.float32)
    return dict(
        size=size,
        log_t_res=t_res.astype(np.float32),
        t_norm=t_norm.astype(np.float32),
        null_w=null_w.astype(np.float32),
        rest_w=rest_w.astype(np.float32),
        wmask=wmask,
        noiseband=noiseband,
        bins=bins.astype(np.int64),
        binmat=binmat,
        hann=hann,
        is_disk=is_disk,
        is_axis=is_axis,
        psfs=psfs,
        angles=angles,
        nc_extra=nc_extra,
        conservative=conservative,
    )


_device_constants: dict = {}


def _constants_on(device: torch.device, size: int = ANALYSIS_SIZE) -> dict:
    key = (str(device), size)
    if key not in _device_constants:
        c = analysis_constants(size)
        _device_constants[key] = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device) if isinstance(v, np.ndarray) else v
            for k, v in c.items()
        }
    return _device_constants[key]


# ---------------------------------------------------------------------------
# Batched estimator + Wiener (torch, on the canvas's device)
# ---------------------------------------------------------------------------


def _corner_crops(gray: torch.Tensor, valid_hw: torch.Tensor, size: int) -> torch.Tensor:
    """[B,H,W] -> [B,4,size,size] corner crops of the valid region."""
    b, h, w = gray.shape
    if h < size or w < size:
        raise ValueError(f"canvas {h}x{w} below analysis size {size}")
    vh = torch.clamp(valid_hw[:, 0].long(), max=h)
    vw = torch.clamp(valid_hw[:, 1].long(), max=w)
    y1 = torch.clamp(vh - size, 0, h - size)
    x1 = torch.clamp(vw - size, 0, w - size)
    z = torch.zeros_like(y1)
    ys = torch.stack([z, z, y1, y1], dim=1)  # [B, 4]
    xs = torch.stack([z, x1, z, x1], dim=1)
    ar = torch.arange(size, device=gray.device)
    rows = (ys[:, :, None] + ar)[:, :, :, None]  # [B,4,size,1]
    cols = (xs[:, :, None] + ar)[:, :, None, :]  # [B,4,1,size]
    bidx = torch.arange(b, device=gray.device)[:, None, None, None]
    return gray[bidx, rows, cols]


def _spectral_evidence(crops: torch.Tensor, size: int):
    """(corr [B,NH], nc [B,NH], noise_ratio [B]) from the median
    corner-crop spectrum."""
    c = _constants_on(crops.device, size)
    b = crops.shape[0]
    crops = (crops - crops.mean(dim=(-2, -1), keepdim=True)) * c["hann"]
    power = torch.fft.rfft2(crops).abs() ** 2  # [B,4,size,rw]
    srt = torch.sort(torch.log(power + 1e-8), dim=1).values
    log_p = (srt[:, 1] + srt[:, 2]) * 0.5  # median of 4 (midpoint)

    ring_means = torch.matmul(log_p.reshape(b, -1), c["binmat"].T)  # [B,NB]
    y_res = (log_p - ring_means[:, c["bins"]]) * c["wmask"]

    t_res = c["log_t_res"].reshape(c["log_t_res"].shape[0], -1)  # [NH, size*rw]
    y_flat = y_res.reshape(b, -1)
    y_norm = torch.sqrt((y_res**2).sum(dim=(1, 2))) + 1e-8
    corr = torch.matmul(y_flat, t_res.T) / (c["t_norm"][None, :] * y_norm[:, None])
    nh = t_res.shape[0]
    nc = torch.matmul(y_flat, c["rest_w"].reshape(nh, -1).T) - torch.matmul(
        y_flat, c["null_w"].reshape(nh, -1).T
    )

    power_med = torch.exp(log_p)
    noise_p = (power_med * c["noiseband"]).sum(dim=(1, 2)) / c["noiseband"].sum()
    sig_p = (power_med * c["wmask"]).sum(dim=(1, 2)) / c["wmask"].sum()
    return corr, nc, noise_p / (sig_p + 1e-8)


def _percentile_high(x: torch.Tensor, q: float) -> torch.Tensor:
    """Exact linear-interpolated ``q``-th percentile per row for high q,
    from the top ``n - floor(rank)`` values (``torch.topk``)."""
    n = x.shape[1]
    rank = q / 100.0 * (n - 1)
    lo = int(np.floor(rank))
    # the weight rounded to f32 on the host (no upload); 1 - frac in double
    # rounds to the f32 difference, so the bytes are those of f32 arithmetic
    frac = float(np.float32(rank - lo))
    k = n - lo
    top = torch.topk(x, k, dim=1).values
    v_lo = top[:, k - 1]
    v_hi = top[:, k - 2] if k >= 2 else top[:, k - 1]
    return v_lo * (1 - frac) + v_hi * frac


def _dir_ratio(crops: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    gy, gx = torch.gradient(crops, dim=(2, 3))
    cos_a = torch.cos(ang)[:, None, None, None]
    sin_a = torch.sin(ang)[:, None, None, None]
    b = crops.shape[0]
    g_along = (gx * cos_a + gy * sin_a).abs().reshape(b, -1)
    g_perp = (-gx * sin_a + gy * cos_a).abs().reshape(b, -1)
    return _percentile_high(g_along, 99.0) / (_percentile_high(g_perp, 99.0) + 1e-8)


def hypothesis_evidence(
    gray: torch.Tensor,
    valid_hw: torch.Tensor,
    compression: torch.Tensor,
    size: int = ANALYSIS_SIZE,
    enable_disk: bool = DISK_CHANNEL_ENABLED,
) -> dict:
    """The spectral evidence and the per-kind gates up to the veto: a dict of
    the corner crops, the best disk and motion hypotheses with their scores,
    ``disk_ok``, ``mot_ok`` (the motion gate the veto decides) and the
    noise ratio, all [B]-leading tensors."""
    c = _constants_on(gray.device, size)
    crops = _corner_crops(gray, valid_hw, size)
    corr, nc, noise_ratio = _spectral_evidence(crops, size)

    is_disk = c["is_disk"][None, :]
    is_axis = c["is_axis"]
    comp_pen = NC_COMPRESSION_SLOPE * compression
    neg_inf = -float("inf")

    disk_corr = torch.where(is_disk, corr, neg_inf)
    best_disk = torch.argmax(torch.where(is_disk, nc, neg_inf), dim=1)
    d_corr = disk_corr.gather(1, best_disk[:, None])[:, 0]
    d_nc = nc.gather(1, best_disk[:, None])[:, 0]
    disk_ok = (d_corr >= CORR_DISK_MIN) & (d_nc >= NC_DISK + comp_pen) & enable_disk

    mot_corr = torch.where(is_disk, neg_inf, corr)
    best_mot = torch.argmax(mot_corr, dim=1)
    m_corr = mot_corr.gather(1, best_mot[:, None])[:, 0]
    m_nc = nc.gather(1, best_mot[:, None])[:, 0]
    m_req = (
        torch.where(is_axis[best_mot], torch.full_like(m_nc, NC_AXIS_MOTION), torch.full_like(m_nc, NC_MOTION))
        + c["nc_extra"][best_mot]
        + comp_pen
    )
    mot_ok = (m_corr >= CORR_MOTION_MIN) & (m_nc >= m_req)
    return dict(crops=crops, best_disk=best_disk, d_nc=d_nc, disk_ok=disk_ok, best_mot=best_mot, m_nc=m_nc,
                mot_ok=mot_ok, noise_ratio=noise_ratio)


def veto_ratio(crops: torch.Tensor, best_mot: torch.Tensor, size: int = ANALYSIS_SIZE) -> torch.Tensor:
    """The veto's firing side: each image's directional-gradient ratio along
    its best motion hypothesis, [B]."""
    return _dir_ratio(crops, _constants_on(crops.device, size)["angles"][best_mot])


def hypothesis_choice(ev: dict, ratio: torch.Tensor):
    """(best [B] int64, fire [B] bool) from ``hypothesis_evidence``'s dict
    and the veto's ratio (zeros where the veto did not run)."""
    mot_ok = ev["mot_ok"] & (ratio <= DIR_RATIO_MAX)
    pick_mot = mot_ok & (~ev["disk_ok"] | (ev["m_nc"] > ev["d_nc"]))
    best = torch.where(pick_mot, ev["best_mot"], ev["best_disk"])
    fire = (ev["disk_ok"] | mot_ok) & (ev["noise_ratio"] <= NOISE_RATIO_MAX)
    return best, fire


def select_hypothesis(
    gray: torch.Tensor,
    valid_hw: torch.Tensor,
    compression: torch.Tensor,
    size: int = ANALYSIS_SIZE,
    enable_disk: bool = DISK_CHANNEL_ENABLED,
    fires: dict | None = None,
):
    """Per-kind gated selection. Returns (best [B] int64, fire [B] bool).
    ``fires``, a dict, receives under ``"deblur_veto"`` the [B] mask of the
    images that passed the spectral motion gates, which the veto decides."""
    ev = hypothesis_evidence(gray, valid_hw, compression, size, enable_disk)
    if fires is not None:
        fires["deblur_veto"] = ev["mot_ok"]
    if host_flag("deblur_veto", ev["mot_ok"].any()):
        ratio = veto_ratio(ev["crops"], ev["best_mot"], size)
    else:
        ratio = torch.zeros(gray.shape[0], dtype=ev["crops"].dtype, device=gray.device)
    return hypothesis_choice(ev, ratio)


def _batched_otf(psf_b: torch.Tensor, size_hw) -> torch.Tensor:
    """[B,K,K] PSFs -> [B,H,W/2+1] complex OTFs at the canvas size."""
    h, w = size_hw
    k = psf_b.shape[-1]
    pad = torch.zeros((psf_b.shape[0], h, w), dtype=psf_b.dtype, device=psf_b.device)
    pad[:, :k, :k] = psf_b
    pad = torch.roll(pad, (-(k // 2), -(k // 2)), dims=(1, 2))
    return torch.fft.rfft2(pad)


def _tv(x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """Mean total variation per image over the valid region of [B,H,W,C]."""
    b, h, w, _ = x.shape
    rows = torch.arange(h, device=x.device)[None, :, None, None]
    cols = torch.arange(w, device=x.device)[None, None, :, None]
    mask = (rows < valid_hw[:, 0, None, None, None]) & (cols < valid_hw[:, 1, None, None, None])
    dy = torch.diff(x, dim=1).abs() * mask[:, 1:, :, :]
    dx = torch.diff(x, dim=2).abs() * mask[:, :, 1:, :]
    n = torch.clamp(mask[:, 1:, :, :].sum(dim=(1, 2, 3)), min=1)
    m = torch.clamp(mask[:, :, 1:, :].sum(dim=(1, 2, 3)), min=1)
    return dy.sum(dim=(1, 2, 3)) / n + dx.sum(dim=(1, 2, 3)) / m


def _wiener(x: torch.Tensor, best: torch.Tensor, compression: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] f32 -> Wiener-inverted with each image's selected PSF."""
    b, h, w, _ = x.shape
    c = _constants_on(x.device)
    otf = _batched_otf(c["psfs"][best], (h, w))
    k_wiener = (
        torch.where(c["is_disk"][best], torch.full_like(compression, K_DISK), torch.full_like(compression, K_MOTION))
        * (1.0 + K_COMPRESSION_SLOPE * compression)
    )[:, None, None]
    gain = torch.conj(otf) / (otf.abs() ** 2 + k_wiener)
    spec = torch.fft.rfft2(x.permute(0, 3, 1, 2))
    return torch.fft.irfft2(spec * gain[:, None, :, :], s=(h, w)).permute(0, 2, 3, 1)


def _to_u8(raw: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] in [0, 1] -> u8, contiguous in NHWC: ``raw`` comes from the
    inverse FFT in NCHW strides, and a canvas in those strides would change
    the layout (and the convolution algorithms) of the backbone after it."""
    return torch.clamp(torch.round(torch.clamp(raw, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8).contiguous()


def deblur_canvas_batch(
    canvas_u8: torch.Tensor,
    valid_hw: torch.Tensor,
    compression: torch.Tensor,
    size: int = ANALYSIS_SIZE,
) -> torch.Tensor:
    """Gated Wiener deblur over letterboxed byte canvases (u8 -> u8);
    non-firing images pass through as the same bytes."""
    b, h, w, _ = canvas_u8.shape
    if h < size or w < size:
        return canvas_u8
    x = canvas_u8.float() / 255.0
    best, fire = select_hypothesis(x.mean(dim=-1), valid_hw, compression, size)
    raw = _wiener(x, best, compression)
    fire = fire & (_tv(raw, valid_hw) <= TV_RATIO_MAX * _tv(x, valid_hw) + 1e-6)
    return torch.where(fire[:, None, None, None], _to_u8(raw), canvas_u8)


def deblur_canvas_f32(
    x: torch.Tensor,
    valid_hw: torch.Tensor,
    compression: torch.Tensor,
    size: int = ANALYSIS_SIZE,
    enable_disk: bool = True,
) -> torch.Tensor:
    """Gated Wiener deblur on float canvases ([B,H,W,3] in [0, 1] -> same),
    run on 16-bit samples before any 8-bit quantization, where a defocus
    disk's spectral ring nulls still carry contrast; non-firing images pass
    through untouched."""
    b, h, w, _ = x.shape
    if h < size or w < size:
        return x
    best, fire = select_hypothesis(x.mean(dim=-1), valid_hw, compression, size, enable_disk=enable_disk)
    return deblur_f32_apply(x, valid_hw, compression, best, fire)


def deblur_f32_apply(x, valid_hw, compression, best, fire_pre) -> torch.Tensor:
    """``deblur_canvas_f32`` after the selection: the Wiener inversion of the
    images of ``fire_pre`` whose result passes the TV backstop, clipped to
    [0, 1]; the others pass through."""
    raw = _wiener(x, best, compression)
    fire = fire_pre & (_tv(raw, valid_hw) <= TV_RATIO_MAX * _tv(x, valid_hw) + 1e-6)
    return torch.where(fire[:, None, None, None], torch.clamp(raw, 0.0, 1.0), x)


def applies(shape) -> bool:
    """Whether the stage runs on [B,H,W,C] canvases of ``shape``."""
    _, h, w, _ = shape
    return h >= ANALYSIS_SIZE and w >= ANALYSIS_SIZE


def deblur_apply(canvas_u8, valid_hw, is_jpeg_f, scores, cond, best, fire_pre):
    """The stage's firing side: Wiener-invert the images of ``fire_pre`` whose
    result passes the TV backstop, then rebuild their conditioning
    (structural scores from the deconvolved canvas, photometric ones from
    the original classification, fade and colorShift zeroed); a non-firing
    image keeps its canvas and conditioning. Returns (canvas_u8, cond, fire)."""
    from ..classify.fused import batch_classify_and_condition, conditioning_from_scores, photometric_on

    x = canvas_u8.float() / 255.0
    raw = _wiener(x, best, scores[:, 3])
    fire = fire_pre & (_tv(raw, valid_hw) <= TV_RATIO_MAX * _tv(x, valid_hw) + 1e-6)
    deblurred = torch.where(fire[:, None, None, None], _to_u8(raw), canvas_u8)

    post_scores, _ = batch_classify_and_condition(deblurred.float(), valid_hw, is_jpeg_f)
    photometric = photometric_on(scores.device)
    mixed = post_scores * (1.0 - photometric) + scores * photometric
    conservative = mixed * _constants_on(scores.device)["conservative"]
    mixed = torch.where(fire[:, None], conservative, mixed)
    return deblurred, torch.where(fire[:, None], conditioning_from_scores(mixed), cond), fire


def deblur_and_recondition(canvas_u8, valid_hw, is_jpeg_f, scores, cond, fires=None):
    """The serving insertion: deblur the canvas, then rebuild conditioning
    (``select_hypothesis``, the host branch, then ``deblur_apply`` when some
    image fired). ``fires``, a dict, receives the [B] masks of the veto's
    gate (``"deblur_veto"``) and of the images deblurred (``"deblur"``).
    Returns (canvas_u8, cond)."""
    if not applies(canvas_u8.shape):
        return canvas_u8, cond
    x = canvas_u8.float() / 255.0
    best, fire_pre = select_hypothesis(x.mean(dim=-1), valid_hw, scores[:, 3], fires=fires)
    if not host_flag("deblur", fire_pre.any()):
        if fires is not None:
            fires["deblur"] = fire_pre
        return canvas_u8, cond
    canvas_u8, cond, fire = deblur_apply(canvas_u8, valid_hw, is_jpeg_f, scores, cond, best, fire_pre)
    if fires is not None:
        fires["deblur"] = fire
    return canvas_u8, cond
