"""Gated JPEG deblocking: quant-step estimation + overcomplete shifted-grid
DCT soft-thresholding.

Counterpart of image_restoration_platform_tpu/ops/deblock.py (see its module
docstring for the method and its measured operating point). The estimator
runs on every batch; the four-grid shrinkage and the reclassification run
only when some image of the batch fires. That decision is a host branch on
``fire.any()``, which synchronises with the device once per batch (the
reference's ``lax.cond`` stays on the device); each one is counted and
timed under ``deblock`` by ``obs.metrics.host_flag``. Each image takes its
result or its input by its own fire flag (``torch.where``), so non-firing
images pass through as the same bytes whatever their batch-mates do.

The two sides of the decision are functions of their own,
``deblock_decision`` and ``deblock_apply``, which the serving program runs
as separate segments (serve/programs/restore.py). Their constants are
copied to each device once (``_consts_on``), so neither uploads anything
while it runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.metrics import host_flag

BLOCK = 8
LAM_COEF = 0.22
LAM_CHROMA = 1.5
LAM_MIN_FIRE = 1.5
LAM_CAP = 8.0
Q_MAX = 100
SHIFTS = ((0, 0), (4, 4), (0, 4), (4, 0))
EST_FREQS = ((0, 1), (1, 0), (1, 1))


def _dct_mat() -> np.ndarray:
    k = np.arange(BLOCK)
    m = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * BLOCK))
    m *= np.sqrt(2.0 / BLOCK)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


_DCT = _dct_mat()
# BT.601 full-range, matching the codec's encode path
_RGB2YCC = np.array(
    [[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]],
    dtype=np.float32,
)
_YCC2RGB = np.array(
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], dtype=np.float32
)


_device_consts: dict = {}


def _consts_on(device: torch.device) -> dict:
    """The DCT and colour matrices on ``device``, copied on first use."""
    key = str(device)
    if key not in _device_consts:
        host = {"dct": _DCT, "rgb2y": _RGB2YCC[0].copy(),
                "rgb2ycc_t": _RGB2YCC.T.copy(), "ycc2rgb_t": _YCC2RGB.T.copy()}
        _device_consts[key] = {name: torch.from_numpy(a).to(device) for name, a in host.items()}
    return _device_consts[key]


def _block_dct(ch: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H/8, W/8, 8, 8] forward 8x8 DCT."""
    *lead, h, w = ch.shape
    b = ch.reshape(*lead, h // BLOCK, BLOCK, w // BLOCK, BLOCK).transpose(-3, -2)
    d = _consts_on(ch.device)["dct"]
    return torch.matmul(torch.matmul(d, b), d.T)


def _block_idct(c: torch.Tensor) -> torch.Tensor:
    """[..., H/8, W/8, 8, 8] -> [..., H, W] inverse 8x8 DCT."""
    *lead, nb_y, nb_x, _, _ = c.shape
    d = _consts_on(c.device)["dct"]
    b = torch.matmul(torch.matmul(d.T, c), d)
    return b.transpose(-3, -2).reshape(*lead, nb_y * BLOCK, nb_x * BLOCK)


def estimate_qstep(y: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """Luma quant-step estimate per image: [B, H, W] (0..255) -> [B] q-hat.

    Mode of the rounded nonzero |c| histogram per low AC frequency over the
    blocks fully inside the valid region (first index on ties); a frequency
    counts only when its mode holds >= max(4, 8% of its nonzero count).
    q-hat is the median of the three frequencies' estimates."""
    c = _block_dct(y)  # [B, nbY, nbX, 8, 8]
    b, nb_y, nb_x = c.shape[:3]
    by = torch.arange(nb_y, device=y.device)[None, :, None]
    bx = torch.arange(nb_x, device=y.device)[None, None, :]
    inside = ((by + 1) * BLOCK <= valid_hw[:, 0, None, None]) & (
        (bx + 1) * BLOCK <= valid_hw[:, 1, None, None]
    )
    qs = []
    for u, v in EST_FREQS:
        vals = torch.round(c[..., u, v].abs())
        ok = inside & (vals >= 1) & (vals < Q_MAX)
        idx = torch.where(ok, vals, torch.zeros_like(vals)).long().reshape(b, -1)
        hist = torch.zeros(b, Q_MAX, dtype=torch.long, device=y.device)
        hist.scatter_add_(1, idx, ok.reshape(b, -1).long())
        hist = hist[:, 1:]  # bins 1..Q_MAX-1; the zero bin collects the rejects
        n = ok.reshape(b, -1).sum(dim=1)
        m = torch.argmax(hist, dim=1)
        peak = hist.gather(1, m[:, None])[:, 0]
        mass_ok = peak >= torch.clamp(0.08 * n.float(), min=4.0)
        qs.append(torch.where(mass_ok, (m + 1).float(), torch.zeros_like(m, dtype=torch.float32)))
    return torch.sort(torch.stack(qs, dim=1), dim=1).values[:, 1]


def deblock_lambda(canvas_f32: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] (0..255), [B,2] -> [B] luma threshold."""
    y = torch.matmul(canvas_f32, _consts_on(canvas_f32.device)["rgb2y"])
    return torch.clamp(LAM_COEF * estimate_qstep(y, valid_hw), max=LAM_CAP)


def _deblock(x: torch.Tensor, lam_y: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] RGB (0..255) -> deblocked RGB, four shifted grids averaged."""
    b, h, w, _ = x.shape
    consts = _consts_on(x.device)
    ycc = torch.matmul(x, consts["rgb2ycc_t"]).permute(0, 3, 1, 2)  # [B,3,H,W]
    lam = torch.stack([lam_y, lam_y * LAM_CHROMA, lam_y * LAM_CHROMA], dim=1)[:, :, None, None, None, None]
    acc = torch.zeros_like(ycc)
    for sy, sx in SHIFTS:
        py, px = (BLOCK - sy) % BLOCK, (BLOCK - sx) % BLOCK
        p = torch.nn.functional.pad(ycc, (sx, px, sy, py), mode="replicate")
        c = _block_dct(p)
        dc = c[..., 0:1, 0:1]
        c = torch.sign(c) * torch.clamp(c.abs() - lam, min=0.0)
        c[..., 0:1, 0:1] = dc
        acc = acc + _block_idct(c)[..., sy : sy + h, sx : sx + w]
    return torch.matmul((acc / len(SHIFTS)).permute(0, 2, 3, 1), consts["ycc2rgb_t"])


def applies(shape) -> bool:
    """Whether the stage runs on [B,H,W,3] canvases of ``shape``."""
    _, h, w, _ = shape
    return not (h % BLOCK or w % BLOCK or h < 64 or w < 64)


def deblock_canvas_batch(canvas_u8: torch.Tensor, valid_hw: torch.Tensor):
    """u8 [B,H,W,3] -> (u8 deblocked-or-passthrough, fire [B] bool)."""
    if not applies(canvas_u8.shape):
        return canvas_u8, torch.zeros(canvas_u8.shape[0], dtype=torch.bool, device=canvas_u8.device)
    x = canvas_u8.float()
    lam = deblock_lambda(x, valid_hw)
    fire = lam > LAM_MIN_FIRE
    out_u8 = torch.clamp(torch.round(_deblock(x, lam)), 0, 255).to(torch.uint8)
    return torch.where(fire[:, None, None, None], out_u8, canvas_u8), fire


def deblock_decision(canvas_u8: torch.Tensor, valid_hw: torch.Tensor):
    """(lam [B], fire [B] bool): the luma threshold of each canvas and
    whether the stage fires on it."""
    lam = deblock_lambda(canvas_u8.float(), valid_hw)
    return lam, lam > LAM_MIN_FIRE


def deblock_apply(canvas_u8, valid_hw, is_jpeg_f, scores, cond, lam, fire):
    """The stage's firing side: the deblocked canvas where ``fire``, its
    structural scores recomputed, its photometric scores kept from the
    original classification; a non-firing image keeps its canvas, scores
    and conditioning. Returns (canvas_u8, scores, cond)."""
    from ..classify.fused import batch_classify_and_condition, conditioning_from_scores, photometric_on

    out_u8 = torch.clamp(torch.round(_deblock(canvas_u8.float(), lam)), 0, 255).to(torch.uint8)
    deblocked = torch.where(fire[:, None, None, None], out_u8, canvas_u8)
    post_scores, _ = batch_classify_and_condition(deblocked.float(), valid_hw, is_jpeg_f)
    photometric = photometric_on(scores.device)
    mixed = post_scores * (1.0 - photometric) + scores * photometric
    mixed = torch.where(fire[:, None], mixed, scores)
    return deblocked, mixed, torch.where(fire[:, None], conditioning_from_scores(mixed), cond)


def deblock_and_recondition(canvas_u8, valid_hw, is_jpeg_f, scores, cond, fires=None):
    """The serving insertion, before the deblur stage: ``deblock_decision``,
    the host branch, then ``deblock_apply`` when some image fires.
    ``fires``, a dict, receives the [B] fire mask under ``"deblock"``.
    Returns (canvas_u8, scores, cond)."""
    if not applies(canvas_u8.shape):
        return canvas_u8, scores, cond
    lam, fire = deblock_decision(canvas_u8, valid_hw)
    if fires is not None:
        fires["deblock"] = fire
    if not host_flag("deblock", fire.any()):
        return canvas_u8, scores, cond
    return deblock_apply(canvas_u8, valid_hw, is_jpeg_f, scores, cond, lam, fire)
