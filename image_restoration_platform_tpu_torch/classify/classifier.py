"""Degradation classifier: seven confidence scores in [0, 1] from image
statistics, computed on the device.

Counterpart of image_restoration_platform_tpu/classify/classifier.py: the
degradation types and their canonical order (the conditioning layout),
``classify_scores`` (grayscale, three clamped 3x3 stencils, a gaussian blur
and the reductions, as one function on tensors) and ``ClassifierService``,
whose ``analyze`` decodes an upload and classifies it on its device with one
device->host copy of the scores. The restore path does not use this service:
it classifies on the device inside its program (classify/fused.py).

Score semantics (the reference's classifier.js):
  blur        1 - min(var(clamp(lap8(gray)))/1000, 1)
  noise       min(std(clamp(hp9(gray)))/50, 1)
  lowLight    brightness<0.3 ? min((0.3-b)*2, 1) : 0
  compression jpeg only: min(max(var(img)-var(blur1(img)),0)/500, 1)
  scratch     min(stride-4 paired-threshold count/1000, 1)
  fade        min((1-colorfulness)*0.6 + (1-contrast)*0.4, 1)
  colorShift  min(max channel mean deviation * 2, 1)
with colorfulness = ||channel stdevs||/255 and contrast = mean(stdev)/64.
Stencil outputs are rounded and clamped to bytes, as libvips does; the
normalisation constants are calibrated to that.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.tracing import get_tracer
from ..ops.stats import channel_stats, flat_variance
from ..ops.stencil import K_HIGHPASS9, K_LAPLACIAN4, K_LAPLACIAN8, conv3x3_clamped_u8, gaussian_blur, grayscale
from ..utils.logging import get_logger

DEGRADATION_TYPES = {
    "blur": "Motion blur or out-of-focus areas",
    "noise": "Grain and digital noise",
    "lowLight": "Underexposed or shadow detail loss",
    "compression": "JPEG artifacts and quality loss",
    "scratch": "Physical damage and blemishes",
    "fade": "Color loss and contrast reduction",
    "colorShift": "White balance and color cast issues",
}

# canonical ordering: this is also the layout of the model conditioning vector
DEGRADATION_ORDER = tuple(DEGRADATION_TYPES.keys())

_SCRATCH_THRESHOLD = 200.0


def _scratch_line_count(edge: torch.Tensor) -> torch.Tensor:
    """The stride-4 linear-feature scan of [H, W] edge bytes: every 4th
    pixel over the threshold whose right / bottom neighbour is over it too."""
    mask = edge > _SCRATCH_THRESHOLD
    right = torch.zeros_like(mask)
    right[:, :-1] = mask[:, 1:]
    down = torch.zeros_like(mask)
    down[:-1, :] = mask[1:, :]
    v = torch.sum((mask & right)[::4, ::4].float())
    h = torch.sum((mask & down)[::4, ::4].float())
    return v + h


def classify_scores(img_u8: torch.Tensor, is_jpeg: bool = False) -> dict[str, torch.Tensor]:
    """All seven degradation scores of an [H, W, 3] uint8 image, as 0-d f32
    tensors on the image's device."""
    img = img_u8.float()
    gray = grayscale(img[None])

    lap8 = conv3x3_clamped_u8(gray, K_LAPLACIAN8)[0]
    edge_var = flat_variance(lap8)
    blur = torch.clamp(1.0 - torch.clamp(edge_var / 1000.0, max=1.0), min=0.0)

    hp9 = conv3x3_clamped_u8(gray, K_HIGHPASS9)[0]
    noise = torch.clamp(torch.sqrt(flat_variance(hp9)) / 50.0, max=1.0)

    ch_mean, ch_std = channel_stats(img)

    brightness = torch.mean(ch_mean) / 255.0
    low_light = torch.where(brightness < 0.3, torch.clamp((0.3 - brightness) * 2.0, max=1.0), 0.0)

    if is_jpeg:
        blurred = torch.clamp(torch.round(gaussian_blur(img[None], 1.0)[0]), 0.0, 255.0)
        delta = torch.clamp(flat_variance(img) - flat_variance(blurred), min=0.0)
        compression = torch.clamp(delta / 500.0, max=1.0)
    else:
        compression = torch.zeros((), dtype=torch.float32, device=img.device)

    lap4 = conv3x3_clamped_u8(gray, K_LAPLACIAN4)[0]
    scratch = torch.clamp(_scratch_line_count(lap4) / 1000.0, max=1.0)

    colorfulness = torch.clamp(torch.sqrt(torch.sum(torch.square(ch_std[:3]))) / 255.0, max=1.0)
    contrast = torch.clamp(torch.mean(ch_std) / 64.0, max=1.0)
    fade = torch.clamp((1.0 - colorfulness) * 0.6 + (1.0 - contrast) * 0.4, max=1.0)

    avg_mean = torch.mean(ch_mean[:3])
    deviation = torch.where(
        avg_mean > 0.0, torch.max(torch.abs(ch_mean[:3] - avg_mean)) / avg_mean, 0.0
    )
    color_shift = torch.clamp(deviation * 2.0, max=1.0)

    return {
        "blur": blur,
        "noise": noise,
        "lowLight": low_light,
        "compression": compression,
        "scratch": scratch,
        "fade": fade,
        "colorShift": color_shift,
    }


_FALLBACKS = {
    # per-analyzer conservative fallbacks (classifier.js)
    "blur": 0.1,
    "noise": 0.1,
    "lowLight": 0.1,
    "compression": 0.0,
    "scratch": 0.05,
    "fade": 0.1,
    "colorShift": 0.1,
}


class ClassifierService:
    """Service facade matching ClassifierService.analyze() in the reference;
    runs on ``device="cuda"`` unless the caller asks for the CPU."""

    def __init__(self, logger=None, device: str | torch.device = "cuda"):
        from ..serve.engine import resolve_device

        self.device = resolve_device(device)
        self.logger = logger or get_logger("classifier")
        self._tracer = get_tracer("classifier")

    def analyze_array(self, img: np.ndarray, fmt: str | None = None) -> dict[str, float]:
        """Classify a decoded [H, W, 3] uint8 array; ``fmt`` is the container
        format ('jpeg'/'png'/'webp') driving the jpeg-only compression score."""
        with self._tracer.span(
            "classifier.analyze",
            {
                "image.width": int(img.shape[1]),
                "image.height": int(img.shape[0]),
                "image.format": fmt or "raw",
                "classifier.version": "2.0.0-torch",
            },
        ) as span:
            if img.ndim == 2:
                img = np.repeat(img[:, :, None], 3, axis=2)
            if img.shape[-1] == 4:
                img = img[:, :, :3]
            try:
                x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8)).to(self.device)
                scores = classify_scores(x, fmt == "jpeg")
                values = torch.stack([scores[k] for k in DEGRADATION_ORDER]).cpu().tolist()
                analysis = dict(zip(DEGRADATION_ORDER, values))
            except Exception as error:  # pragma: no cover - device failure path
                self.logger.warn(
                    "Analysis failed on device, using fallback constants",
                    {"error": str(error)},
                )
                analysis = dict(_FALLBACKS)
                if fmt == "jpeg":
                    analysis["compression"] = 0.2

            top = sorted(
                ((k, v) for k, v in analysis.items() if v > 0.3),
                key=lambda kv: kv[1],
                reverse=True,
            )[:3]
            span.set_attributes(
                {
                    "classifier.top_issues": ",".join(f"{k}:{v:.2f}" for k, v in top),
                    "classifier.issue_count": len(top),
                }
            )
            self.logger.debug(
                "Analysis complete",
                {"topIssues": [{"type": k, "score": round(v, 2)} for k, v in top]},
            )
            return analysis

    def analyze(self, image_bytes: bytes) -> dict[str, float]:
        """Classify an encoded image (decoded by the host imageio stage)."""
        from ..imageio import decode_image

        decoded = decode_image(image_bytes)
        return self.analyze_array(decoded.pixels, decoded.format)

    @staticmethod
    def get_degradation_types() -> dict[str, str]:
        return dict(DEGRADATION_TYPES)
