"""Image statistics of the classifier: population variance and per-channel
mean / standard deviation, f32 on the tensor's device.

Counterpart of image_restoration_platform_tpu/ops/stats.py (sharp's
.stats() and the reference's JS variance helpers)."""

from __future__ import annotations

import torch


def flat_variance(x: torch.Tensor) -> torch.Tensor:
    """Population variance over every element."""
    x = x.float()
    return torch.mean(torch.square(x - torch.mean(x)))


def channel_stats(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, stdev) of an [H, W, C] byte-range image: two [C]
    f32 vectors."""
    x = img.float()
    mean = torch.mean(x, dim=(0, 1))
    var = torch.mean(torch.square(x - mean[None, None, :]), dim=(0, 1))
    return mean, torch.sqrt(var)
