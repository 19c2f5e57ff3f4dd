"""Image-conditioned diffusion restoration (SR3-style) with DDIM sampling.

Counterpart of image_restoration_platform_tpu/models/diffusion.py. The
time-conditioned RestorationUNet is the predictor; the degraded image rides
along as 3 extra input channels at every denoising step, and the degradation
score vector conditions through FiLM as in the single-step model. The
schedule is the cosine alpha-bar; ``restore`` denoises from pure noise at
``strength=1.0`` or from a noised copy of the input for smaller strengths.

Sampling is a Python loop over the static ``sample_steps``. The timestep
ladder and its alpha-bar values are computed on the host from the config, so
the loop adds no device->host synchronisation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .unet import UNetConfig


@dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 1000
    # 2-step serving default (the shipped checkpoint was fine-tuned through
    # the unrolled 2-step sampler)
    sample_steps: int = 2
    strength: float = 1.0  # 1.0 = denoise from pure noise (SR3); <1 = SDEdit
    # x0-prediction: the model predicts the clean image and DDIM derives eps
    parameterization: str = "x0"
    # in_channels = 3 (x_t) + 3 (degraded conditioning image)
    unet: UNetConfig = UNetConfig(in_channels=6, time_conditioned=True)


_S = 0.008


def alpha_bar(t_frac: torch.Tensor) -> torch.Tensor:
    """Cosine schedule cumulative alpha at t/T in [0,1]."""
    f = torch.cos((t_frac + _S) / (1 + _S) * math.pi / 2) ** 2
    f0 = math.cos(_S / (1 + _S) * math.pi / 2) ** 2
    return torch.clamp(f / f0, 1e-5, 1.0)


def _alpha_bar_host(t_frac: float) -> float:
    """``alpha_bar`` of one scalar on the host."""
    f = math.cos((t_frac + _S) / (1 + _S) * math.pi / 2) ** 2
    f0 = math.cos(_S / (1 + _S) * math.pi / 2) ** 2
    return min(max(f / f0, 1e-5), 1.0)


def add_noise(x0: torch.Tensor, noise: torch.Tensor, t_frac: torch.Tensor) -> torch.Tensor:
    ab = alpha_bar(t_frac)
    while ab.dim() < x0.dim():
        ab = ab[..., None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def restore(
    model: torch.nn.Module,
    x: torch.Tensor,
    cond: torch.Tensor,
    noise: torch.Tensor | torch.Generator,
    config: DiffusionConfig = DiffusionConfig(),
) -> torch.Tensor:
    """Noise the input to ``strength`` and DDIM back to 0.

    x [N,H,W,3] in [0,1]; returns the restored image, same shape, type and
    range. ``noise`` is the unit normal tensor of x's shape, or a
    ``torch.Generator`` on x's device to draw it from."""
    c = config
    # work in [-1, 1]; the degraded image conditions every step
    x_cond = x * 2.0 - 1.0
    if isinstance(noise, torch.Generator):
        noise = torch.randn(x_cond.shape, generator=noise, device=x.device, dtype=x.dtype)
    # the start is noised in x's type; each step below computes in f32 (the
    # schedule's scalars are f32) and casts the carry back to x's type
    ab_start = _alpha_bar_host(c.strength)
    xt = math.sqrt(ab_start) * x_cond + math.sqrt(1.0 - ab_start) * noise.to(x.dtype)

    # DDIM timestep ladder from strength -> 0, static like the step count
    fracs = np.linspace(c.strength, 0.0, c.sample_steps + 1, dtype=np.float32)
    for idx in range(c.sample_steps):
        t_now, t_next = float(fracs[idx]), float(fracs[idx + 1])
        t_vec = torch.full((x.shape[0],), t_now * c.timesteps, dtype=torch.float32, device=x.device)
        out = model(torch.cat([xt, x_cond], dim=-1), cond, t=t_vec).float()
        ab_now, ab_next = _alpha_bar_host(t_now), _alpha_bar_host(t_next)
        xt_f = xt.float()
        if c.parameterization == "x0":
            x0_pred = torch.clamp(out, -1.0, 1.0)
            eps = (xt_f - math.sqrt(ab_now) * x0_pred) * (1.0 / math.sqrt(max(1.0 - ab_now, 1e-5)))
        else:  # eps-prediction: residual head output minus x_t
            eps = out - xt_f
            x0_pred = torch.clamp((xt_f - math.sqrt(1.0 - ab_now) * eps) / math.sqrt(ab_now), -1.0, 1.0)
        xt = (math.sqrt(ab_next) * x0_pred + math.sqrt(1.0 - ab_next) * eps).to(xt.dtype)
    return torch.clamp((xt + 1.0) * 0.5, 0.0, 1.0)
