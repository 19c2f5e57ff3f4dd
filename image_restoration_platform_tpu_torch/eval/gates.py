"""The quality gates of tests/test_quality.py, test_quality_ood.py and
test_quality_real.py, as functions of a model, its inputs and a compute type.

Each function returns the number its gate reads (a gain in dB, a PSNR, a
mean absolute difference in levels of 255); the thresholds are the
reference tests' own, named here. The CPU tests hold the port to the
reference on the reference's inputs with these functions, and
chip_smoke.py runs them on the card in bf16. Inputs come either from the
caller (the JAX package's held-out arrays) or from the port's own draws
(``heldout``, ``near_clean``, ``diffusion_noise``), made on the CPU from
the gate seeds and then moved, so the card and the CPU see the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import diffusion, get_family
from ..train.data import DataConfig, _random_clean_rich, synthetic_batch
from ..train.ood import OOD_DEGRADATIONS, ood_clean, ood_eval_batch
from .common import classified_forward, host, model_device, psnr, serving_forward, tensor

N, SIZE = 8, 128

# tests/test_quality.py
HELDOUT_SEED = 999_001  # DataConfig(size=128)
HELDOUT_PHOTO_SEED = 999_003  # DataConfig(size=128, photo=True)
NEAR_CLEAN_SEEDS = (999_002, 555)
NEAR_CLEAN_NOISE = 0.004
SMOOTH_SEED, SMOOTH_N = 777, 4
FLAGSHIP_GAIN_MIN = 5.0
NEAR_CLEAN_PSNR_MIN, NEAR_CLEAN_MAD_MAX = 42.0, 1.5
SR_GAIN_MIN = {"rich": 4.0, "photo": 1.0}
SMOOTH_PSNR_SLACK, SMOOTH_HF_FACTOR, SMOOTH_HF_SLACK = 0.5, 3.0, 0.3
DIFFUSION_GAIN_MIN = {"rich": 5.0, "photo": 3.0}
DIFFUSION_NOISE_SEED = 0

# tests/test_quality_ood.py
OOD_SEED, OOD_CLEAN_SEED = 2026, 2027
OOD_GATES = {
    "poisson_gaussian": 4.5,
    "defocus": -0.5,
    "motion": 0.0,
    "jpeg_q10_60": -0.5,
    "vignette_low_light": 11.0,
    "chained": 2.5,
}
MOTION_MEAN_MIN = 1.0
OOD_CLEAN_MEAN_MAX, OOD_CLEAN_WORST_MAX = 4.0, 16.0

# tests/test_quality_real.py
REAL_SEED = 424_242
REAL_GATES = {
    "poisson_gaussian": 3.0,
    "vignette_low_light": 12.0,
    "chained": 1.8,
    "defocus": -1.5,
    "motion": -1.0,
    "jpeg_q10_60": -1.2,
}
REAL_CLEAN_MEAN_MAX, REAL_CLEAN_WORST_MAX = 8.0, 28.0


# ------------------------------------------------------------ the port's draws


def heldout(seed: int, photo: bool, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(degraded, clean, cond) of the port's ``synthetic_batch`` at a gate
    seed, drawn on the CPU and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    batch = synthetic_batch(gen, N, DataConfig(size=SIZE, photo=photo))
    return tuple(t.to(device) for t in batch)


def near_clean(seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(near-clean, clean): the port's rich cleans plus N(0, 0.004) noise."""
    gen = torch.Generator().manual_seed(seed)
    clean = _random_clean_rich(gen, N, SIZE, 3)
    near = torch.clamp(clean + torch.randn(clean.shape, generator=gen) * NEAR_CLEAN_NOISE, 0.0, 1.0)
    return near.to(device), clean.to(device)


def diffusion_noise(shape, device, dtype: torch.dtype) -> torch.Tensor:
    """The sampler's unit-normal start of the diffusion gate."""
    gen = torch.Generator().manual_seed(DIFFUSION_NOISE_SEED)
    return torch.randn(tuple(shape), generator=gen).to(dtype).to(device)


# ------------------------------------------------------------------ the gates


def _on(model, x) -> torch.Tensor:
    return tensor(x, model_device(model))


def restore(model, degraded, cond, dtype: torch.dtype) -> torch.Tensor:
    """The backbone on the data's own conditioning, clipped f32."""
    with torch.inference_mode():
        pred = model(_on(model, degraded).to(dtype), _on(model, cond).to(dtype))
        return torch.clamp(pred.float(), 0.0, 1.0)


def flagship_gain(model, degraded, clean, cond, dtype: torch.dtype) -> float:
    """dB over the degraded input (gate: > FLAGSHIP_GAIN_MIN)."""
    return psnr(restore(model, degraded, cond, dtype), clean) - psnr(degraded, clean)


def near_clean_harm(model, near, clean, dtype: torch.dtype) -> tuple[float, float]:
    """(output PSNR, mean absolute error in levels) through the serving
    classifier's conditioning (gates: >= 42 dB, <= 1.5 levels)."""
    pred = host(classified_forward(model, near, dtype))
    return psnr(pred, clean), float(np.mean(np.abs(pred - host(clean)))) * 255.0


def box_down(x: torch.Tensor, scale: int) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // scale, scale, w // scale, scale, c).mean(dim=(2, 4))


def nearest_up(x: torch.Tensor, scale: int) -> torch.Tensor:
    return torch.repeat_interleave(torch.repeat_interleave(x, scale, dim=1), scale, dim=2)


def sr_forward(model, lr, dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode():
        return torch.clamp(model(_on(model, lr).to(dtype)).float(), 0.0, 1.0)


def sr_gain_over_nearest(model, degraded, clean, dtype: torch.dtype) -> float:
    """dB of the SR output of the box-downscaled input over its nearest
    upscale, both against the clean (gates: rich > 4, photo > 1)."""
    scale = model.config.scale
    lr = box_down(_on(model, degraded), scale)
    pred = sr_forward(model, lr, dtype)
    return psnr(pred, clean) - psnr(nearest_up(lr, scale), clean)


def smooth_gate_batch(seed: int = SMOOTH_SEED, n: int = SMOOTH_N, size: int = SIZE) -> np.ndarray:
    """Low-frequency-only content (<= ~3 cycles/image cosine gratings plus a
    radial gradient): any high-frequency energy an SR head adds is
    hallucinated. The gate's own batch (tests/test_quality.py), not the
    eval tool's ``smooth_batch``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        for _ in range(3):
            fx, fy = rng.uniform(-3, 3, 2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.05, 0.2)
            g = amp * np.cos(2 * np.pi * (fx * xx + fy * yy) + ph)
            img += g[..., None] * rng.uniform(0.3, 1.0, 3)
        cx, cy = rng.uniform(0.2, 0.8, 2)
        r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        img += (0.5 - 0.4 * r)[..., None] * rng.uniform(0.5, 1.0, 3)
        out[i] = np.clip(img + 0.3, 0.0, 1.0)
    return out


def hf_energy(x) -> float:
    """Mean absolute 4-neighbour Laplacian, in levels."""
    x = host(x)
    lap = 4.0 * x[:, 1:-1, 1:-1] - x[:, :-2, 1:-1] - x[:, 2:, 1:-1] - x[:, 1:-1, :-2] - x[:, 1:-1, 2:]
    return float(np.mean(np.abs(lap))) * 255.0


def sr_smooth(model, dtype: torch.dtype) -> dict:
    """The no-hallucination gate: SR PSNR >= nearest - 0.5 dB, and Laplacian
    energy <= 3x the true one + 0.3."""
    scale = model.config.scale
    hr = _on(model, smooth_gate_batch())
    lr = box_down(hr, scale)
    pred = sr_forward(model, lr, dtype)
    return {"sr_psnr": psnr(pred, hr), "nearest_psnr": psnr(nearest_up(lr, scale), hr),
            "hf_pred": hf_energy(pred), "hf_true": hf_energy(hr)}


def smooth_holds(r: dict) -> bool:
    return (r["sr_psnr"] >= r["nearest_psnr"] - SMOOTH_PSNR_SLACK
            and r["hf_pred"] <= SMOOTH_HF_FACTOR * r["hf_true"] + SMOOTH_HF_SLACK)


def diffusion_restore(model, degraded, cond, noise, dtype: torch.dtype) -> torch.Tensor:
    """The diffusion family's 2-step sampler from ``noise``, clipped f32."""
    config = get_family("diffusion-restore").config
    with torch.inference_mode():
        pred = diffusion.restore(model, _on(model, degraded).to(dtype), _on(model, cond).to(dtype),
                                 noise.to(model_device(model)), config)
        return torch.clamp(pred.float(), 0.0, 1.0)


def diffusion_gain(model, degraded, clean, cond, noise, dtype: torch.dtype) -> float:
    """dB of the 2-step sampler from ``noise`` (gates: rich > 5, photo > 3)."""
    return psnr(diffusion_restore(model, degraded, cond, noise, dtype), clean) - psnr(degraded, clean)


def ood_gain(family, model, name: str, dtype: torch.dtype) -> float:
    """Aggregate dB of the serving path on one OOD class (gate: OOD_GATES)."""
    degraded, clean = ood_eval_batch(OOD_SEED, N, SIZE, name)
    return psnr(serving_forward(family, model, degraded, dtype), clean) - psnr(degraded, clean)


def ood_motion_per_image(family, model, dtype: torch.dtype) -> float:
    """Mean per-image dB on the motion class (gate: >= 1.0)."""
    degraded, clean = ood_eval_batch(OOD_SEED, N, SIZE, "motion")
    pred = host(serving_forward(family, model, degraded, dtype))
    return float(np.mean([psnr(pred[i], clean[i]) - psnr(degraded[i], clean[i]) for i in range(N)]))


def ood_clean_harm(family, model, dtype: torch.dtype) -> tuple[float, float]:
    """(mean, worst) per-image absolute error in levels on clean OOD content
    (gates: < 4, < 16)."""
    clean = ood_clean(np.random.default_rng(OOD_CLEAN_SEED), N, SIZE)
    pred = host(serving_forward(family, model, clean, dtype))
    per_mad = np.mean(np.abs(pred - clean), axis=(1, 2, 3)) * 255.0
    return float(per_mad.mean()), float(per_mad.max())


def ood_report(family, model, dtype: torch.dtype) -> dict:
    """Every OOD gate's value: {class: gain}, motion per-image, clean harm."""
    report = {name: ood_gain(family, model, name, dtype) for name in OOD_DEGRADATIONS}
    report["motion_per_image"] = ood_motion_per_image(family, model, dtype)
    report["clean_mean_mad"], report["clean_worst_mad"] = ood_clean_harm(family, model, dtype)
    return report


def ood_failures(report: dict) -> list[str]:
    """The OOD gates ``report`` misses, each with its value and bar."""
    out = [f"{k}: {report[k]:.3f} <= {v}" for k, v in OOD_GATES.items() if not report[k] > v]
    if not report["motion_per_image"] >= MOTION_MEAN_MIN:
        out.append(f"motion per image {report['motion_per_image']:.3f} < {MOTION_MEAN_MIN}")
    if not report["clean_mean_mad"] < OOD_CLEAN_MEAN_MAX:
        out.append(f"clean mean {report['clean_mean_mad']:.3f} >= {OOD_CLEAN_MEAN_MAX}")
    if not report["clean_worst_mad"] < OOD_CLEAN_WORST_MAX:
        out.append(f"clean worst {report['clean_worst_mad']:.3f} >= {OOD_CLEAN_WORST_MAX}")
    return out


def per_image_mad(pred, clean) -> np.ndarray:
    return np.mean(np.abs(host(pred) - host(clean)), axis=(1, 2, 3)) * 255.0


def in_distribution_report(models: dict, dtype: torch.dtype, device) -> dict:
    """Every in-distribution gate of tests/test_quality.py on the port's own
    draws at the gate seeds: {gate: value}. ``models`` maps restore-unet,
    sr-x2, sr-x4 and diffusion-restore to their loaded modules."""
    rich = heldout(HELDOUT_SEED, False, device)
    photo = heldout(HELDOUT_PHOTO_SEED, True, device)
    flagship = models["restore-unet"]
    out = {"flagship_gain": flagship_gain(flagship, rich[0], rich[1], rich[2], dtype)}
    for seed in NEAR_CLEAN_SEEDS:
        near, clean = near_clean(seed, device)
        out[f"near_clean_{seed}_psnr"], out[f"near_clean_{seed}_mad"] = near_clean_harm(flagship, near, clean, dtype)
    for name in ("sr-x2", "sr-x4"):
        for dist, (degraded, clean, _) in (("rich", rich), ("photo", photo)):
            out[f"{name}_{dist}_gain"] = sr_gain_over_nearest(models[name], degraded, clean, dtype)
        out[f"{name}_smooth"] = sr_smooth(models[name], dtype)
    for dist, (degraded, clean, cond) in (("rich", rich), ("photo", photo)):
        noise = diffusion_noise(degraded.shape, device, dtype)
        out[f"diffusion_{dist}_gain"] = diffusion_gain(models["diffusion-restore"], degraded, clean, cond, noise, dtype)
    return out


def in_distribution_failures(report: dict) -> list[str]:
    """The in-distribution gates ``report`` misses, each with its value and bar."""
    out = []
    if not report["flagship_gain"] > FLAGSHIP_GAIN_MIN:
        out.append(f"flagship gain {report['flagship_gain']:.3f} <= {FLAGSHIP_GAIN_MIN}")
    for seed in NEAR_CLEAN_SEEDS:
        p, m = report[f"near_clean_{seed}_psnr"], report[f"near_clean_{seed}_mad"]
        if not (p >= NEAR_CLEAN_PSNR_MIN and m <= NEAR_CLEAN_MAD_MAX):
            out.append(f"near-clean {seed}: {p:.3f} dB, mad {m:.3f}")
    for name in ("sr-x2", "sr-x4"):
        for dist, bar in SR_GAIN_MIN.items():
            if not report[f"{name}_{dist}_gain"] > bar:
                out.append(f"{name} {dist} gain {report[f'{name}_{dist}_gain']:.3f} <= {bar}")
        if not smooth_holds(report[f"{name}_smooth"]):
            out.append(f"{name} smooth {report[f'{name}_smooth']}")
    for dist, bar in DIFFUSION_GAIN_MIN.items():
        if not report[f"diffusion_{dist}_gain"] > bar:
            out.append(f"diffusion {dist} gain {report[f'diffusion_{dist}_gain']:.3f} <= {bar}")
    return out

