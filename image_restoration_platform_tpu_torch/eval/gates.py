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

The ``*_checks`` functions name each gate by the pytest node id of the
reference's test (``QUALITY_TESTS`` etc.) and give its failure message, or
None where it holds; ``family_gates`` runs the gates of one family only, as
the promotion gate (retrain/validate_staging.py) needs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import diffusion, get_family
from ..train.data import DataConfig, _random_clean_rich, synthetic_batch
from ..train.ood import OOD_DEGRADATIONS, ood_clean, ood_eval_batch
from ..train.realphoto import available_sources, real_clean_patches, real_eval_batch
from .common import classified_forward, host, model_device, psnr, serving_forward, tensor

N, SIZE = 8, 128
# the reference's gate tests, whose pytest node ids name the gates below
QUALITY_TESTS = "tests/test_quality.py::"
OOD_TESTS = "tests/test_quality_ood.py::"
REAL_TESTS = "tests/test_quality_real.py::"

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


def ood_checks(report: dict) -> dict:
    """{node id of the reference's gate test: failure message, or None
    where the gate holds} of the OOD gates in ``report``."""
    out = {f"{OOD_TESTS}test_flagship_ood_gain[{k}]": None if report[k] > v else f"{k}: {report[k]:.3f} <= {v}"
           for k, v in OOD_GATES.items()}
    motion = report["motion_per_image"]
    out[f"{OOD_TESTS}test_flagship_motion_deblur_gain"] = (
        None if motion >= MOTION_MEAN_MIN else f"motion per image {motion:.3f} < {MOTION_MEAN_MIN}")
    mean, worst = report["clean_mean_mad"], report["clean_worst_mad"]
    harm = [f"clean mean {mean:.3f} >= {OOD_CLEAN_MEAN_MAX}"] if not mean < OOD_CLEAN_MEAN_MAX else []
    harm += [f"clean worst {worst:.3f} >= {OOD_CLEAN_WORST_MAX}"] if not worst < OOD_CLEAN_WORST_MAX else []
    out[f"{OOD_TESTS}test_flagship_ood_clean_no_harm"] = "; ".join(harm) or None
    return out


def ood_failures(report: dict) -> list[str]:
    """The OOD gates ``report`` misses, each with its value and bar."""
    return [m for m in ood_checks(report).values() if m]


def real_report(model, dtype: torch.dtype) -> dict:
    """Every real-photo gate's value on the classifier-conditioned backbone
    (tests/test_quality_real.py's path): {class: gain}, and the clean
    patches' mean and worst per-image absolute error in levels. Raises where
    the machine holds no real-photo source (``realphoto.available_sources``)."""
    report = {}
    for name in REAL_GATES:
        degraded, clean = real_eval_batch(REAL_SEED, N, SIZE, name)
        report[name] = psnr(classified_forward(model, degraded, dtype), clean) - psnr(degraded, clean)
    clean = real_clean_patches(np.random.default_rng(REAL_SEED + 1), N, SIZE)
    per_mad = per_image_mad(classified_forward(model, clean, dtype), clean)
    report["clean_mean_mad"], report["clean_worst_mad"] = float(per_mad.mean()), float(per_mad.max())
    return report


def real_checks(report: dict) -> dict:
    """{node id: failure message or None} of the real-photo gates in ``report``."""
    out = {f"{REAL_TESTS}test_real_photo_gain[{k}-{v}]": None if report[k] >= v else f"real {k}: {report[k]:.3f} < {v}"
           for k, v in REAL_GATES.items()}
    mean, worst = report["clean_mean_mad"], report["clean_worst_mad"]
    ok = mean <= REAL_CLEAN_MEAN_MAX and worst <= REAL_CLEAN_WORST_MAX
    out[f"{REAL_TESTS}test_real_photo_clean_harm_bounded"] = None if ok else f"real clean mean {mean:.3f}, worst {worst:.3f}"
    return out


def per_image_mad(pred, clean) -> np.ndarray:
    return np.mean(np.abs(host(pred) - host(clean)), axis=(1, 2, 3)) * 255.0


def flagship_report(model, rich, dtype: torch.dtype, device) -> dict:
    """The flagship's in-distribution gate values: its gain on the rich
    held-out batch ``rich`` and the near-clean harm at each seed."""
    out = {"flagship_gain": flagship_gain(model, rich[0], rich[1], rich[2], dtype)}
    for seed in NEAR_CLEAN_SEEDS:
        near, clean = near_clean(seed, device)
        out[f"near_clean_{seed}_psnr"], out[f"near_clean_{seed}_mad"] = near_clean_harm(model, near, clean, dtype)
    return out


def sr_report(name: str, model, rich, photo, dtype: torch.dtype) -> dict:
    """One SR family's gate values: gain over nearest on both held-out
    batches, and the smooth no-hallucination numbers."""
    out = {f"{name}_{dist}_gain": sr_gain_over_nearest(model, degraded, clean, dtype)
           for dist, (degraded, clean, _) in (("rich", rich), ("photo", photo))}
    out[f"{name}_smooth"] = sr_smooth(model, dtype)
    return out


def diffusion_report(model, rich, photo, dtype: torch.dtype, device) -> dict:
    """The diffusion family's gain on both held-out batches from the gate's noise."""
    out = {}
    for dist, (degraded, clean, cond) in (("rich", rich), ("photo", photo)):
        noise = diffusion_noise(degraded.shape, device, dtype)
        out[f"diffusion_{dist}_gain"] = diffusion_gain(model, degraded, clean, cond, noise, dtype)
    return out


def in_distribution_report(models: dict, dtype: torch.dtype, device) -> dict:
    """Every in-distribution gate of tests/test_quality.py on the port's own
    draws at the gate seeds: {gate: value}. ``models`` maps restore-unet,
    sr-x2, sr-x4 and diffusion-restore to their loaded modules."""
    rich = heldout(HELDOUT_SEED, False, device)
    photo = heldout(HELDOUT_PHOTO_SEED, True, device)
    out = flagship_report(models["restore-unet"], rich, dtype, device)
    for name in ("sr-x2", "sr-x4"):
        out.update(sr_report(name, models[name], rich, photo, dtype))
    out.update(diffusion_report(models["diffusion-restore"], rich, photo, dtype, device))
    return out


def in_distribution_checks(report: dict) -> dict:
    """{node id: failure message or None} of the in-distribution gates whose
    values ``report`` holds (all four families' or one family's)."""
    out = {}
    if "flagship_gain" in report:
        gain = report["flagship_gain"]
        out[f"{QUALITY_TESTS}test_flagship_restoration_gain"] = (
            None if gain > FLAGSHIP_GAIN_MIN else f"flagship gain {gain:.3f} <= {FLAGSHIP_GAIN_MIN}")
        for seed in NEAR_CLEAN_SEEDS:
            p, m = report[f"near_clean_{seed}_psnr"], report[f"near_clean_{seed}_mad"]
            ok = p >= NEAR_CLEAN_PSNR_MIN and m <= NEAR_CLEAN_MAD_MAX
            out[f"{QUALITY_TESTS}test_flagship_bounded_harm_on_near_clean[{seed}]"] = (
                None if ok else f"near-clean {seed}: {p:.3f} dB, mad {m:.3f}")
    for name in ("sr-x2", "sr-x4"):
        if f"{name}_smooth" not in report:
            continue
        tests = {"rich": f"test_{name.replace('-', '_')}_beats_nearest_baseline",
                 "photo": f"test_sr_photo_distribution_gain[{name}]"}
        for dist, bar in SR_GAIN_MIN.items():
            gain = report[f"{name}_{dist}_gain"]
            out[QUALITY_TESTS + tests[dist]] = None if gain > bar else f"{name} {dist} gain {gain:.3f} <= {bar}"
        smooth = report[f"{name}_smooth"]
        out[f"{QUALITY_TESTS}test_sr_no_texture_hallucination_on_smooth[{name}]"] = (
            None if smooth_holds(smooth) else f"{name} smooth {smooth}")
    for dist, fixture in (("rich", "heldout"), ("photo", "heldout_photo")):
        if f"diffusion_{dist}_gain" not in report:
            continue
        gain, bar = report[f"diffusion_{dist}_gain"], DIFFUSION_GAIN_MIN[dist]
        out[f"{QUALITY_TESTS}test_diffusion_restoration_gain[{fixture}-{bar}]"] = (
            None if gain > bar else f"diffusion {dist} gain {gain:.3f} <= {bar}")
    return out


def in_distribution_failures(report: dict) -> list[str]:
    """The in-distribution gates ``report`` misses, each with its value and bar."""
    return [m for m in in_distribution_checks(report).values() if m]


def family_gates(family_name: str, model, dtype: torch.dtype, device) -> dict:
    """{node id of the reference's gate test: failure message, or None where
    the gate holds} of every gate of tests/test_quality*.py that reads
    ``family_name``'s model, and of no other family's: the flagship's
    held-out, near-clean, OOD and real-photo gates, each SR family's three,
    the diffusion family's two; restore-unet-small has none. The real-photo
    gates are left out, as the reference's skip, where the machine holds no
    real-photo source."""
    if family_name not in ("restore-unet", "sr-x2", "sr-x4", "diffusion-restore"):
        return {}
    rich = heldout(HELDOUT_SEED, False, device)
    if family_name == "restore-unet":
        out = in_distribution_checks(flagship_report(model, rich, dtype, device))
        out.update(ood_checks(ood_report(family_name, model, dtype)))
        if available_sources():
            out.update(real_checks(real_report(model, dtype)))
        return out
    photo = heldout(HELDOUT_PHOTO_SEED, True, device)
    if family_name == "diffusion-restore":
        return in_distribution_checks(diffusion_report(model, rich, photo, dtype, device))
    return in_distribution_checks(sr_report(family_name, model, rich, photo, dtype))
