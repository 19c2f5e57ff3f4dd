"""PyTorch port: the quality gates of tests/test_quality.py on the shipped
weights, through the port (eval/gates.py).

Two sets of the reference's 11 cases, at its thresholds:

1. On the JAX package's own held-out arrays (``synthetic_batch`` at the gate
   seeds, the near-clean draws, the smooth batch, the diffusion noise of
   ``PRNGKey(0)``), the port's value must pass the gate and stay close to
   the reference's on the same inputs. Every gain (flagship, SR over
   nearest, diffusion) is held within 0.2 dB of the reference as its test
   runs it in bf16, and within 0.01 dB in f32 (the JAX side at
   ``precision=HIGHEST``: the gap is round-off). The cases whose number is
   no gain but the output's own distance to the clean image (the near-clean
   output PSNR and mean absolute error, the smooth case's PSNR and Laplacian
   energy) read the bf16 rounding of the output itself: XLA keeps f32
   inside its fusions and rounds the final residual add once, eager PyTorch
   rounds after every op, which moves a 44 dB output by 0.29 dB and the
   smooth Laplacian energy by 23-37 %. In bf16 they are held to the
   reference compiled with ``xla_allow_excess_precision=False`` (rounding
   after every op, as tests/test_torch_train_bf16.py does): PSNR within
   0.2 dB, levels within 0.05; in f32 to the default reference within
   0.01 dB and 0.005 levels.
2. On the port's own draws at the gate seeds (``eval.gates.heldout``,
   ``near_clean``, ``diffusion_noise``: the port's ``synthetic_batch`` and
   cleans from a seeded torch.Generator on the CPU), the port in bf16 must
   pass the same gates; these are the inputs chip_smoke.py gates on the card.
"""

import jax
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.models import get_family as jget_family
from image_restoration_platform_tpu_torch.eval import gates as G
from image_restoration_platform_tpu_torch.eval.common import load_model, psnr
from torch_quality_reference import BF16, F32, Reference, diffusion_noise, jax_heldout, jax_near_clean, sr_gain

torch.set_num_threads(2)
DB_BAR = {BF16: 0.2, F32: 0.01}
LEVELS_BAR = {BF16: 0.05, F32: 0.005}


@pytest.fixture(scope="module")
def ref():
    return Reference()


@pytest.fixture(scope="module")
def port():
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cache[(name, dtype)] = load_model(name, "cpu", dtype)
        return cache[(name, dtype)]

    return get


@pytest.fixture(scope="module")
def heldout():
    return jax_heldout(G.HELDOUT_SEED, False)


@pytest.fixture(scope="module")
def heldout_photo():
    return jax_heldout(G.HELDOUT_PHOTO_SEED, True)


def _close(port_value, ref_value, dtype, bar=DB_BAR):
    assert abs(port_value - ref_value) <= bar[dtype], (port_value, ref_value, dtype)


# ------------------------------------------------- 1. the reference's inputs


def test_flagship_restoration_gain(ref, port, heldout):
    degraded, clean, cond = heldout
    for dtype in (BF16, F32):
        want = psnr(ref.apply("restore-unet", dtype, degraded, cond), clean) - psnr(degraded, clean)
        got = G.flagship_gain(port("restore-unet", dtype), degraded, clean, cond, dtype)
        if dtype == BF16:
            assert got > G.FLAGSHIP_GAIN_MIN, f"flagship gain {got:.2f} dB below gate"
        _close(got, want, dtype)


@pytest.mark.parametrize("seed", G.NEAR_CLEAN_SEEDS)
def test_flagship_bounded_harm_on_near_clean(ref, port, seed):
    near, clean, cond = jax_near_clean(seed)
    for dtype in (BF16, F32):
        pred = ref.apply("restore-unet", dtype, near, cond, excess=dtype == F32)
        want_psnr, want_mad = psnr(pred, clean), float(np.mean(np.abs(pred - clean))) * 255.0
        got_psnr, got_mad = G.near_clean_harm(port("restore-unet", dtype), near, clean, dtype)
        if dtype == BF16:
            assert got_psnr >= G.NEAR_CLEAN_PSNR_MIN, f"bounded-harm violated: out {got_psnr:.2f} dB"
            assert got_mad <= G.NEAR_CLEAN_MAD_MAX, f"mean abs error {got_mad:.2f}/255"
        _close(got_psnr, want_psnr, dtype)
        _close(got_mad, want_mad, dtype, LEVELS_BAR)


@pytest.mark.parametrize("name", ["sr-x2", "sr-x4"])
def test_sr_beats_nearest_baseline(ref, port, heldout, name):
    degraded, clean, _ = heldout
    for dtype in (BF16, F32):
        got = G.sr_gain_over_nearest(port(name, dtype), degraded, clean, dtype)
        if dtype == BF16:
            assert got > G.SR_GAIN_MIN["rich"], f"{name} gain over nearest {got:.2f} dB below gate"
        _close(got, sr_gain(ref, name, degraded, clean, dtype), dtype)


@pytest.mark.parametrize("name", ["sr-x2", "sr-x4"])
def test_sr_photo_distribution_gain(ref, port, heldout_photo, name):
    degraded, clean, _ = heldout_photo
    for dtype in (BF16, F32):
        got = G.sr_gain_over_nearest(port(name, dtype), degraded, clean, dtype)
        if dtype == BF16:
            assert got > G.SR_GAIN_MIN["photo"], f"{name} photo-distribution gain {got:.2f} dB below gate"
        _close(got, sr_gain(ref, name, degraded, clean, dtype), dtype)


@pytest.mark.parametrize("name", ["sr-x2", "sr-x4"])
def test_sr_no_texture_hallucination_on_smooth(ref, port, name):
    scale = jget_family(name).config.scale
    hr = G.smooth_gate_batch()
    n, size = hr.shape[0], hr.shape[1]
    lr = hr.reshape(n, size // scale, scale, size // scale, scale, 3).mean(axis=(2, 4))
    for dtype in (BF16, F32):
        got = G.sr_smooth(port(name, dtype), dtype)
        if dtype == BF16:
            assert G.smooth_holds(got), f"{name} on smooth content: {got}"
        pred = ref.apply(name, dtype, lr, excess=dtype == F32)
        _close(got["sr_psnr"], psnr(pred, hr), dtype)
        _close(got["hf_pred"], G.hf_energy(pred), dtype, LEVELS_BAR)


@pytest.mark.parametrize("dist_fixture,gate", [("heldout", "rich"), ("heldout_photo", "photo")])
def test_diffusion_restoration_gain(request, ref, port, dist_fixture, gate):
    degraded, clean, cond = request.getfixturevalue(dist_fixture)
    for dtype in (BF16, F32):
        want = psnr(ref.apply("diffusion-restore", dtype, degraded, cond, jax.random.PRNGKey(0)), clean)
        want -= psnr(degraded, clean)
        got = G.diffusion_gain(port("diffusion-restore", dtype), degraded, clean, cond,
                               diffusion_noise(degraded.shape, dtype), dtype)
        if dtype == BF16:
            assert got > G.DIFFUSION_GAIN_MIN[gate], f"diffusion {dist_fixture} gain {got:.2f} dB below gate"
        _close(got, want, dtype)


# ------------------------------------------------------ 2. the port's draws


def test_port_draws_flagship_restoration_gain(port):
    degraded, clean, cond = G.heldout(G.HELDOUT_SEED, False, "cpu")
    gain = G.flagship_gain(port("restore-unet", BF16), degraded, clean, cond, BF16)
    assert gain > G.FLAGSHIP_GAIN_MIN, f"flagship gain {gain:.2f} dB below gate"


@pytest.mark.parametrize("seed", G.NEAR_CLEAN_SEEDS)
def test_port_draws_bounded_harm_on_near_clean(port, seed):
    near, clean = G.near_clean(seed, "cpu")
    out_psnr, mad = G.near_clean_harm(port("restore-unet", BF16), near, clean, BF16)
    assert out_psnr >= G.NEAR_CLEAN_PSNR_MIN, f"bounded-harm violated: out {out_psnr:.2f} dB"
    assert mad <= G.NEAR_CLEAN_MAD_MAX, f"mean abs error {mad:.2f}/255"


@pytest.mark.parametrize("name", ["sr-x2", "sr-x4"])
@pytest.mark.parametrize("dist", ["rich", "photo"])
def test_port_draws_sr_beats_nearest(port, name, dist):
    seed = G.HELDOUT_SEED if dist == "rich" else G.HELDOUT_PHOTO_SEED
    degraded, clean, _ = G.heldout(seed, dist == "photo", "cpu")
    gain = G.sr_gain_over_nearest(port(name, BF16), degraded, clean, BF16)
    assert gain > G.SR_GAIN_MIN[dist], f"{name} {dist} gain over nearest {gain:.2f} dB below gate"


@pytest.mark.parametrize("name", ["sr-x2", "sr-x4"])
def test_port_sr_no_texture_hallucination_on_smooth_bf16(port, name):
    result = G.sr_smooth(port(name, BF16), BF16)
    assert G.smooth_holds(result), f"{name} on smooth content: {result}"


@pytest.mark.parametrize("dist", ["rich", "photo"])
def test_port_draws_diffusion_restoration_gain(port, dist):
    seed = G.HELDOUT_SEED if dist == "rich" else G.HELDOUT_PHOTO_SEED
    degraded, clean, cond = G.heldout(seed, dist == "photo", "cpu")
    noise = G.diffusion_noise(degraded.shape, "cpu", BF16)
    gain = G.diffusion_gain(port("diffusion-restore", BF16), degraded, clean, cond, noise, BF16)
    assert gain > G.DIFFUSION_GAIN_MIN[dist], f"diffusion {dist} gain {gain:.2f} dB below gate"


def test_in_distribution_report_is_the_gates(port):
    """``in_distribution_report`` (what chip_smoke.py runs on the card) reads
    the same values as the cases above on the same draws."""
    models = {n: port(n, BF16) for n in ("restore-unet", "sr-x2", "sr-x4", "diffusion-restore")}
    report = G.in_distribution_report(models, BF16, "cpu")
    assert G.in_distribution_failures(report) == []
    degraded, clean, cond = G.heldout(G.HELDOUT_SEED, False, "cpu")
    assert report["flagship_gain"] == G.flagship_gain(models["restore-unet"], degraded, clean, cond, BF16)


def test_chip_smoke_holds_every_gate_value_to_the_cpu_run():
    """chip_smoke.py's phase 8 holds every value of a gate report, nested
    ones too, to the CPU run: levels for the MADs and Laplacian energies,
    dB for the rest."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = {"flagship_gain": 18.9, "near_clean_555_mad": 0.8,
           "sr-x2_smooth": {"sr_psnr": 49.3, "nearest_psnr": 44.4, "hf_pred": 0.9, "hf_true": 0.3}}
    card = {"flagship_gain": 18.95, "near_clean_555_mad": 0.81,
            "sr-x2_smooth": {"sr_psnr": 49.3, "nearest_psnr": 44.4, "hf_pred": 0.95, "hf_true": 0.3}}
    gaps = smoke.quality_gaps(card, cpu, 0.02)
    assert set(gaps) == {"flagship_gain", "near_clean_555_mad", "sr-x2_smooth.sr_psnr", "sr-x2_smooth.nearest_psnr",
                         "sr-x2_smooth.hf_pred", "sr-x2_smooth.hf_true"}
    bars = {k: bar for k, (_gap, bar) in gaps.items()}
    assert bars["near_clean_555_mad"] == bars["sr-x2_smooth.hf_pred"] == smoke.QUALITY_CPU_LEVELS
    assert bars["flagship_gain"] == bars["sr-x2_smooth.sr_psnr"] == 0.02
    assert sorted(k for k, (gap, bar) in gaps.items() if not gap <= bar) == ["flagship_gain", "sr-x2_smooth.hf_pred"]
