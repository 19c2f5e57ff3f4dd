"""PyTorch port: the out-of-distribution quality gates of
tests/test_quality_ood.py on the shipped flagship, through the port's
serving inference path (eval/common.py:serving_forward: u8 canvas ->
classify -> deblock -> deblur -> re-condition -> backbone in bf16).

The 8 cases of the reference at its thresholds (eval/gates.py), on the same
numpy inputs (train/ood.py draws from numpy in both packages): each class's
aggregate gain and the motion class's per-image mean gain within 0.2 dB of
the reference's serving fixture as its test runs it; the clean-harm case's
per-image mean absolute errors (levels, the output's own rounding, no gain)
within 0.05 levels of the reference compiled with XLA's excess precision
off, which rounds after every op as eager PyTorch does (see
tests/test_torch_quality.py)."""

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch.eval import gates as G
from image_restoration_platform_tpu_torch.eval.common import load_model, psnr
from image_restoration_platform_tpu_torch.train.ood import ood_clean, ood_eval_batch
from torch_quality_reference import ood_reference

torch.set_num_threads(2)
BF16 = torch.bfloat16
DB_BAR, LEVELS_BAR = 0.2, 0.05


@pytest.fixture(scope="module")
def reference():
    return ood_reference()


@pytest.fixture(scope="module")
def model():
    return load_model("restore-unet", "cpu", BF16)


@pytest.mark.parametrize("name", sorted(G.OOD_GATES))
def test_flagship_ood_gain(reference, model, name):
    degraded, clean = ood_eval_batch(G.OOD_SEED, G.N, G.SIZE, name)
    got = G.ood_gain("restore-unet", model, name, BF16)
    assert got > G.OOD_GATES[name], f"{name}: OOD gain {got:.2f} dB below gate {G.OOD_GATES[name]}"
    want = psnr(reference(degraded), clean) - psnr(degraded, clean)
    assert abs(got - want) <= DB_BAR, (name, got, want)


def test_flagship_motion_deblur_gain(reference, model):
    degraded, clean = ood_eval_batch(G.OOD_SEED, G.N, G.SIZE, "motion")
    got = G.ood_motion_per_image("restore-unet", model, BF16)
    assert got >= G.MOTION_MEAN_MIN, f"motion per-image mean gain {got:.2f} dB < {G.MOTION_MEAN_MIN}"
    pred = reference(degraded)
    want = float(np.mean([psnr(pred[i], clean[i]) - psnr(degraded[i], clean[i]) for i in range(G.N)]))
    assert abs(got - want) <= DB_BAR, (got, want)


def test_flagship_ood_clean_no_harm(reference, model):
    mean_mad, worst_mad = G.ood_clean_harm("restore-unet", model, BF16)
    assert mean_mad < G.OOD_CLEAN_MEAN_MAX, f"mean OOD clean harm {mean_mad:.2f}/255"
    assert worst_mad < G.OOD_CLEAN_WORST_MAX, f"worst OOD clean harm {worst_mad:.2f}/255"
    clean = ood_clean(np.random.default_rng(G.OOD_CLEAN_SEED), G.N, G.SIZE)
    per_mad = np.mean(np.abs(reference(clean, excess=False) - clean), axis=(1, 2, 3)) * 255.0
    assert abs(mean_mad - per_mad.mean()) <= LEVELS_BAR, (mean_mad, per_mad.mean())
    assert abs(worst_mad - per_mad.max()) <= LEVELS_BAR, (worst_mad, per_mad.max())
