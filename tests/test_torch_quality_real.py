"""PyTorch port: the real-photograph quality gates of
tests/test_quality_real.py on the shipped flagship, through the port.

The 7 cases of the reference at its thresholds (eval/gates.py): real photos
found under the interpreter's site-packages (train/realphoto.py) through the
OOD degradation physics, conditioned by the classifier on the input and
restored in bf16 with no stages (eval/common.py:classified_forward, the
reference fixture's path). They skip, as the reference's do, where no
real-photo source is present (the card's machine has none). Each gain is
held within 0.2 dB of the reference's fixture as its test runs it."""

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch.eval import gates as G
from image_restoration_platform_tpu_torch.eval.common import classified_forward, host, load_model, psnr
from image_restoration_platform_tpu_torch.train.realphoto import available_sources, real_clean_patches, real_eval_batch
from torch_quality_reference import real_reference

torch.set_num_threads(2)
BF16 = torch.bfloat16
DB_BAR = 0.2


@pytest.fixture(scope="module")
def serve():
    if not available_sources():
        pytest.skip("no real-photo sources on this machine")
    model = load_model("restore-unet", "cpu", BF16)
    return real_reference(), lambda x: host(classified_forward(model, x, BF16))


@pytest.mark.parametrize("degradation,min_gain", list(G.REAL_GATES.items()))
def test_real_photo_gain(serve, degradation, min_gain):
    reference, port = serve
    degraded, clean = real_eval_batch(G.REAL_SEED, G.N, G.SIZE, degradation)
    got = psnr(port(degraded), clean) - psnr(degraded, clean)
    assert got >= min_gain, f"{degradation}: gain {got:+.2f} dB < {min_gain:+.2f}"
    want = psnr(reference(degraded), clean) - psnr(degraded, clean)
    assert abs(got - want) <= DB_BAR, (degradation, got, want)


def test_real_photo_clean_harm_bounded(serve):
    _reference, port = serve
    clean = real_clean_patches(np.random.default_rng(G.REAL_SEED + 1), G.N, G.SIZE)
    per_mad = G.per_image_mad(port(clean), clean)
    assert per_mad.mean() <= G.REAL_CLEAN_MEAN_MAX, f"mean clean mad {per_mad.mean():.2f}/255"
    assert per_mad.max() <= G.REAL_CLEAN_WORST_MAX, f"worst clean mad {per_mad.max():.2f}/255"
