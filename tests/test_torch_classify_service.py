"""PyTorch port: ``classify_scores`` and ``ClassifierService`` against the
JAX package's, on the CPU.

The seven scores of JPEG and PNG uploads (clean, dark, noisy, blurred,
colour-shifted, compressed, scratched and a non-square photo) through both
packages: ``classify_scores`` on the decoded pixels and
``ClassifierService.analyze`` on the encoded bytes, atol 1e-4. The stencils
round to bytes, and f32 sums run in other orders in XLA and PyTorch, so a
variance may move in its last digits; the scores' normalisations keep that
far below the bar."""

import numpy as np
import pytest
import torch

import fixtures
from image_restoration_platform_tpu import imageio as jimageio
from image_restoration_platform_tpu.classify import ClassifierService as JClassifier
from image_restoration_platform_tpu.classify import classify_scores as jclassify
from image_restoration_platform_tpu_torch.classify import DEGRADATION_ORDER, ClassifierService, classify_scores
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

ATOL = 1e-4

UPLOADS = {
    "clean_jpeg": lambda: fixtures.create_clean_image((96, 80)),
    "dark_jpeg": lambda: fixtures.create_dark_image((64, 64)),
    "noisy_jpeg": lambda: fixtures.create_noisy_image((80, 96)),
    "blurred_jpeg": lambda: fixtures.create_blurred_image((64, 72)),
    "shifted_jpeg": lambda: fixtures.create_color_shifted_image((72, 64)),
    "compressed_jpeg": lambda: fixtures.create_compressed_image((96, 96)),
    "scratched_png": lambda: jimageio.encode_png(
        jimageio.decode_image(fixtures.create_scratched_image((96, 96))).pixels),
    "photo_png": lambda: fixtures.create_png_image((70, 110)),
}


@pytest.mark.parametrize("name", sorted(UPLOADS))
def test_classify_scores_match_jax(name):
    decoded = jimageio.decode_image(UPLOADS[name]())
    is_jpeg = decoded.format == "jpeg"
    ref = {k: float(v) for k, v in jclassify(decoded.pixels, is_jpeg).items()}
    port = classify_scores(torch.from_numpy(decoded.pixels), is_jpeg)
    assert set(port) == set(DEGRADATION_ORDER) == set(ref)
    for k in DEGRADATION_ORDER:
        assert port[k].dtype == torch.float32 and port[k].ndim == 0
        assert abs(float(port[k]) - ref[k]) <= ATOL, (k, float(port[k]), ref[k])


def test_analyze_matches_jax_on_encoded_uploads():
    port_svc, ref_svc = ClassifierService(device="cpu"), JClassifier()
    fired = set()
    for name, make in sorted(UPLOADS.items()):
        data = make()
        ref, port = ref_svc.analyze(data), port_svc.analyze(data)
        assert set(port) == set(ref), name
        for k, v in ref.items():
            assert isinstance(port[k], float) and abs(port[k] - v) <= ATOL, (name, k, port[k], v)
        fired |= {k for k, v in ref.items() if v > 0.3}
    # the fixtures exercise most of the scores, not only their zero branches
    assert {"blur", "lowLight", "colorShift", "fade"} <= fired


def test_analyze_array_grey_and_alpha_inputs():
    svc = ClassifierService(device="cpu")
    grey = np.random.default_rng(0).integers(0, 256, (40, 48), dtype=np.uint8)
    rgba = np.dstack([np.repeat(grey[:, :, None], 3, axis=2), np.full((40, 48), 255, np.uint8)])
    assert svc.analyze_array(grey, "png") == svc.analyze_array(rgba, "png")
    ref = JClassifier().analyze_array(grey, "png")
    for k, v in svc.analyze_array(grey, "png").items():
        assert abs(v - ref[k]) <= ATOL, k


def test_classifier_service_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassifierService()
    assert ClassifierService(device="cpu").device.type == "cpu"
