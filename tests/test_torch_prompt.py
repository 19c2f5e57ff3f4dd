"""PyTorch port: the prompt enhancer (prompt/enhancer.py) and the service
factories.

Counterparts of the 7 tests of tests/test_prompt.py on the port's
``PromptEnhancerService`` and ``conditioning_vector``; the host
conditioning held to the device conditioning of the restore program
(classify/fused.py:conditioning_from_scores) on the same scores, as
tests/test_fused.py holds the reference's, and to the reference's host
vector; ``enhance_with_conditioning``, ``get_degradation_templates`` and the
``create_*_service`` factories of the prompt, classifier and restorator
modules."""

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.prompt import PromptEnhancerService as JPromptEnhancerService
from image_restoration_platform_tpu.prompt import conditioning_vector as jconditioning_vector
from image_restoration_platform_tpu_torch.classify import (
    DEGRADATION_ORDER,
    ClassifierService,
    create_classifier_service,
    scores_to_vector,
)
from image_restoration_platform_tpu_torch.classify.fused import conditioning_from_scores
from image_restoration_platform_tpu_torch.prompt import (
    COND_DIM,
    PromptEnhancerService,
    conditioning_vector,
    create_prompt_enhancer_service,
)
from image_restoration_platform_tpu_torch.serve import RestoratorService, create_restorator_service

BASE = {
    "blur": 0.1,
    "noise": 0.1,
    "lowLight": 0.1,
    "compression": 0.1,
    "scratch": 0.1,
    "fade": 0.1,
    "colorShift": 0.1,
}


def test_prioritizes_top_issues_and_tailors_instructions():
    service = PromptEnhancerService()
    degradation = {**BASE, "blur": 0.82, "noise": 0.81, "colorShift": 0.76, "fade": 0.55}

    enhanced = service.enhance(degradation, "Repair and restore the family portrait")

    assert "reduce severe motion blur" in enhanced
    assert "aggressively suppress grain" in enhanced
    assert "correct severe color cast" in enhanced
    assert "Repair and restore the family portrait" in enhanced
    # fade (4th issue) must NOT be included: top-3 only
    assert "enhance color vibrancy" not in enhanced


def test_defaults_to_subtle_enhancements():
    service = PromptEnhancerService()
    enhanced = service.enhance(dict(BASE))
    assert "Quality guidelines" in enhanced
    assert "subtle enhancements only" in enhanced


def test_truncates_long_prompts():
    service = PromptEnhancerService()
    degradation = {**BASE, "blur": 0.9}
    enhanced = service.enhance(degradation, "enhance " * 300)
    assert len(enhanced) <= 1000
    assert "User request:" in enhanced
    assert enhanced.endswith("...")


def test_severity_boundaries():
    service = PromptEnhancerService()
    # 0.5 -> medium, 0.7 -> high, 0.31 -> low
    assert "reduce motion blur and improve focus clarity" in service.enhance({**BASE, "blur": 0.5})
    assert "reduce severe motion blur" in service.enhance({**BASE, "blur": 0.7})
    assert "slightly enhance sharpness" in service.enhance({**BASE, "blur": 0.31})


def test_high_severity_note():
    service = PromptEnhancerService()
    enhanced = service.enhance({**BASE, "scratch": 0.95})
    assert "significant restoration work" in enhanced


def test_validate_degradation():
    PromptEnhancerService.validate_degradation(dict(BASE))
    with pytest.raises(ValueError):
        PromptEnhancerService.validate_degradation({**BASE, "blur": 1.5})
    missing = dict(BASE)
    missing.pop("fade")
    with pytest.raises(ValueError):
        PromptEnhancerService.validate_degradation(missing)


def test_conditioning_vector_layout():
    vec = conditioning_vector({**BASE, "blur": 0.82, "noise": 0.55})
    assert vec.shape == (COND_DIM,)
    assert vec.dtype == np.float32
    # raw scores occupy the first 7 slots (blur is index 0)
    assert vec[0] == np.float32(0.82)
    # blur(high) one-hot: offset 7 + 0*3 + 2
    assert vec[7 + 2] == np.float32(0.82)
    # noise(medium): offset 7 + 1*3 + 1
    assert vec[7 + 3 + 1] == np.float32(0.55)
    # unselected types contribute nothing to the one-hot region
    assert np.count_nonzero(vec[7:]) == 2


@pytest.mark.parametrize(
    "scores",
    [
        {"blur": 0.82, "noise": 0.81, "colorShift": 0.76, "fade": 0.55},
        {"blur": 0.31},
        {},
        {"blur": 0.5, "noise": 0.7, "lowLight": 0.69, "scratch": 0.35},
        {"blur": 1.0, "noise": 1.0, "lowLight": 1.0, "compression": 1.0},
    ],
)
def test_host_conditioning_matches_device_and_reference(scores):
    degradation = {**BASE, **scores}
    host = conditioning_vector(degradation)
    device = conditioning_from_scores(torch.from_numpy(scores_to_vector(degradation)[None])).numpy()[0]
    np.testing.assert_allclose(device, host, atol=1e-6)
    np.testing.assert_array_equal(host, jconditioning_vector(degradation))


def test_enhance_with_conditioning_and_templates():
    service = create_prompt_enhancer_service()
    degradation = {**BASE, "blur": 0.82, "noise": 0.55}
    text, vec = service.enhance_with_conditioning(degradation, "a portrait")
    ref_text, ref_vec = JPromptEnhancerService().enhance_with_conditioning(degradation, "a portrait")
    assert text == ref_text == service.enhance(degradation, "a portrait")
    np.testing.assert_array_equal(vec, ref_vec)
    templates = service.get_degradation_templates()
    assert templates == JPromptEnhancerService.get_degradation_templates()
    templates["blur"]["high"] = "changed"  # a copy: the module's table stays
    assert "reduce severe motion blur" in service.enhance({**BASE, "blur": 0.9})


def test_service_factories():
    assert list(scores_to_vector({k: i / 10 for i, k in enumerate(DEGRADATION_ORDER)})) == pytest.approx(
        [i / 10 for i in range(7)])
    classifier = create_classifier_service(device="cpu")
    assert isinstance(classifier, ClassifierService) and classifier.device.type == "cpu"
    restorator = create_restorator_service(device="cpu")
    assert isinstance(restorator, RestoratorService) and restorator.engine.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_classifier_service()
