"""PyTorch port: masked classification, conditioning and stencils against
classify/fused.py and ops/stencil.py of the JAX package.

Scores are f32 reductions over up to 65k pixels summed in another order,
so the bar is atol 1e-4; the 28-dim conditioning (selection by threshold,
stable descending rank and severity) is held to the same bar, and exactly
on hand-made tie cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.classify import classifier as jclassifier
from image_restoration_platform_tpu.classify import fused as jfused
from image_restoration_platform_tpu.ops import stencil as jstencil
from image_restoration_platform_tpu_torch.classify import DEGRADATION_ORDER
from image_restoration_platform_tpu_torch.classify import fused as tfused
from image_restoration_platform_tpu_torch.ops import stencil as tstencil

torch.set_num_threads(2)


def _canvases(seed: int, n: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = []
    for i in range(n):
        base = 128 + 90 * np.sin(6.0 * (xx * (i + 1) + yy * 0.7))[..., None] * rng.uniform(0.2, 1.0, 3)
        img = base * rng.uniform(0.3, 1.0) + rng.normal(0, 4 + 10 * i, (size, size, 3))
        out.append(np.clip(np.round(img), 0, 255))
    return np.stack(out).astype(np.float32)


def test_degradation_order_is_the_reference_layout():
    assert DEGRADATION_ORDER == jclassifier.DEGRADATION_ORDER


@pytest.mark.parametrize("size", [64, 256])
def test_scores_and_conditioning_match(size):
    canvas = _canvases(size, 4, size)
    valid = np.asarray([[size, size], [size // 2, size - 8], [size - 1, size // 3], [40, 40]], np.int32)
    is_jpeg = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    ref_s, ref_c = jfused.batch_classify_and_condition(jnp.asarray(canvas), jnp.asarray(valid), jnp.asarray(is_jpeg))
    got_s, got_c = tfused.batch_classify_and_condition(
        torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(is_jpeg)
    )
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "scores",
    [
        [0.5, 0.5, 0.5, 0.5, 0.2, 0.8, 0.31],  # ties: the stable rank keeps index order
        [0.3, 0.3, 0.31, 0.7, 0.69, 0.5, 0.49],  # the 0.3 / 0.5 / 0.7 edges
        [0.0] * 7,
        [1.0] * 7,
    ],
)
def test_conditioning_ties_and_edges(scores):
    s = np.asarray([scores], np.float32)
    ref = np.asarray(jax.vmap(jfused.conditioning_from_scores)(jnp.asarray(s)))
    got = tfused.conditioning_from_scores(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kernel", ["K_LAPLACIAN8", "K_HIGHPASS9", "K_LAPLACIAN4"])
def test_stencils_are_exact(kernel):
    gray = np.random.default_rng(1).integers(0, 256, (40, 36)).astype(np.float32)
    ref = jstencil.conv3x3_clamped_u8(jnp.asarray(gray), getattr(jstencil, kernel))
    got = tstencil.conv3x3_clamped_u8(torch.from_numpy(gray)[None], getattr(tstencil, kernel))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gaussian_blur_and_grayscale():
    img = np.random.default_rng(2).integers(0, 256, (2, 24, 20, 3)).astype(np.float32)
    ref = np.stack([np.asarray(jstencil.gaussian_blur(jnp.asarray(im), 1.0)) for im in img])
    np.testing.assert_allclose(tstencil.gaussian_blur(torch.from_numpy(img), 1.0).numpy(), ref, rtol=0, atol=1e-4)
    ref_g = np.stack([np.asarray(jstencil.grayscale(jnp.asarray(im))) for im in img])
    np.testing.assert_array_equal(tstencil.grayscale(torch.from_numpy(img)).numpy(), ref_g)
