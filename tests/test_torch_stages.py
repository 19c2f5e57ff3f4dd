"""PyTorch port: the gated deblock and deblur stages against ops/deblock.py
and ops/deblur.py of the JAX package, on the kinds of inputs
tests/test_deblock.py and tests/test_deblur.py build.

Fire decisions must be equal; off-fire output must be the same bytes as the
input; on-fire output within 1 byte level (f32 DCT/FFT round-off before one
u8 rounding). The JAX side runs at ``precision=HIGHEST``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu import imageio as jimageio
from image_restoration_platform_tpu.classify import fused as jfused
from image_restoration_platform_tpu.ops import deblock as JK
from image_restoration_platform_tpu.ops import deblur as JD
from image_restoration_platform_tpu.train.ood import deg_jpeg, ood_clean
from image_restoration_platform_tpu_torch.classify import fused as tfused
from image_restoration_platform_tpu_torch.ops import deblock as TK
from image_restoration_platform_tpu_torch.ops import deblur as TD
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

torch.set_num_threads(2)


def _photo(seed: int, size: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack(
        [0.45 + 0.35 * np.sin(6.3 * (xx * f1 + yy * f2)) for f1, f2 in ((1.0, 0.4), (0.6, 1.3), (0.2, 0.9))],
        axis=-1,
    )
    img += 0.25 * (yy[..., None] > 0.5)
    img += rng.normal(0.0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _u8(img01: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img01 * 255.0), 0, 255).astype(np.uint8)


def _jpeg(img01: np.ndarray, quality: int) -> np.ndarray:
    return jimageio.decode_image(jimageio.encode_jpeg(_u8(img01), quality=quality)).pixels


def _fft_convolve(x, psf):
    h, w = x.shape[:2]
    pad = np.zeros((h, w), np.float32)
    pad[: psf.shape[0], : psf.shape[1]] = psf
    otf = np.fft.rfft2(np.roll(pad, (-(psf.shape[0] // 2), -(psf.shape[1] // 2)), axis=(0, 1)))
    return np.stack([np.fft.irfft2(np.fft.rfft2(x[..., c]) * otf, s=(h, w)) for c in range(3)], -1)


def _deblock_batch():
    rng = np.random.default_rng(7)
    imgs = [
        _jpeg(_photo(0), 20),
        _jpeg(_photo(10), 10),
        _jpeg(_photo(40), 40),
        _u8(_photo(1)),  # clean
        _u8(np.clip(_photo(2) + rng.normal(0, 0.08, (128, 128, 3)), 0, 1)),  # noisy
        _jpeg(_photo(3), 85),  # high quality: silent
    ]
    return np.stack(imgs)


def _pair(fn_jax, fn_torch, canvas, valid):
    with jax.default_matmul_precision("highest"):
        ref = fn_jax(jnp.asarray(canvas), jnp.asarray(valid))
    got = fn_torch(torch.from_numpy(canvas), torch.from_numpy(valid))
    return ref, got


def test_deblock_lambda_and_fire_decisions_match():
    canvas = _deblock_batch()
    valid = np.tile(np.asarray([[128, 128]], np.int32), (len(canvas), 1))
    lam_ref, lam = _pair(JK.deblock_lambda, TK.deblock_lambda, canvas.astype(np.float32), valid)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), rtol=0, atol=1e-6)
    (out_ref, fire_ref), (out, fire) = _pair(JK.deblock_canvas_batch, TK.deblock_canvas_batch, canvas, valid)
    assert fire.tolist() == np.asarray(fire_ref).tolist() == [True, True, True, False, False, False]
    for i in range(len(canvas)):
        if not fire[i]:
            assert torch.equal(out[i], torch.from_numpy(canvas[i]))
    diff = np.abs(out.numpy().astype(np.int32) - np.asarray(out_ref).astype(np.int32))
    assert diff.max() <= 1


def test_deblock_respects_valid_region():
    canvas = np.zeros((1, 192, 192, 3), np.uint8)
    canvas[0, :128, :128] = _jpeg(_photo(4), 15)
    valid = np.asarray([[128, 128]], np.int32)
    (_, fire_ref), (_, fire) = _pair(JK.deblock_canvas_batch, TK.deblock_canvas_batch, canvas, valid)
    assert bool(fire[0]) and bool(fire_ref[0])


def test_deblock_tiny_canvas_passthrough():
    canvas = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (1, 32, 32, 3), np.uint8))
    out, fire = TK.deblock_canvas_batch(canvas, torch.tensor([[32, 32]], dtype=torch.int32))
    assert out is canvas and not bool(fire[0])


def test_deblock_and_recondition_matches():
    canvas = np.stack([_jpeg(_photo(11), 15), _u8(_photo(12))])
    valid = np.asarray([[128, 128], [128, 128]], np.int32)
    is_jpeg = np.asarray([1.0, 0.0], np.float32)
    with jax.default_matmul_precision("highest"):
        s, c = jfused.batch_classify_and_condition(jnp.asarray(canvas, jnp.float32), jnp.asarray(valid), jnp.asarray(is_jpeg))
        ref = JK.deblock_and_recondition(jnp.asarray(canvas), jnp.asarray(valid), jnp.asarray(is_jpeg), s, c)
    ts, tc = tfused.batch_classify_and_condition(torch.from_numpy(canvas).float(), torch.from_numpy(valid), torch.from_numpy(is_jpeg))
    got = TK.deblock_and_recondition(torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(is_jpeg), ts, tc)
    assert np.abs(got[0].numpy().astype(int) - np.asarray(ref[0]).astype(int)).max() <= 1
    assert torch.equal(got[0][1], torch.from_numpy(canvas[1]))  # the clean image: same bytes
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=0, atol=1e-4)


def _deblur_batch():
    rng = np.random.default_rng(21)
    imgs = []
    for i in range(6):
        clean = ood_clean(rng, 1, 128)[0]
        if i % 2 == 0:
            imgs.append(np.clip(_fft_convolve(clean, TD.motion_psf(9.0, 1.1)), 0, 1))
        else:
            imgs.append(clean)
    imgs.append(np.clip(deg_jpeg(rng, ood_clean(rng, 1, 128)[0]), 0, 1))
    return np.stack([_u8(x) for x in imgs])


def test_psf_bank_and_constants_are_the_references():
    for a, b in zip(TD.psf_bank()[:3], JD.psf_bank()[:3]):
        np.testing.assert_array_equal(a, b)
    ct, cj = TD.analysis_constants(), JD.analysis_constants()
    for key in ("log_t_res", "t_norm", "null_w", "rest_w", "binmat", "hann", "wmask"):
        np.testing.assert_array_equal(ct[key], cj[key])


def test_deblur_fire_decisions_match():
    canvas = _deblur_batch()
    valid = np.tile(np.asarray([[128, 128]], np.int32), (len(canvas), 1))
    comp = np.asarray([0, 0, 0, 0, 0, 0, 0.9], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JD.deblur_canvas_batch(jnp.asarray(canvas), jnp.asarray(valid), jnp.asarray(comp)))
    got = TD.deblur_canvas_batch(torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(comp)).numpy()
    fired_ref = [not np.array_equal(ref[i], canvas[i]) for i in range(len(canvas))]
    fired = [not np.array_equal(got[i], canvas[i]) for i in range(len(canvas))]
    assert fired == fired_ref
    assert any(fired) and not all(fired)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_deblur_select_hypothesis_matches():
    canvas = _deblur_batch()
    gray = canvas.astype(np.float32).mean(axis=-1) / 255.0
    valid = np.tile(np.asarray([[128, 128]], np.int32), (len(canvas), 1))
    comp = np.zeros((len(canvas),), np.float32)
    with jax.default_matmul_precision("highest"):
        best_ref, fire_ref = JD.select_hypothesis(jnp.asarray(gray), jnp.asarray(valid), jnp.asarray(comp))
    best, fire = TD.select_hypothesis(torch.from_numpy(gray), torch.from_numpy(valid), torch.from_numpy(comp))
    assert fire.tolist() == np.asarray(fire_ref).tolist()
    fired = np.asarray(fire_ref)
    assert best.numpy()[fired].tolist() == np.asarray(best_ref)[fired].tolist()


def test_deblur_letterboxed_canvas_fires_like_reference():
    rng = np.random.default_rng(55)
    clean = ood_clean(rng, 1, 160)[0]
    u8 = _u8(np.clip(_fft_convolve(clean, TD.motion_psf(9.0, 0.9)), 0, 1))
    canvas = np.pad(u8, ((0, 96), (0, 96), (0, 0)), mode="edge")[None]
    valid = np.asarray([[160, 160]], np.int32)
    comp = np.zeros((1,), np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JD.deblur_canvas_batch(jnp.asarray(canvas), jnp.asarray(valid), jnp.asarray(comp)))
    got = TD.deblur_canvas_batch(torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(comp)).numpy()
    assert not np.array_equal(got, canvas) and not np.array_equal(ref, canvas)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_deblur_and_recondition_matches():
    canvas = _deblur_batch()[:2]  # one motion-blurred, one clean
    valid = np.asarray([[128, 128], [128, 128]], np.int32)
    is_jpeg = np.zeros((2,), np.float32)
    with jax.default_matmul_precision("highest"):
        s, c = jfused.batch_classify_and_condition(jnp.asarray(canvas, jnp.float32), jnp.asarray(valid), jnp.asarray(is_jpeg))
        ref_canvas, ref_cond = JD.deblur_and_recondition(jnp.asarray(canvas), jnp.asarray(valid), jnp.asarray(is_jpeg), s, c)
    ts, tc = tfused.batch_classify_and_condition(torch.from_numpy(canvas).float(), torch.from_numpy(valid), torch.from_numpy(is_jpeg))
    got_canvas, got_cond = TD.deblur_and_recondition(torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(is_jpeg), ts, tc)
    assert not np.array_equal(np.asarray(ref_canvas[0]), canvas[0])  # the blurred one fired
    assert np.abs(got_canvas.numpy().astype(int) - np.asarray(ref_canvas).astype(int)).max() <= 1
    np.testing.assert_allclose(got_cond.numpy(), np.asarray(ref_cond), rtol=0, atol=1e-4)


def test_deblur_small_canvas_passthrough():
    tiny = torch.from_numpy((np.random.default_rng(41).random((2, 64, 64, 3)) * 255).astype(np.uint8))
    out = TD.deblur_canvas_batch(tiny, torch.tensor([[64, 64]] * 2, dtype=torch.int32), torch.zeros(2))
    assert out is tiny


@pytest.mark.parametrize("n", [65536, 4096, 100, 7, 2])
def test_percentile_high_matches_numpy(n):
    x = np.random.default_rng(n).normal(size=(4, n)).astype(np.float32)
    for q in (99.0, 95.0, 90.0):
        ref = np.percentile(x.astype(np.float64), q, axis=1)
        got = TD._percentile_high(torch.from_numpy(x), q).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))
