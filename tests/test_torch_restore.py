"""PyTorch port: the whole restore program, the engine and the restorator.

The program at the 256 bucket with the shipped restore-unet weights, f32,
s2d_io, deblock and deblur on and yuv420 egress, against
``build_restore_program`` of the JAX package (run once, at
``precision=HIGHEST``, in a module fixture). Bars: Y/Cb/Cr within 1 byte
level (the stages' on-fire outputs are themselves within 1 level), scores
atol 1e-4. Then the engine's batch padding and meta keys, and one
RestoratorService + MicroBatcher round trip, all on ``device="cpu"``."""

import base64
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu import imageio as jimageio
from image_restoration_platform_tpu.models import ParamCache as JParamCache
from image_restoration_platform_tpu.ops import deblur as JD
from image_restoration_platform_tpu.serve.programs import build_restore_program as jbuild
from image_restoration_platform_tpu.train.ood import ood_clean
from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import ParamCache
from image_restoration_platform_tpu_torch.models.folded import fold_state
from image_restoration_platform_tpu_torch.ops.deblock import deblock_canvas_batch
from image_restoration_platform_tpu_torch.ops.deblur import deblur_canvas_batch
from image_restoration_platform_tpu_torch.serve import MicroBatcher, RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.programs import build_restore_program
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

torch.set_num_threads(2)

# the JAX engine's meta dict (serve/engine.py restore_batch_async)
META_KEYS = {"engineRequestId", "deviceSeconds", "wallSeconds", "fetchSeconds", "batchBucket",
             "batchOccupancy", "family"}


def _u8(img01):
    return np.clip(np.round(img01 * 255.0), 0, 255).astype(np.uint8)


def _fft_convolve(x, psf):
    h, w = x.shape[:2]
    pad = np.zeros((h, w), np.float32)
    pad[: psf.shape[0], : psf.shape[1]] = psf
    otf = np.fft.rfft2(np.roll(pad, (-(psf.shape[0] // 2), -(psf.shape[1] // 2)), axis=(0, 1)))
    return np.stack([np.fft.irfft2(np.fft.rfft2(x[..., c]) * otf, s=(h, w)) for c in range(3)], -1)


@pytest.fixture(scope="module")
def program_case():
    rng = np.random.default_rng(5)
    clean = ood_clean(rng, 3, 256)
    jpeg = jimageio.decode_image(jimageio.encode_jpeg(_u8(clean[0]), quality=15)).pixels
    blurred = _u8(np.clip(_fft_convolve(clean[1], JD.motion_psf(9.0, 0.9)), 0, 1))
    letterboxed = np.pad(_u8(clean[2])[:200, :160], ((0, 56), (0, 96), (0, 0)), mode="edge")
    canvas = np.stack([jpeg, blurred, letterboxed])
    valid = np.asarray([[256, 256], [256, 256], [200, 160]], np.int32)
    is_jpeg = np.asarray([1.0, 0.0, 0.0], np.float32)
    fn = jbuild("restore-unet", dtype=jnp.float32, use_folded=False, use_s2d_io=True,
                use_deblur=True, use_deblock=True, egress="yuv420")
    with jax.default_matmul_precision("highest"):
        planes, scores = fn(JParamCache(0).get("restore-unet"), jnp.asarray(canvas), jnp.asarray(valid),
                            jnp.asarray(is_jpeg))
        ref = ([np.asarray(p) for p in planes], np.asarray(scores))
    return canvas, valid, is_jpeg, ref


def test_program_256_matches_jax(program_case):
    canvas, valid, is_jpeg, (ref_planes, ref_scores) = program_case
    # the case covers both stages on fire: deblock on the JPEG, deblur on the blur
    c, v = torch.from_numpy(canvas[:2]), torch.from_numpy(valid[:2])
    assert deblock_canvas_batch(c, v)[1].tolist() == [True, False]
    assert not torch.equal(deblur_canvas_batch(c, v, torch.zeros(2))[1], c[1])
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(256,), max_batch=4))
    fn = build_restore_program("restore-unet", dtype=torch.float32, use_s2d_io=True, use_deblur=True,
                               use_deblock=True, egress="yuv420")
    model = engine.model("restore-unet", folded=False)  # the program of the reference's default layout
    planes, scores = fn(model, torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(is_jpeg))
    for got, ref, shape in zip(planes, ref_planes, [(3, 256, 256), (3, 128, 128), (3, 128, 128)]):
        assert tuple(got.shape) == shape and got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(scores.numpy(), ref_scores, rtol=0, atol=1e-4)


def test_engine_pads_to_bucket_and_reports_meta():
    cfg = ServingConfig(size_buckets=(64,), max_batch=4)
    engine = RestorationEngine(device="cpu", serving_config=cfg)
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    out, scores, meta = engine.restore_batch(canvas, family_name="restore-unet-small")
    assert out.shape == (3, 64, 64, 3) and out.dtype == np.uint8 and scores.shape == (3, 7)
    assert set(meta) == META_KEYS
    assert meta["batchBucket"] == 4 and meta["batchOccupancy"] == 0.75
    assert meta["family"] == "restore-unet-small" and meta["deviceSeconds"] >= 0
    # the padded rows change nothing: each image as a batch of one
    single, s1, meta1 = engine.restore_batch(canvas[1:2], family_name="restore-unet-small")
    assert meta1["batchBucket"] == 1
    assert np.abs(single[0].astype(int) - out[1].astype(int)).max() <= 1
    np.testing.assert_allclose(s1[0], scores[1], rtol=0, atol=1e-5)


def test_engine_yuv420_planes_match_rgb():
    cfg = ServingConfig(size_buckets=(64,), max_batch=2)
    engine = RestorationEngine(device="cpu", serving_config=cfg)
    canvas = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    (y, cb, cr), _, _ = engine.restore_batch(canvas, family_name="restore-unet", egress="yuv420")
    rgb, _, _ = engine.restore_batch(canvas, family_name="restore-unet", egress="rgb")
    assert y.shape == (2, 64, 64) and cb.shape == cr.shape == (2, 32, 32)
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    assert np.abs(y.astype(float) - luma).max() <= 1.0


@pytest.fixture(scope="module")
def service():
    cfg = ServingConfig(size_buckets=(64,), max_batch=4)
    engine = RestorationEngine(device="cpu", serving_config=cfg)
    batcher = MicroBatcher(engine, cfg, device="cpu")
    yield RestoratorService(engine=engine, batcher=batcher, serving_config=cfg, device="cpu")
    batcher.shutdown()


def test_restorator_with_batcher_round_trip(service):
    img = np.clip(np.random.default_rng(2).normal(60, 20, (48, 40, 3)), 0, 255).astype(np.uint8)
    result = service.restore(imageio.encode_jpeg(img, quality=90), user_prompt="restore this photo",
                             options={"model": "restore-unet-small"})
    assert result["success"] is True, result.get("error")
    assert set(result["timings"]) == {"classify_ms", "prompt_ms", "restore_ms", "total_ms"}
    scores = np.asarray(list(result["degradationAnalysis"].values()))
    assert scores.shape == (7,) and np.isfinite(scores).all()
    assert "restore this photo" in result["enhancedPrompt"]
    meta = result["metadata"]
    assert meta["sizeBucket"] == 64 and meta["model"] == "restore-unet-small"
    restored = imageio.decode_image(base64.b64decode(result["restoredImage"]))
    assert (restored.height, restored.width) == (48, 40)


def test_restorator_structured_failure(service):
    result = service.restore(b"not an image")
    assert result["success"] is False
    assert result["error"]["type"] == "INVALID_INPUT"
    assert result["metadata"]["failureStage"] == "CLASSIFICATION"


def _png16(rgb16: np.ndarray) -> bytes:
    h, w, _ = rgb16.shape

    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    be = rgb16.astype(">u2").tobytes()
    raw = b"".join(b"\x00" + be[y * w * 6:(y + 1) * w * 6] for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_restorator_refuses_what_is_not_ported(service, monkeypatch):
    """Nothing is refused any more: where the native codec exists a 16-bit
    PNG takes the HDR pre-pass, as in the reference; at 32 x 32 (under the
    pre-pass's 128 px analysis size) that is its fallback to the 8-bit path,
    the same answer as for the image's 8-bit pixels. The pre-pass itself, at
    128 px, is held against the reference in tests/test_torch_hdr.py."""
    png = _png16(np.full((32, 32, 3), 30000, np.uint16))
    assert jimageio.decode_bit_depth(png[:32]) == 16
    monkeypatch.setattr(imageio, "native_available", lambda: True)
    assert service._wants_hdr(png) and service._hdr_prepass(png) == (None, None)
    result = service.restore(png, options={"model": "restore-unet-small"})
    assert result["success"] is True, result.get("error")
    pixels = imageio.decode_image(png).pixels
    same = service.restore(pixels, options={"model": "restore-unet-small", "format": "png"})
    assert same["restoredImage"] == result["restoredImage"]


@pytest.mark.parametrize("case", ["png16-pillow-codec", "sr-x2", "diffusion-restore"])
def test_restorator_serves_what_it_used_to_refuse(service, monkeypatch, case):
    """Where the codec is Pillow a 16-bit PNG is served on the 8-bit path,
    as the reference serves it; the SR and diffusion families are served."""
    if case == "png16-pillow-codec":
        png = _png16(np.full((32, 32, 3), 30000, np.uint16))
        monkeypatch.setattr(imageio, "native_available", lambda: False)
        result = service.restore(png, options={"model": "restore-unet-small"})
        assert result["success"] is True, result.get("error")
        restored = imageio.decode_image(base64.b64decode(result["restoredImage"]))
        assert (restored.height, restored.width) == (32, 32)
        # the 8-bit path saw the image: the same answer as for its 8-bit pixels
        pixels = imageio.decode_image(png).pixels
        assert pixels.dtype == np.uint8 and abs(float(pixels.mean()) - 30000 / 257) < 1.0
        same = service.restore(pixels, options={"model": "restore-unet-small", "format": "png"})
        assert same["restoredImage"] == result["restoredImage"]
        return
    result = service.restore(np.full((32, 32, 3), 128, np.uint8), options={"model": case})
    assert result["success"] is True, result.get("error")
    assert result["metadata"]["model"] == case
    build_restore_program(case, dtype=torch.float32, use_s2d_io=False, use_deblur=True, use_deblock=True)


def test_hdr_switch_off_serves_16_bit_png_on_the_8_bit_path(monkeypatch):
    monkeypatch.setattr(imageio, "native_available", lambda: True)
    cfg = ServingConfig(size_buckets=(64,), max_batch=4, hdr_deblur=False)
    svc = RestoratorService(engine=RestorationEngine(device="cpu", serving_config=cfg), serving_config=cfg,
                            device="cpu")
    assert svc._wants_hdr(_png16(np.full((8, 8, 3), 1, np.uint16))) is False
    cfg_on = ServingConfig(size_buckets=(64,), max_batch=4, hdr_deblur=True)
    assert RestoratorService(engine=svc.engine, serving_config=cfg_on, device="cpu")._wants_hdr(
        _png16(np.full((8, 8, 3), 1, np.uint16))) is True


def test_param_cache_is_shared_by_engine():
    cache = ParamCache(0)
    engine = RestorationEngine(device="cpu", param_cache=cache)
    model = engine.model("restore-unet-small", folded=False)
    assert model is engine.model("restore-unet-small", folded=False)
    assert torch.equal(model.stem.w, cache.get("restore-unet-small")["stem.w"])
    # the served layout's model folds the same cached weights (ServingConfig.fold_w)
    served = engine.model("restore-unet-small")
    assert served is engine.model("restore-unet-small") and served.folded == engine.config.fold_w
    assert torch.equal(served.stem.w, fold_state(cache.get("restore-unet-small"), served.config)["stem.w"])
