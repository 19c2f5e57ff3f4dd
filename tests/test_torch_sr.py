"""PyTorch port: the super-resolution serving surfaces against the JAX engine.

``engine.sr_batch`` and ``engine.sr_tiled`` (64 canvas, tile 32, overlap 8,
tile batch 4, RGB and yuv420, as tests/test_sr_fusion.py drives the
reference) with the shipped sr-x2 weights in f32, against the JAX engine
built with ``fold_w_sr=False``; the port's engine serves SRNet in the layout
its ``ServingConfig`` default gives (``fold_w_sr``, models/folded.py: the
same function up to the order of the sums). Bar on u8 outputs: at most 1 level apart, on under 1 % of
the pixels (f32 round-off moves a value across a rounding boundary now and
then; measured 1 level on 0.25 % of the pixels). Then the restorator's SR result
contract against the reference's, on ``device="cpu"``."""

import base64

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu import imageio as jimageio
from image_restoration_platform_tpu.config import ServingConfig as JServingConfig
from image_restoration_platform_tpu.serve import RestorationEngine as JEngine
from image_restoration_platform_tpu.serve import RestoratorService as JService
from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.obs.metrics import get_counters
from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.programs import build_restore_program, build_sr_tiled_program
from image_restoration_platform_tpu_torch.serve.programs import sr as sr_programs
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

torch.set_num_threads(2)

SR_META_KEYS = {"engineRequestId", "deviceSeconds", "fetchSeconds", "family"}
TILED = dict(tile=32, overlap=8, tile_batch=4)


def _photo(seed, hw):
    """Smooth colour field with texture and an edge: the limiter sees flat,
    textured and edge content."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.3 * np.sin(xx / 9.0 + c) * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    img[:, w // 2 :] += 0.15
    img += rng.normal(0, 0.04, img.shape) * (yy[..., None] > h / 2)
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def _assert_u8_close(got, ref, what):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape and got.dtype == np.uint8, what
    assert diff.max() <= 1, f"{what}: max {diff.max()} levels"
    assert (diff > 0).mean() < 0.01, f"{what}: {(diff > 0).mean():.4f} of the pixels differ"


@pytest.fixture(scope="module")
def engines():
    jcfg = JServingConfig(size_buckets=(64,), max_batch=4, fold_w_sr=False)
    cfg = ServingConfig(size_buckets=(64,), max_batch=4)
    return (JEngine(compute_dtype=jnp.float32, serving_config=jcfg),
            RestorationEngine(device="cpu", dtype=torch.float32, serving_config=cfg))


@pytest.mark.parametrize("family,hw", [("sr-x2", (64, 64)), ("sr-x4", (32, 48))])
def test_sr_batch_matches_jax_engine(engines, family, hw):
    jengine, engine = engines
    imgs = np.stack([_photo(1, hw), _photo(2, hw)])
    with jax.default_matmul_precision("highest"):
        ref, _ = jengine.sr_batch(imgs, family)
    got, meta = engine.sr_batch(imgs, family)
    scale = int(family[-1])
    assert got.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    _assert_u8_close(got, np.asarray(ref), family)
    assert set(meta) == SR_META_KEYS and meta["family"] == family and meta["deviceSeconds"] > 0


@pytest.fixture(scope="module")
def tiled_case(engines):
    """One 64 canvas through the reference's tiled program, both outputs."""
    jengine, _ = engines
    canvas = _photo(3, (64, 64))
    with jax.default_matmul_precision("highest"):
        rgb, _ = jengine.sr_tiled(canvas, "sr-x2", **TILED)
        planes, _ = jengine.sr_tiled(canvas, "sr-x2", output="yuv420", **TILED)
    return canvas, np.asarray(rgb), [np.asarray(p) for p in planes]


def test_sr_tiled_rgb_matches_jax_engine(engines, tiled_case):
    canvas, ref_rgb, _ = tiled_case
    calls = get_counters().snapshot().get("sr_tiled_calls.64", 0)
    launches = blend_kernel.launches
    got, meta = engines[1].sr_tiled(canvas, "sr-x2", **TILED)
    assert got.shape == (128, 128, 3)
    _assert_u8_close(got, ref_rgb, "sr_tiled rgb")
    assert set(meta) == SR_META_KEYS | {"tile", "overlap"} and (meta["tile"], meta["overlap"]) == (32, 8)
    assert get_counters().snapshot()["sr_tiled_calls.64"] == calls + 1
    assert blend_kernel.launches == launches  # CPU tensors take the plain fold


def test_sr_tiled_yuv420_matches_jax_engine(engines, tiled_case):
    canvas, _, ref_planes = tiled_case
    planes, _ = engines[1].sr_tiled(canvas, "sr-x2", output="yuv420", **TILED)
    assert [p.shape for p in planes] == [(128, 128), (64, 64), (64, 64)]
    for got, ref, name in zip(planes, ref_planes, ("Y", "Cb", "Cr")):
        _assert_u8_close(got, ref, f"sr_tiled {name}")


def test_tiled_differs_from_direct_only_near_seams(engines, tiled_case):
    """The limiter runs per tile, as in the reference, so the tiled output
    is not the direct one; both stay close on this content."""
    canvas, ref_rgb, _ = tiled_case
    direct, _ = engines[1].sr_batch(canvas[None], "sr-x2")
    diff = np.abs(direct[0].astype(np.int32) - ref_rgb.astype(np.int32))
    assert 0 < diff.max() and diff.mean() < 1.0


def test_tiled_matches_direct_for_zero_init(monkeypatch, tmp_path):
    """Zero-init SRNet is the nearest upsample (the limiter turns it into
    the tent upsample per tile), so tiled and direct agree to 1 level: the
    blend introduces no seam. As tests/test_sr_fusion.py holds the reference."""
    monkeypatch.setenv("IRP_WEIGHTS_DIR", str(tmp_path))
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(64,), max_batch=4))
    canvas = np.full((64, 64, 3), (120, 160, 200), np.uint8)
    canvas[:, :32] //= 2
    tiled, _ = engine.sr_tiled(canvas, "sr-x2", tile=32, overlap=16, tile_batch=4)
    direct, _ = engine.sr_batch(canvas[None], "sr-x2")
    assert np.abs(tiled.astype(int) - direct[0].astype(int)).max() <= 1


def test_sr_programs_keep_the_limiter_output_in_f32():
    """bf16 engine: the limiter returns f32 and the program scales that by
    255 with no cast back to bf16 in between (bf16 holds about one level per
    step above mid-gray and would re-quantize the bounded residual)."""
    cfg = ServingConfig(size_buckets=(64,), max_batch=4)
    engine = RestorationEngine(device="cpu", dtype=torch.bfloat16, serving_config=cfg)
    imgs = _photo(6, (64, 64))[None]
    model = engine.model("sr-x2")
    with torch.inference_mode():
        out = model(torch.from_numpy(imgs).to(torch.bfloat16) / 255.0)
    assert out.dtype == torch.float32 and model.stem.w.dtype == torch.bfloat16
    expected = torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8).numpy()
    got, _ = engine.sr_batch(imgs, "sr-x2")
    np.testing.assert_array_equal(got, expected)
    through_bf16 = torch.clamp(torch.round(out.to(torch.bfloat16).float() * 255.0), 0, 255).to(torch.uint8).numpy()
    assert (through_bf16 != expected).mean() > 0.05  # the cast the program must not make


def test_program_builders_refuse_unknown_outputs():
    with pytest.raises(ValueError):
        build_sr_tiled_program("sr-x2", dtype=torch.float32, tile=32, overlap=8, tile_batch=4, output="bgr")
    with pytest.raises(ValueError):
        build_restore_program("sr-x2", dtype=torch.float32, use_s2d_io=False, use_deblur=True, use_deblock=True,
                              egress="bgr")


# ------------------------------------------------------------- restorator


@pytest.fixture(scope="module")
def services(engines):
    jengine, engine = engines
    return (JService(engine=jengine, serving_config=jengine.config),
            RestoratorService(engine=engine, serving_config=engine.config, device="cpu"))


def test_restorator_sr_contract_matches_reference(services):
    jsvc, svc = services
    img = _photo(4, (48, 40))  # letterboxed into the 64 bucket, resized on the way out
    with jax.default_matmul_precision("highest"):
        ref = jsvc.restore(jimageio.encode_png(img), options={"model": "sr-x2"})
    got = svc.restore(imageio.encode_png(img), options={"model": "sr-x2"})
    assert ref["success"] is True and got["success"] is True, got.get("error")
    assert set(got) == set(ref)
    assert set(got["metadata"]) == set(ref["metadata"])
    for key in ("model", "scaleFactor", "outputSize", "sizeBucket", "classificationIssues", "billedTokens"):
        assert got["metadata"][key] == ref["metadata"][key], key
    assert got["metadata"]["scaleFactor"] == 2 and got["metadata"]["outputSize"] == [96, 80]
    assert got["degradationAnalysis"] == {} and got["enhancedPrompt"] == ""
    assert set(got["timings"]) == set(ref["timings"]) and got["timings"]["classify_ms"] == 0.0
    a = imageio.decode_image(base64.b64decode(got["restoredImage"])).pixels
    b = jimageio.decode_image(base64.b64decode(ref["restoredImage"])).pixels
    assert a.shape == b.shape == (96, 80, 3)
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).mean() < 0.5  # JPEGs of outputs within 1 level


@pytest.mark.parametrize("native", [True, False], ids=["native-codec", "pillow-codec"])
def test_restorator_tiles_above_the_threshold(services, monkeypatch, native):
    """Above ``DIRECT_MAX`` the request goes through ``sr_tiled``: plane
    egress where the native codec takes planes and no host resize follows,
    RGB otherwise."""
    _, svc = services
    if native and not imageio.native_available():
        pytest.skip("the native codec did not build here")
    if not native:
        monkeypatch.setattr(imageio, "native_available", lambda: False)
    monkeypatch.setattr(sr_programs, "DIRECT_MAX", 32)
    outputs = []
    sr_tiled = svc.engine.sr_tiled
    monkeypatch.setattr(svc.engine, "sr_tiled",
                        lambda *a, **k: outputs.append(k.get("output", "rgb")) or sr_tiled(*a, **k))
    result = svc.restore(_photo(5, (64, 64)), options={"model": "sr-x2"})
    assert result["success"] is True, result.get("error")
    assert outputs == ["yuv420" if native else "rgb"]
    restored = imageio.decode_image(base64.b64decode(result["restoredImage"]))
    assert (restored.height, restored.width) == (128, 128)
    assert result["metadata"]["sizeBucket"] == 64


def test_canonicalize_sr_adds_the_2048_bucket(services):
    jsvc, svc = services
    for hw in ((48, 40), (64, 64), (100, 70), (1500, 1100)):
        img = np.zeros((*hw, 3), np.uint8)
        canvas, valid, bucket = svc._canonicalize_sr(img)
        rcanvas, rvalid, rbucket = jsvc._canonicalize_sr(img)
        assert (canvas.shape, valid, bucket) == (rcanvas.shape, rvalid, rbucket)
    assert svc._canonicalize_sr(np.zeros((1500, 1100, 3), np.uint8))[2] == 2048
