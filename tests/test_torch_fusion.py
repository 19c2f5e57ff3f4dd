"""PyTorch port: multi-image fusion and the batch fan-out.

The fusion program for K = 1, 2, 3 with the shipped restore-unet-small
weights in f32 against ``build_fusion_program`` of the JAX package (at
``precision=HIGHEST``): fused u8 within 1 level, scores atol 1e-5. Then the
``restore_fusion`` and ``restore_batch`` result contracts of the restorator
against the reference's, on ``device="cpu"``."""

import base64

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu import imageio as jimageio
from image_restoration_platform_tpu.config import ServingConfig as JServingConfig
from image_restoration_platform_tpu.models import ParamCache as JParamCache
from image_restoration_platform_tpu.serve import RestorationEngine as JEngine
from image_restoration_platform_tpu.serve import RestoratorService as JService
from image_restoration_platform_tpu.serve.programs import build_fusion_program as jbuild
from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.programs import build_fusion_program
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

torch.set_num_threads(2)
FAMILY = "restore-unet-small"
FUSE_META_KEYS = {"engineRequestId", "deviceSeconds", "fetchSeconds", "family", "fusionInputs"}


def _captures(k, size=64):
    """K exposures of one scene: clean, dark, noisy."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    scene = np.stack([0.5 + 0.3 * np.sin(xx / 6.0 + c) * np.cos(yy / 8.0) for c in range(3)], -1)
    variants = [scene, scene * 0.15, scene + rng.normal(0, 0.12, scene.shape)]
    return np.stack([np.clip(np.round(v * 255.0), 0, 255).astype(np.uint8) for v in variants[:k]])


@pytest.fixture(scope="module")
def engine():
    return RestorationEngine(device="cpu", dtype=torch.float32,
                             serving_config=ServingConfig(size_buckets=(64,), max_batch=4))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fusion_program_matches_jax(engine, k):
    canvas = _captures(k)
    valid = np.asarray([[64, 64], [64, 64], [60, 52]][:k], np.int32)
    is_jpeg = np.asarray([0.0, 1.0, 0.0][:k], np.float32)
    fn = jbuild(FAMILY, dtype=jnp.float32, use_folded=False)
    with jax.default_matmul_precision("highest"):
        ref_fused, ref_scores = fn(JParamCache(0).get(FAMILY), jnp.asarray(canvas), jnp.asarray(valid),
                                   jnp.asarray(is_jpeg))
    program = build_fusion_program(FAMILY, dtype=torch.float32)
    model = engine.model(FAMILY, folded=False)  # the reference program's layout
    fused, scores = program(model, torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(is_jpeg))
    assert fused.dtype == torch.uint8 and tuple(fused.shape) == (64, 64, 3) and tuple(scores.shape) == (k, 7)
    assert np.abs(fused.numpy().astype(np.int32) - np.asarray(ref_fused).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=0, atol=1e-5)


def test_fuse_batch_does_not_pad_and_favours_the_clean_input(engine):
    canvas = _captures(3)
    fused, scores, meta = engine.fuse_batch(canvas, np.full((3, 2), 64, np.int32), np.zeros(3, np.float32), FAMILY)
    assert fused.shape == (64, 64, 3) and fused.dtype == np.uint8 and scores.shape == (3, 7)
    assert set(meta) == FUSE_META_KEYS and meta["fusionInputs"] == 3
    assert "batchBucket" not in meta  # K is not padded to a batch bucket
    d_clean = np.abs(fused.astype(int) - canvas[0].astype(int)).mean()
    d_dark = np.abs(fused.astype(int) - canvas[1].astype(int)).mean()
    assert d_clean < d_dark
    # weights are softmax(4 * quality) over the f32 scores: recompute the
    # composite from the three single-image fusions (weight 1 each)
    singles = [engine.fuse_batch(canvas[i : i + 1], np.full((1, 2), 64, np.int32), np.zeros(1, np.float32), FAMILY)[0]
               for i in range(3)]
    logits = 4.0 * (1.0 - scores[:, :3].sum(axis=1) / 3.0)
    w = np.exp(logits - logits.max())
    w /= w.sum()
    composite = sum(wk * s.astype(np.float32) for wk, s in zip(w, singles))
    assert np.abs(composite - fused.astype(np.float32)).max() <= 1.0  # the singles are rounded to u8
    assert w.max() < 0.9  # no capture takes all the weight: the check has signal


@pytest.fixture(scope="module")
def services(engine):
    jcfg = JServingConfig(size_buckets=(64,), max_batch=4)
    jsvc = JService(engine=JEngine(compute_dtype=jnp.float32, serving_config=jcfg), serving_config=jcfg)
    return jsvc, RestoratorService(engine=engine, serving_config=engine.config, device="cpu")


def test_restore_fusion_contract_matches_reference(services):
    jsvc, svc = services
    caps = _captures(3)
    images = [caps[0][:48, :40], caps[1][:48, :40], caps[2][:48, :40]]
    options = {"model": FAMILY}
    with jax.default_matmul_precision("highest"):
        ref = jsvc.restore_fusion([jimageio.encode_png(i) for i in images], "fuse these", options=options)
    got = svc.restore_fusion([imageio.encode_png(i) for i in images], "fuse these", options=options)
    assert ref["success"] is True and got["success"] is True, got.get("error")
    assert set(got) == set(ref)
    assert set(got["metadata"]) == set(ref["metadata"])
    assert set(got["timings"]) == set(ref["timings"])
    meta = got["metadata"]
    assert meta["fusionInputs"] == 3 and meta["sizeBucket"] == 64 and meta["model"] == FAMILY
    assert "fuse these" in got["enhancedPrompt"]
    # scores through the whole request at 1e-4, the restore program's bar (the
    # masked statistics of a letterboxed canvas sum in another order)
    for a, b in zip(meta["perImageAnalysis"], ref["metadata"]["perImageAnalysis"]):
        np.testing.assert_allclose([a[k] for k in sorted(a)], [b[k] for k in sorted(b)], rtol=0, atol=1e-4)
    lows = [p["lowLight"] for p in meta["perImageAnalysis"]]
    assert max(lows) > 0.3 and min(lows) < 0.1  # the dark capture is seen as dark
    np.testing.assert_allclose([got["degradationAnalysis"][k] for k in sorted(got["degradationAnalysis"])],
                               [ref["degradationAnalysis"][k] for k in sorted(ref["degradationAnalysis"])],
                               rtol=0, atol=1e-4)
    a = imageio.decode_image(base64.b64decode(got["restoredImage"])).pixels
    b = jimageio.decode_image(base64.b64decode(ref["restoredImage"])).pixels
    assert a.shape == b.shape == (48, 40, 3)
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).mean() < 0.5


@pytest.mark.parametrize("count", [0, 4])
def test_restore_fusion_rejects_a_wrong_count(services, count):
    _, svc = services
    result = svc.restore_fusion([_captures(1)[0]] * count, options={"model": FAMILY})
    assert result["success"] is False
    assert result["error"]["code"] == "FUSION_FAILED" and "1-3 images" in result["error"]["message"]
    assert result["metadata"]["failureStage"] == "CLASSIFICATION"


def test_single_image_fusion_degenerates(services):
    _, svc = services
    result = svc.restore_fusion([_captures(1)[0]], options={"model": FAMILY})
    assert result["success"] is True and result["metadata"]["fusionInputs"] == 1


def test_restore_batch_fails_only_the_bad_slot(services, monkeypatch):
    jsvc, svc = services
    caps = _captures(3)
    images = [imageio.encode_png(caps[0]), b"not an image", caps[2]]
    seen = []
    restore = svc.restore
    monkeypatch.setattr(svc, "restore", lambda *a: seen.append(a[3]) or restore(*a))
    results = svc.restore_batch(images, "fix", {"userId": "u1"}, {"model": FAMILY})
    assert [r["success"] for r in results] == [True, False, True]
    assert results[1]["error"]["type"] == "INVALID_INPUT"
    assert sorted((o["batchIndex"], o["batchSize"]) for o in seen) == [(0, 3), (1, 3), (2, 3)]
    assert all(o["model"] == FAMILY for o in seen)
    with jax.default_matmul_precision("highest"):
        ref = jsvc.restore_batch([jimageio.encode_png(caps[0]), b"not an image"], options={"model": FAMILY})
    assert [r["success"] for r in ref] == [True, False]
    assert set(results[1]) == set(ref[1]) and set(results[1]["error"]) == set(ref[1]["error"])


def test_restore_batch_honours_concurrency_and_delay(monkeypatch):
    import threading
    import time

    cfg = ServingConfig(size_buckets=(64,), max_batch=4, batch_concurrency=2, batch_delay_ms=20)
    svc = RestoratorService(engine=RestorationEngine(device="cpu", serving_config=cfg), serving_config=cfg,
                            device="cpu")
    active, peak, lock = [0], [0], threading.Lock()

    def fake_restore(image, prompt, context, options):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.2)
        with lock:
            active[0] -= 1
        return {"success": True, "index": options["batchIndex"]}

    monkeypatch.setattr(svc, "restore", fake_restore)
    t0 = time.perf_counter()
    results = svc.restore_batch([b""] * 5)
    assert [r["index"] for r in results] == [0, 1, 2, 3, 4]  # results keep the input order
    assert peak[0] == 2  # never more than batch_concurrency at once
    assert time.perf_counter() - t0 >= 3 * 0.2  # five jobs on two workers


def test_fan_out_settings_read_the_environment(monkeypatch):
    assert (ServingConfig().batch_concurrency, ServingConfig().batch_delay_ms) == (
        JServingConfig().batch_concurrency, JServingConfig().batch_delay_ms)
    monkeypatch.setenv("RESTORATION_BATCH_CONCURRENCY", "0")
    monkeypatch.setenv("RESTORATION_BATCH_DELAY_MS", "7")
    cfg = ServingConfig()
    assert (cfg.batch_concurrency, cfg.batch_delay_ms) == (1, 7)
