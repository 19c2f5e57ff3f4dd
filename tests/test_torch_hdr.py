"""PyTorch port: the 16-bit PNG HDR pre-pass against the JAX package's.

``deblur_canvas_f32`` (float Wiener deblur with the disk channel on) on the
fixtures of tests/test_hdr_ingest.py: 16-bit defocus canvases (disk radii
1.75-3.25), clean canvases (pass through untouched) and an 8-bit defocus
canvas through the u8 stage (the disk channel never fires there). Bars:
atol 1e-4 on [0, 1] and the same fire decisions. Then ``restore()`` of a
16-bit defocus PNG through both restorators at the 128 bucket (the JAX
engine in f32 at ``precision=HIGHEST``): the pre-pass's u8 pixels within 1
level (the u8 bar of the port's parity tests), the restored JPEG's pixels
within mean 0.5 and max 4 levels, scores within 1e-4. The native codec
decodes the 16-bit samples, as in the reference."""

import base64

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.config import ServingConfig as JServingConfig
from image_restoration_platform_tpu.ops import deblur as JD
from image_restoration_platform_tpu.serve import RestorationEngine as JEngine
from image_restoration_platform_tpu.serve import RestoratorService as JRestorator
from image_restoration_platform_tpu.train.ood import ood_clean
from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.ops import deblur as TD
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService
from test_hdr_ingest import _fft_convolve, write_png16
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

torch.set_num_threads(2)
ATOL = 1e-4


def _defocus_q16(rng, radius):
    clean = ood_clean(rng, 1, 128)[0]
    blurred = np.clip(_fft_convolve(clean, JD.disk_psf(radius)), 0.0, 1.0)
    return (np.round(blurred * 65535.0) / 65535.0).astype(np.float32)


def _cases():
    rng = np.random.default_rng(21)  # tests/test_hdr_ingest.py::test_disk_fires_and_gains_on_float_defocus
    defocus = []
    for _ in range(4):
        clean = ood_clean(rng, 1, 128)[0]
        radius = float(rng.uniform(1.75, 3.25))
        blurred = np.clip(_fft_convolve(clean, JD.disk_psf(radius)), 0.0, 1.0)
        defocus.append((np.round(blurred * 65535.0) / 65535.0).astype(np.float32))
    clean = ood_clean(np.random.default_rng(22), 2, 128).astype(np.float32)  # ::test_clean_float_passthrough
    more = [_defocus_q16(np.random.default_rng(seed), 2.5) for seed in (31, 33, 34)]
    return {"defocus_21": np.stack(defocus), "clean_22": clean, "defocus_2.5": np.stack(more)}


@pytest.mark.parametrize("name", ["defocus_21", "clean_22", "defocus_2.5"])
def test_deblur_canvas_f32_matches_jax(name):
    """One canvas a call, so every case reuses the JAX side's compiled ops."""
    valid, comp = np.asarray([[128, 128]], np.int32), np.zeros((1,), np.float32)
    fired_ref, fired_port = [], []
    for x in _cases()[name][:, None]:
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(JD.deblur_canvas_f32(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(comp)))
        port = TD.deblur_canvas_f32(torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(comp)).numpy()
        fired_ref.append(not np.array_equal(ref, x))
        fired_port.append(not np.array_equal(port, x))
        assert np.abs(port - ref).max() <= ATOL
        if name == "clean_22":
            assert np.array_equal(port, x)
    assert fired_port == fired_ref
    assert any(fired_ref) == (name != "clean_22")


def test_u8_defocus_never_fires_the_disk_channel():
    rng = np.random.default_rng(23)  # tests/test_hdr_ingest.py::test_u8_disk_still_never_fires
    clean = ood_clean(rng, 1, 128)[0]
    u8 = np.round(np.clip(_fft_convolve(clean, JD.disk_psf(2.5)), 0.0, 1.0) * 255).astype(np.uint8)[None]
    valid, comp = np.asarray([[128, 128]], np.int32), np.zeros((1,), np.float32)
    ref = np.asarray(JD.deblur_canvas_batch(jnp.asarray(u8), jnp.asarray(valid), jnp.asarray(comp)))
    port = TD.deblur_canvas_batch(torch.from_numpy(u8), torch.from_numpy(valid), torch.from_numpy(comp)).numpy()
    assert np.array_equal(ref, u8) and np.array_equal(port, u8)


@pytest.fixture(scope="module")
def restorators():
    cfg, jcfg = ServingConfig(size_buckets=(128,), max_batch=2), JServingConfig(size_buckets=(128,), max_batch=2)
    port = RestoratorService(engine=RestorationEngine(device="cpu", serving_config=cfg), serving_config=cfg,
                             device="cpu")
    ref = JRestorator(engine=JEngine(compute_dtype=jnp.float32, serving_config=jcfg), serving_config=jcfg)
    return ref, port


def test_restore_16_bit_png_matches_jax(restorators):
    if not imageio.native_available():
        pytest.skip("the 16-bit decode needs the native codec, as in the reference")
    ref_svc, port_svc = restorators
    png = write_png16(np.round(_defocus_q16(np.random.default_rng(31), 2.5) * 65535.0).astype(np.uint16))
    assert port_svc._wants_hdr(png) and ref_svc._wants_hdr(png)

    with jax.default_matmul_precision("highest"):
        ref_px, ref_fmt = ref_svc._hdr_prepass(png)
        ref = ref_svc.restore(png, options={"model": "restore-unet-small"})
    port_px, port_fmt = port_svc._hdr_prepass(png)
    port = port_svc.restore(png, options={"model": "restore-unet-small"})

    assert port_fmt == ref_fmt == "png" and port_px.dtype == np.uint8 and port_px.shape == (128, 128, 3)
    assert np.abs(port_px.astype(np.int32) - ref_px).max() <= 1
    # the pre-pass changed the image: it is not the 8-bit decode
    assert np.abs(port_px.astype(np.int32) - imageio.decode_image(png).pixels).mean() > 1.0

    assert port["success"] and ref["success"], (port.get("error"), ref.get("error"))
    for k, v in ref["degradationAnalysis"].items():
        assert abs(port["degradationAnalysis"][k] - v) <= ATOL, k
    assert port["enhancedPrompt"] == ref["enhancedPrompt"]
    a, b = (imageio.decode_image(base64.b64decode(r["restoredImage"])).pixels.astype(np.int32) for r in (ref, port))
    diff = np.abs(a - b)
    assert diff.mean() <= 0.5 and diff.max() <= 4, (diff.mean(), diff.max())


def test_prepass_skips_what_it_cannot_analyse(restorators):
    """Under 128 px (the analysis size) or over the largest bucket, the
    pre-pass steps aside and the 8-bit decode serves the upload."""
    if not imageio.native_available():
        pytest.skip("the 16-bit decode needs the native codec, as in the reference")
    _, svc = restorators
    for hw in ((96, 200), (130, 140)):
        png = write_png16(np.full((*hw, 3), 20000, np.uint16))
        assert svc._wants_hdr(png) and svc._hdr_prepass(png) == (None, None)
    with pytest.raises(ValueError):
        imageio.decode_image_u16(imageio.encode_jpeg(np.zeros((8, 8, 3), np.uint8)))
