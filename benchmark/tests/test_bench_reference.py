"""The plain reference against the port on the CPU at small sizes, both in
float32: the tiled SR alone, and the upscale through submit_job."""

from __future__ import annotations

import base64
import io
import json
import os

import numpy as np
import torch
from PIL import Image

from benchmark import spec
from benchmark.reference import models, pipeline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def photo(h, w, seed, quality):
    """A textured JPEG upload."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 60 * np.sin(xx / (13.0 + 4 * c)) * np.cos(yy / 19.0) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_upscale_matches_the_port_through_submit_job(pillow_codec):
    """A 600 px upload on the 1024 tiled canvas (the 2048 canvas's path at a
    CPU size): the served JPEG against the reference's, both decoded alike."""
    from benchmark import drive
    from image_restoration_platform_tpu_torch.api.submit import submit_job

    cfg = config("sr-x2")
    params = models.load_npz(os.path.join(ROOT, "weights", "sr-x2.npz"), "cpu")
    ctx = drive.build_service(cfg, "cpu")
    try:
        ctx.user_store.grant("u", 10)
        upload = photo(450, 600, 4, 90)
        status, body, _ = submit_job(ctx, {"id": "u"}, [("a.jpg", upload)], options={"model": "sr-x2"}, sync=True)
        assert status == 200
        served = pipeline.decode(base64.b64decode(body["result"]["restoredImage"]))
        with torch.inference_mode():
            ref = pipeline.upscale(upload, cfg, spec.load_reference(cfg["reference"]).network, params, "cpu")
        assert served.shape == ref.shape == (900, 1200, 3)
        d = np.abs(served.astype(int) - ref.astype(int))
        assert d.mean() < 0.05 and d.max() <= 2
    finally:
        ctx.shutdown()


def test_tiled_sr_matches_the_port():
    from image_restoration_platform_tpu_torch.serve.engine import RestorationEngine

    cfg = config("sr-x2")
    arch = cfg["arch"]
    params = models.load_npz(os.path.join(ROOT, "weights", "sr-x2.npz"), "cpu")
    canvas = pipeline.decode(photo(480, 480, 3, 90))
    served, _ = RestorationEngine(device="cpu").sr_tiled(canvas, "sr-x2", tile=arch["tile"],
                                                         overlap=arch["overlap"], tile_batch=arch["tile_batch"])
    with torch.inference_mode():
        ref = models.sr_tiled(spec.load_reference(cfg["reference"]).network, params, arch, torch.from_numpy(canvas))
    ref = torch.round(torch.clamp(ref, 0, 255)).to(torch.uint8).numpy()
    assert served.shape == ref.shape == (960, 960, 3)
    assert np.abs(served.astype(int) - ref.astype(int)).max() <= 1


def test_tile_grid_and_window():
    assert models.tile_starts(2048, 256, 224) == [0, 224, 448, 672, 896, 1120, 1344, 1568, 1792]
    w = models.hann_window(512)
    assert w.shape == (512, 512) and w.min() > 0 and abs(w.max() - 1.0) < 1e-4
