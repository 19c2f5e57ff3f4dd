"""The upload generator: the same seed gives the same bytes, every seed the
same sizes, and every upload lands on its cell's canvas; the moderation the
benchmark configures clears every upload, whatever its bytes."""

from __future__ import annotations

import io
import json
import os

import pytest
from PIL import Image

from benchmark.traffic import generator

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")
# a mix with every degradation the generator draws, at a CPU size
DEGRADED = {"name": "degraded", "pool": 6, "longest": [96, 160], "aspects": [[4, 3], [3, 2]], "portrait_share": 0.5,
            "degradations": [{"kind": "motion", "share": 1, "size": [5, 11], "noise": [2, 4], "quality": [85, 95]},
                             {"kind": "defocus", "share": 1, "size": [5, 11], "quality": [85, 95]},
                             {"kind": "fade", "share": 1, "fade": [0.2, 0.5], "cast": [8, 8, 8], "noise": [5, 20],
                              "quality": [85, 95]}],
            "loop": {"kind": "closed", "clients": 2}}


def mix(name: str) -> dict:
    if name == "degraded":
        return dict(DEGRADED)
    with open(os.path.join(TRAFFIC, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["upscale-2k", "degraded"])
def test_same_seed_same_bytes(name):
    small = dict(mix(name), pool=3)
    a = generator.make_pool(small, 2**31 + 12345, workers=2)
    b = generator.make_pool(small, 2**31 + 12345, workers=2)
    c = generator.make_pool(small, 2**31 + 54321, workers=2)
    assert [u.data for u in a] == [u.data for u in b]
    assert [u.data for u in a] != [u.data for u in c]


def test_every_upload_lands_on_the_2048_canvas():
    """The longest side of every upscale lies in (1024, 2048]: the tiled SR
    path on the 2048 canvas."""
    for seed in (1, 2**31 + 7):
        for spec in generator.draw_specs(mix("upscale-2k"), seed):
            assert 1024 < max(spec["height"], spec["width"]) <= 2048


@pytest.mark.parametrize("name", ["upscale-2k", "degraded"])
def test_every_seed_draws_the_same_work(name):
    """Sizes and degradation parameters are one set per mix, dealt in each
    seed's order."""
    def work(seed):
        return sorted((s["height"] * s["width"], json.dumps(s["degradation"], sort_keys=True))
                      for s in generator.draw_specs(mix(name), seed))
    assert work(3) == work(2**31 + 99)


def test_rendered_upload_matches_its_spec():
    m = mix("degraded")
    specs = generator.draw_specs(m, 11)
    assert {s["degradation"]["kind"] for s in specs} == {"motion", "defocus", "fade"}
    for spec, upload in zip(specs, generator.make_pool(m, 11, workers=2)):
        with Image.open(io.BytesIO(upload.data)) as im:
            assert (im.height, im.width) == (spec["height"], spec["width"])
            assert im.format == "JPEG"


def test_moderation_clears_every_upload_length():
    """The moderation the benchmark builds passes an upload of any length in
    bytes: which jobs succeed does not hang on the program's stand-in for an
    unconfigured vision service."""
    from benchmark import drive
    from image_restoration_platform_tpu_torch.serve.moderation import ModerationService

    service = ModerationService(vision_client=drive.vision_backend)
    assert all(service.moderate(b"\xff" * n)["allowed"] for n in range(1000, 1100))


def test_client_orders_walk_the_pool():
    orders = generator.client_orders(16, 8, 40, 5)
    assert len(orders) == 8 and all(len(o) == 40 for o in orders)
    assert all(sorted(o[:16]) == list(range(16)) for o in orders)
