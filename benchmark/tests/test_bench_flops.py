"""The benchmark's tile grid and byte counts, and the operation count of a
tiled upscale as the configuration's reference module counts a tile (that
count against PyTorch's FlopCounterMode: test_bench_architectures.py)."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import flops, spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_sr_tiles_and_blend_bytes_of_the_2k_canvas():
    arch = config("sr-x2")["arch"]
    assert flops.sr_tiles(arch, 2048) == 81
    assert flops.sr_tiles(arch, 1024) == 25
    # 81 f32 tiles of 512 x 512 x 3 read, a 4096 x 4096 x 3 f32 canvas written
    assert flops.blend_bytes(arch, 2048) == 4 * 3 * (81 * 512 * 512 + 4096 * 4096)
    assert flops.image_flops(config("sr-x2"), 2048) == 81 * spec.load_reference("srnet").tile_flops(arch, 256)


def test_image_flops_of_a_tiled_upscale_and_an_unknown_surface():
    cfg = config("sr-x2")
    reference = spec.load_reference(cfg["reference"])
    assert flops.image_flops(cfg, 2048) == flops.sr_tiles(cfg["arch"], 2048) * reference.tile_flops(cfg["arch"], 256)
    assert flops.image_flops(cfg, 2048, reference) == flops.image_flops(cfg, 2048)
    with pytest.raises(ValueError):
        flops.image_flops({"surface": "restore", "arch": {}}, 256)
