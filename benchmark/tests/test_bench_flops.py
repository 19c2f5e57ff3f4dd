"""The benchmark's operation and byte counts against what PyTorch's
FlopCounterMode counts over the plain reference model at small sizes."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference import models

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("tile", [32, 64])
def test_srnet_tile_flops_match_the_counter(tile):
    arch = config("sr-x2")["arch"]
    params = models.load_npz(os.path.join(ROOT, "weights", "sr-x2.npz"), "cpu")
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        models.srnet(params, arch, torch.rand(3, tile, tile, 3))
    assert 3 * flops.srnet_flops_tile(arch, tile) == counter.get_total_flops()


def test_sr_tiles_and_blend_bytes_of_the_2k_canvas():
    arch = config("sr-x2")["arch"]
    assert flops.sr_tiles(arch, 2048) == 81
    assert flops.sr_tiles(arch, 1024) == 25
    # 81 f32 tiles of 512 x 512 x 3 read, a 4096 x 4096 x 3 f32 canvas written
    assert flops.blend_bytes(arch, 2048) == 4 * 3 * (81 * 512 * 512 + 4096 * 4096)
    assert flops.sr_flops(arch, 2048) == 81 * flops.srnet_flops_tile(arch, 256)


def test_image_flops_of_a_tiled_upscale_and_an_unknown_surface():
    cfg = config("sr-x2")
    assert flops.image_flops(cfg, 2048) == flops.sr_flops(cfg["arch"], 2048)
    with pytest.raises(ValueError):
        flops.image_flops({"surface": "restore", "arch": {}}, 256)
