"""The add-norm kernel's roofline reader in swinir-m-x2's cell: its minimal
bytes of a 2048 canvas, and a reading only where the program launched the
kernel twice a Swin layer and chunk of tiles."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from benchmark import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "kernels.swin_add_norm_roofline"
# one bf16 tensor of the residual stream over a 2048 canvas: 81 tiles of
# 256 x 256 tokens of 180 channels
STREAM = 81 * 256 * 256 * 180 * 2


def config() -> dict:
    with open(os.path.join(HERE, "configs", "swinir-m-x2.json")) as f:
        return json.load(f)


def _module():
    return spec._load_module("metric", METRIC, os.path.join(HERE, "metrics", f"{METRIC}.py"))


def test_bytes_of_a_2048_canvas():
    """Six residual blocks of six layers: the first layer's to_windows reads
    x and writes the copy (2 tensors), the other five read and write 4; every
    from_windows 4; the affine, 2 x 180 bf16, on each of the 72 launches."""
    per_block = (2 + 5 * 4 + 6 * 4) * STREAM + 12 * 2 * 180 * 2
    assert _module().add_norm_bytes(config()["arch"], 2048) == 6 * per_block


class _Step:
    canvas = 2048

    def device_ns(self, match=None):
        return 50_000_000 if match == "swin_add_norm_kernel" else 1_000_000_000


def _run(launches: float, calls: float = 3.0):
    counters = {"sr_tiled_calls.2048": calls}
    if launches:
        counters["kernels.launches.swin_add_norm"] = launches
    return SimpleNamespace(config=config(), cell=SimpleNamespace(reference=None), counters=counters,
                           trace=SimpleNamespace(steps=[_Step(), _Step()]), peaks={"hbm_bytes_per_s": 3.35e12})


def test_the_reader_reads_a_whole_program():
    read = spec.load_reader(METRIC)
    want = 100.0 * 2 * _module().add_norm_bytes(config()["arch"], 2048) / 3.35e12 / 0.1
    assert abs(read(_run(3 * 792)) - want) < 1e-9
    assert abs(_module().expected_launches(_run(0)) - 3 * 2 * 36 * 11) == 0


def test_the_reader_reads_nothing_where_launches_are_short_or_missing():
    read = spec.load_reader(METRIC)
    assert read(_run(3 * 792 - 72)) is None  # a chunk's layers left out
    assert read(_run(3 * 792 - 1)) is None
    assert read(_run(0)) is None  # a program without the kernel or its counter


def test_its_entry_reads_in_the_swinir_cell_alone():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    assert entry == {"name": METRIC, "unit": "%", "better": "higher", "source": "device_trace", "layer": "kernels",
                     "moves": "images_per_s", "workloads": ["swinir-m-x2.upscale-2k"]}
    assert bench["per_layer"][-1] is entry
