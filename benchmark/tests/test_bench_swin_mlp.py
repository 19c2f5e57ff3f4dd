"""The MLP kernel's roofline reader in swinir-m-x2's cell: its operations,
fc1 and fc2 of the reference's ``tile_flops``, and its bytes over a 2048
canvas, and a reading only where the program launched the kernel once a
Swin layer and chunk of tiles."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from benchmark import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "kernels.swin_mlp_roofline"
TOKENS = 81 * 256 * 256  # a 2048 canvas: 81 tiles of 256 x 256 tokens
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def config() -> dict:
    with open(os.path.join(HERE, "configs", "swinir-m-x2.json")) as f:
        return json.load(f)


def _module():
    return spec._load_module("metric", METRIC, os.path.join(HERE, "metrics", f"{METRIC}.py"))


def test_operations_are_the_mlp_share_of_the_reference_count():
    """``tile_flops`` less what it counts with an MLP of width 0 is fc1 and
    fc2 of all 36 layers of a tile; 81 tiles make the canvas."""
    ref = spec.load_reference("swinir")
    arch = config()["arch"]
    mlp_of_a_tile = ref.tile_flops(arch, 256) - ref.tile_flops(dict(arch, mlp_ratio=0.0), 256)
    assert _module().mlp_flops(arch, 2048) == 81 * mlp_of_a_tile == 36 * 4 * TOKENS * 180 * 360


def test_bytes_of_a_2048_canvas():
    """Every layer reads the tokens and writes m (2 tensors of 180 bf16 a
    token) and, on each of its 11 launches, both weights and biases."""
    weights = (2 * 180 * 360 + 360 + 180) * 2
    assert _module().mlp_bytes(config()["arch"], 2048) == 36 * (2 * TOKENS * 180 * 2 + 11 * weights)


class _Step:
    canvas = 2048

    def device_ns(self, match=None):
        return 150_000_000 if match == "swin_mlp_kernel" else 1_000_000_000


def _run(launches: float, calls: float = 3.0):
    counters = {"sr_tiled_calls.2048": calls}
    if launches:
        counters["kernels.launches.swin_mlp"] = launches
    return SimpleNamespace(config=config(), cell=SimpleNamespace(reference=None), counters=counters,
                           trace=SimpleNamespace(steps=[_Step(), _Step()]), peaks=PEAKS)


def test_the_reader_reads_a_whole_program_at_its_larger_bound():
    read = spec.load_reader(METRIC)
    m, arch = _module(), config()["arch"]
    least = max(m.mlp_flops(arch, 2048) / PEAKS["bf16_flops"], m.mlp_bytes(arch, 2048) / PEAKS["hbm_bytes_per_s"])
    assert least == m.mlp_flops(arch, 2048) / PEAKS["bf16_flops"]  # operations bound it
    assert abs(read(_run(3 * 396)) - 100.0 * 2 * least / 0.3) < 1e-9
    assert m.expected_launches(_run(0)) == 3 * 36 * 11


def test_the_reader_reads_nothing_where_launches_are_wrong_or_missing():
    read = spec.load_reader(METRIC)
    assert read(_run(3 * 396 - 36)) is None  # a chunk's layers left out
    assert read(_run(3 * 396 + 1)) is None
    assert read(_run(0)) is None  # a program without the kernel or its counter


def test_its_entry_reads_in_the_swinir_cell_alone():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    assert entry == {"name": METRIC, "unit": "%", "better": "higher", "source": "device_trace", "layer": "kernels",
                     "moves": "images_per_s", "workloads": ["swinir-m-x2.upscale-2k"]}
    assert bench["per_layer"][-1] is entry
