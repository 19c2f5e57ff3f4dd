"""The swinir-m-x2 configuration's counts and its roofline reader: the
operations of a 2048 canvas, the window attention's minimal bytes, and a
reading only where the program launched the kernel once a Swin layer and
chunk of tiles."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from benchmark import flops, spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "kernels.window_attention_roofline"


def config() -> dict:
    with open(os.path.join(HERE, "configs", "swinir-m-x2.json")) as f:
        return json.load(f)


def test_operations_of_a_2048_canvas():
    cfg = config()
    assert spec.load_reference("swinir").tile_flops(cfg["arch"], 256) == 1_633_779_449_856
    assert flops.image_flops(cfg, 2048) == 132_336_135_438_336


def test_attention_bytes_of_a_2048_canvas():
    arch = config()["arch"]
    table = 36 * 225 * 6 * 4
    assert spec.load_reference("swinir").attention_bytes(arch, 2048) == 81 * 1024 * 36 * 4 * 6 * 64 * 30 * 2 + table


class _Step:
    canvas = 2048

    def device_ns(self, match=None):
        return 100_000_000 if match == "window_attention_kernel" else 1_000_000_000


def _run(launches: float, calls: float = 3.0):
    counters = {"sr_tiled_calls.2048": calls}
    if launches:
        counters["kernels.launches.window_attention"] = launches
    return SimpleNamespace(config=config(), cell=SimpleNamespace(reference=spec.load_reference("swinir")),
                           counters=counters, trace=SimpleNamespace(steps=[_Step(), _Step()]),
                           peaks={"hbm_bytes_per_s": 3.35e12})


def test_the_reader_reads_a_whole_program():
    read = spec.load_reader(METRIC)
    arch = config()["arch"]
    want = 100.0 * 2 * spec.load_reference("swinir").attention_bytes(arch, 2048) / 3.35e12 / 0.2
    assert abs(read(_run(3 * 396)) - want) < 1e-9


def test_the_reader_reads_nothing_where_launches_are_short_or_missing():
    read = spec.load_reader(METRIC)
    assert read(_run(3 * 396 - 36)) is None  # a chunk's layers left out
    assert read(_run(3 * 396 + 11)) is None
    assert read(_run(0)) is None  # a program without the counter


def test_its_mix_is_sr_x2s_uploads_sent_to_swinir():
    """The mix names the model its jobs ask for, so the cell has its own:
    upscale-2k's generator parameters, every one, with the model swapped."""
    def mix(name):
        with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
            return json.load(f)

    ours, theirs = mix("upscale-2k-swinir"), mix("upscale-2k")
    assert ours["options"] == {"model": "swinir-m-x2"} == {"model": config()["family"]}
    assert {k: v for k, v in ours.items() if k not in ("name", "options")} == \
        {k: v for k, v in theirs.items() if k not in ("name", "options")}
    assert spec.load_cell("swinir-m-x2.upscale-2k").mix["options"]["model"] == "swinir-m-x2"
