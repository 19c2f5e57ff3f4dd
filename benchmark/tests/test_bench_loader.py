"""A cell, a traffic mix and a metric are found by name: a scratch copy of
the benchmark with one added traffic file, one added metric file and one
added workload entry loads them, with no code edited."""

from __future__ import annotations

import json
import os

from benchmark import spec


def test_real_cells_load():
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == w["chips"] and cell.config["name"] == w["config"]
        assert callable(cell.reference.network) and callable(cell.reference.tile_flops)
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert all(callable(m.read) for m in cell.end_to_end + cell.per_layer)


def test_added_files_are_found(scratch_root):
    root = scratch_root.root
    mix = json.load(open(os.path.join(root, "benchmark", "traffic", "upscale-2k.json")))
    mix.update(name="upscale-2k-wide", aspects=[[16, 9]])
    name = scratch_root("sr-x2.upscale-2k-wide", "sr-x2", mix)
    with open(os.path.join(root, "benchmark", "metrics", "jobs_per_client.py"), "w") as f:
        f.write('"""jobs_per_client: jobs each client sent in the window."""\n\n\n'
                "def read(run):\n    return len(run.jobs) / run.cell.mix['loop']['clients']\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "jobs_per_client", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "submission", "moves": "images_per_s",
                               "workloads": [name]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = spec.load_cell(name, root)
    assert cell.mix["aspects"] == [[16, 9]]
    reader = {m.name: m for m in cell.per_layer}["jobs_per_client"]

    class Run:
        jobs = [object()] * 24

    Run.cell = cell
    assert reader.read(Run()) == 3.0
    # the real cell in the same scratch copy does not report the new metric
    assert "jobs_per_client" not in {m.name for m in spec.load_cell("sr-x2.upscale-2k", root).per_layer}


def test_peaks_by_card_name():
    assert spec.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
